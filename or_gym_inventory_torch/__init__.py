"""or_gym_inventory_torch: the PyTorch and CUDA port of or_gym_inventory_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs. It imports
``torch`` and ``numpy`` and never ``jax`` or the JAX package, which stays the
reference that every port module is tested against (tests/test_torch_*.py).

Ported: all three inventory families, batched over a leading env dimension
(NetInvMgmt with its topology compiler, InvManagement, Newsvendor), the
vecenv rollouts, and whole-episode returns under the uniform-random policy,
a learned MLP policy and a learned LSTM policy. The learners train through
the trajectory kernels: PPO and recurrent PPO (the LSTM actor-critic), and
the off-policy SAC, TD3 and DDPG with ``collect="kernel"``. Every Pallas
kernel of the JAX package and its three off-policy trajectory heads is a
hand-written CUDA kernel, K1-K29, in seven sources under csrc/ (one per
family and path: net_episode, net_policy, im_episode, im_policy, im_lstm,
nv_episode, nv_policy), built with nvcc at first use and wrapped in
ops/net_step.py and ops/episode_kernels.py; PERF.md's kernel table lists
each with its time on an H100. ROADMAP.md lists what is still open.

Entry points take ``device=None``, meaning the GPU, and raise without one;
pass ``device="cpu"`` for the plain PyTorch path.

Package layout:
    core/    spaces, the TimeStep struct, NumPy-parity RNG, device
             resolution, env_config handling
    ops/     CDF tables, Philox, the kernels' wrappers, plain versions and
             build, the folded actors of the policy kernels
    envs/    net_inv_management (+ topology), inv_management, newsvendor
    agents/  the MLP and LSTM actor-critics, PPO and recurrent PPO on the
             kernel path, the off-policy learners, the A2C config
    vector/  batched rollouts, random- and learned-policy episode returns
    utils/   carrying parameters and weights across from the JAX package
             (NumPy in, no JAX imported), CUDA-event timing
    csrc/    the CUDA sources
"""

__version__ = "0.1.0"

from or_gym_inventory_torch.core import parity, spaces, struct  # noqa: F401
from or_gym_inventory_torch.envs import net_inv_management, topology  # noqa: F401
from or_gym_inventory_torch.envs.base import Environment  # noqa: F401
from or_gym_inventory_torch.ops import distributions, net_step, rng  # noqa: F401
from or_gym_inventory_torch.vector.fast_episodes import (  # noqa: F401
    policy_episode_returns, random_episode_returns)
from or_gym_inventory_torch.vector.vecenv import (  # noqa: F401
    Trajectory, auto_reset, batch_reset, batch_step, evaluate_episodes, rollout)
