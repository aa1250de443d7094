"""or_gym_inventory_torch: the PyTorch and CUDA port of or_gym_inventory_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs. It imports
``torch`` and ``numpy`` and never ``jax`` or the JAX package, which stays the
reference that every port module is tested against (tests/test_torch_*.py).

Ported so far: the NetInvMgmt env batched over a leading env dimension, the
vecenv rollouts, whole-episode returns under the uniform-random policy and
under a learned MLP policy, and PPO trained through the trajectory kernel,
through six hand-written CUDA kernels (ops/net_step.py, csrc/). ROADMAP.md
lists what is still to port.

Entry points take ``device=None``, meaning the GPU, and raise without one;
pass ``device="cpu"`` for the plain PyTorch path.

Package layout:
    core/    spaces, the TimeStep struct, NumPy-parity RNG, device resolution
    ops/     CDF tables, Philox, the episode kernels' wrappers and build, the
             folded actor of the policy kernels
    envs/    net_inv_management (+ topology compiler)
    agents/  the MLP actor-critic, PPO on the kernel path, the A2C config
    vector/  batched rollouts, random- and learned-policy episode returns
    utils/   JAX interop for tests, CUDA-event timing
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
