"""The InvManagement plain versions past the CUDA kernels' struct caps
(``IM_MAX_M1`` 8 stages, ``IM_MAX_LT`` 32 periods of lead time), against
the JAX package, which bakes every shape in at trace time and so has no
such cap.

Each case runs one plain version on the CPU past one cap and hands its
streams to JAX: the Pallas stream-in kernel ``episode_returns_im`` in
interpret mode and the XLA env chain ``_replay_chain`` of
tests/test_kernel_rollout.py. Tolerances: returns ``rtol=1e-5, atol=1e-3``
(f32 profit sums in the same order; XLA may contract a product and a sum
into an FMA); the int32 on-hand stream exactly; rewards ``rtol=1e-5,
atol=1e-2``. The struct caps themselves still bind where the struct is
packed, on the card (``_im_plan``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernel_rollout import _replay_chain

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.agents import recurrent_ppo as trppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
B = 128
CASES = {
    # nine stocked stages, one past IM_MAX_M1
    "m1=9": dict(periods=8, I0=(80,) * 9, r=tuple(16.0 - i for i in range(10)),
                 k=(0.1,) * 10, h=(0.1,) * 9, c=(60,) * 9, L=(1, 2, 3) * 3),
    # a lead time of 33, one past IM_MAX_LT; 36 periods so that it arrives
    "lt_max=33": dict(periods=36, L=(1, 5, 33)),
}


def _params(case):
    jp = jim.default_params(**CASES[case])
    tp = interop.im_params_from_numpy(dataclasses.asdict(jp))
    assert tp.m1 > tek.IM_MAX_M1 or tp.lt_max > tek.IM_MAX_LT
    with pytest.raises(ValueError, match="too large"):
        tek._im_plan(tp, CPU)
    return jp, tp


def _jax_k7(jp, acts, dems):
    return np.asarray(jek.episode_returns_im(jp, jnp.asarray(acts.numpy()),
                                             jnp.asarray(dems.numpy()), block=B,
                                             interpret=True))


def _mlp_actor(tp):
    D = tim.observation_space(tp).shape[0]
    model = tnetworks.MLPActorCritic(D, tp.m1, pi_arch=(16,), vf_arch=(16,),
                                     generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.mean.weight.mul_(30.0)
    rms = interop.rms_from_numpy(np.full(D, 40.0), np.full(D, 900.0), 1e3, device=CPU)
    return tek.fold_actor_params(tppo.PPOConfig(), model, rms)


@pytest.mark.parametrize("case", list(CASES))
def test_random_policy_plain_k8_k9_past_the_caps(case):
    jp, tp = _params(case)
    acts, dems = tek.sample_streams_debug_im(tp, 11, B, device=CPU)
    assert acts.shape == (tp.periods, tp.m1, B)
    k8 = tek.episode_returns_im_fused(tp, 11, B, device=CPU)
    np.testing.assert_allclose(k8.numpy(), _jax_k7(jp, acts, dems), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_policy_plain_k11_k12_past_the_caps(case):
    jp, tp = _params(case)
    ret, acts, dems = tek.sample_policy_streams_debug_im(tp, _mlp_actor(tp), 11, B,
                                                         device=CPU)
    np.testing.assert_allclose(ret.numpy(), _jax_k7(jp, acts[:, 0], dems[:, 0]), rtol=1e-5,
                               atol=1e-3)
    assert len(np.unique(acts)) > 10


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_plain_k10_past_the_caps(case):
    jp, tp = _params(case)
    tr = tek.rollout_traj_im(tp, _mlp_actor(tp), torch.full((tp.m1,), -0.7), 11, B,
                             device=CPU)
    obs_all, rew, final_inv = _replay_chain(jp, tr["actions"].numpy(), tr["demand"].numpy())
    T = tp.periods
    np.testing.assert_array_equal(tr["inv"][:T].numpy(),
                                  np.asarray(obs_all)[:T, :, :tp.m1].transpose(0, 2, 1))
    np.testing.assert_array_equal(tr["inv"][T].numpy(), np.asarray(final_inv))
    np.testing.assert_allclose(tr["reward"].numpy(), np.asarray(rew), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("case", list(CASES))
def test_lstm_plain_k22_k23_past_the_caps(case):
    jp, tp = _params(case)
    D = tim.observation_space(tp).shape[0]
    model = tnetworks.LSTMActorCritic(D, tp.m1, hidden=8, encoder=(8,),
                                      generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.mean.weight.mul_(30.0)
    actor = tek.fold_lstm_actor(trppo.RecurrentPPOConfig(), model, None)
    ret, acts, dems = tek.sample_lstm_streams_debug_im(tp, actor, 11, B, device=CPU)
    np.testing.assert_allclose(ret.numpy(), _jax_k7(jp, acts, dems), rtol=1e-5, atol=1e-3)
    assert torch.equal(ret, tek.episode_returns_im_lstm(tp, actor, 11, B, device=CPU))
