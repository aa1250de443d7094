"""PPO on Newsvendor through the trajectory kernel (agents/ppo.py with
``rollout="kernel"``, K18) against the JAX package's ``update_kernel``, and
the Newsvendor ends of training and evaluation.

The update is compared on one trajectory, made by the port's plain K18 on
the CPU and handed to both sides: ``pallas_episode_kernels.rollout_traj_nv``
and the port's ``episode_kernels.rollout_traj_nv`` are patched to return it,
and ``jax.default_backend`` answers "tpu" only while JAX builds its update
(``num_envs`` is 1,024, the multiple JAX's check at agents/ppo.py:310
needs). Nothing in the JAX package changes. Tolerance: ``rtol=1e-4,
atol=1e-5`` for the update's new parameters, statistics and metrics (eight
Adam steps over f32 losses summed in another order), as
tests/test_torch_im_ppo.py holds the InvManagement update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
STEPS, ENVS = 6, 1024
RECIPE = dict(num_envs=ENVS, rollout_steps=STEPS, num_minibatches=4, update_epochs=2,
              pi_arch=(16, 16), vf_arch=(16, 16), rollout="kernel",
              shuffle_minibatches=False)


def _params(**kw):
    jp = jnv.default_params(step_limit=STEPS, **kw)
    return jp, tnv.NewsvendorParams(**dataclasses.asdict(jp))


def _states(jp, tp, jcfg, tcfg):
    jstate = jppo.init_train_state(jnv.ENV, jp, jcfg, jax.random.PRNGKey(0), 3)
    tstate = tppo.init_train_state(tnv.ENV, tp, tcfg, torch.Generator().manual_seed(0),
                                   3, device=CPU)
    tstate.params.load_state_dict(interop.ppo_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), device=CPU))
    return jstate, tstate


@pytest.mark.parametrize("L", [5, 0])
def test_kernel_update_matches_jax(monkeypatch, L):
    jp, tp = _params(lead_time=L)
    jcfg, tcfg = jppo.PPOConfig(**RECIPE), tppo.PPOConfig(**RECIPE)
    jstate, tstate = _states(jp, tp, jcfg, tcfg)
    actor = tek.fold_actor_params(tcfg, tstate.params, tstate.rms)
    tr = tek.rollout_traj_nv(tp, actor, tstate.params.log_std.detach(), 5, ENVS, device=CPU)
    jtr = {k: jnp.asarray(v.numpy()) for k, v in tr.items()}
    monkeypatch.setattr(jek, "rollout_traj_nv", lambda *a, **k: jtr)
    monkeypatch.setattr(tek, "rollout_traj_nv", lambda *a, **k: tr)
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        jupdate = jppo.make_update_fn(jnv.ENV, jp, jcfg, 3)
    jnew, jmetrics = jax.jit(jupdate)(jstate, jax.random.PRNGKey(1))
    before = {k: v.clone() for k, v in tstate.params.state_dict().items()}
    tupdate = tppo.make_update_fn(tnv.ENV, tp, tcfg, 3, device=CPU)
    tnew, tmetrics = tupdate(tstate, torch.Generator().manual_seed(1))

    tol = dict(rtol=1e-4, atol=1e-5)
    want = interop.ppo_params_from_numpy(jax.tree_util.tree_map(np.asarray, jnew.params),
                                         device=CPU)
    got = tnew.params.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)
    for name in ("rms", "ret_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(getattr(tnew, name), f).numpy(),
                                       np.asarray(getattr(getattr(jnew, name), f)),
                                       err_msg=f"{name}.{f}", **tol)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), err_msg=k, **tol)
    assert tnew.update_idx == 1 and tnew.opt_state.count == 8
    assert not torch.equal(got["value.weight"], before["value.weight"])
    # the reward stream is undiscounted; the return accumulator discounts it
    assert float(tmetrics["mean_step_reward"]) == pytest.approx(float(tr["reward"].mean()))


def test_train_on_cpu():
    _, tp = _params()
    cfg = tppo.PPOConfig(**dict(RECIPE, num_envs=100, shuffle_minibatches=None))
    launches = tek.rollout_traj_nv.launches
    state, metrics = tppo.train(tnv.ENV, tp, cfg, torch.Generator().manual_seed(0),
                                2 * 100 * STEPS, device=CPU)
    assert state.update_idx == 2 and tek.rollout_traj_nv.launches == launches
    assert all(np.isfinite(v).all() and v.shape == (2,) for v in metrics.values())
    assert state.rms.mean.shape == (tp.obs_dim,)
    assert float(state.ret_rms.var[0]) > 1.0   # reward normalisation saw the returns


def test_horizon_error():
    _, tp = _params()
    cfg = tppo.PPOConfig(**dict(RECIPE, num_envs=100))
    with pytest.raises(ValueError, match="horizon"):
        tppo.train(tnv.ENV, tp, cfg.replace(rollout_steps=STEPS - 1), torch.Generator(), 600,
                   device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tppo.train(tnv.ENV, tp, cfg, torch.Generator(), 600)


@pytest.mark.parametrize("L", [5, 0])
def test_evaluation_of_a_trained_policy(L):
    _, tp = _params(lead_time=L)
    cfg = tppo.PPOConfig(**dict(RECIPE, num_envs=64, shuffle_minibatches=None))
    state, _ = tppo.train(tnv.ENV, tp, cfg, torch.Generator().manual_seed(0), 64 * STEPS,
                          device=CPU)
    actor = tek.fold_actor_params(cfg, state.params, state.rms)
    log_std = state.params.log_std.detach()
    det = tfe.policy_episode_returns(tp, actor, torch.Generator().manual_seed(2), 32,
                                     episodes_per_lane=2, device=CPU)
    sto = tfe.policy_episode_returns(tp, actor, torch.Generator().manual_seed(2), 32,
                                     episodes_per_lane=2, deterministic=False,
                                     log_std=log_std, device=CPU)
    for out in (det, sto):
        assert out.shape == (64,) and out.dtype == torch.float32 and torch.isfinite(out).all()
    assert not torch.equal(det, sto)   # the noise is applied
    with pytest.raises(ValueError, match="log_std"):
        tfe.policy_episode_returns(tp, actor, torch.Generator(), 4, deterministic=False,
                                   device=CPU)
