"""PPO on InvManagement through the trajectory kernel (agents/ppo.py with
``rollout="kernel"``, K10) against the JAX package's ``update_kernel``, and
the InvManagement ends of training and evaluation.

The update is compared on one trajectory, made by the port's plain K10 on
the CPU and handed to both sides: ``pallas_episode_kernels.rollout_traj_im``
and the port's ``episode_kernels.rollout_traj_im`` are patched to return it,
and ``jax.default_backend`` answers "tpu" only while JAX builds its update.
Nothing in the JAX package changes. Tolerance: ``rtol=1e-4, atol=1e-5`` for
the update's new parameters, statistics and metrics (eight Adam steps over
f32 losses summed in another order), as tests/test_torch_ppo.py holds the
NetInvMgmt update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_torch.vector import vecenv
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
STEPS, ENVS = 6, 1024
RECIPE = dict(num_envs=ENVS, rollout_steps=STEPS, num_minibatches=4, update_epochs=2,
              pi_arch=(16, 16), vf_arch=(16, 16), rollout="kernel",
              shuffle_minibatches=False)


def _params(**kw):
    jp = jim.default_params(periods=STEPS, **kw)
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


def _states(jp, tp, jcfg, tcfg):
    jstate = jppo.init_train_state(jim.ENV, jp, jcfg, jax.random.PRNGKey(0), 3)
    tstate = tppo.init_train_state(tim.ENV, tp, tcfg, torch.Generator().manual_seed(0),
                                   3, device=CPU)
    tstate.params.load_state_dict(interop.ppo_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), device=CPU))
    return jstate, tstate


@pytest.mark.parametrize("backlog", [True, False], ids=["backlog", "lost_sales"])
def test_kernel_update_matches_jax(monkeypatch, backlog):
    jp, tp = _params(backlog=backlog)
    jcfg, tcfg = jppo.PPOConfig(**RECIPE), tppo.PPOConfig(**RECIPE)
    jstate, tstate = _states(jp, tp, jcfg, tcfg)
    actor = tek.fold_actor_params(tcfg, tstate.params, tstate.rms)
    tr = tek.rollout_traj_im(tp, actor, tstate.params.log_std.detach(), 5, ENVS, device=CPU)
    jtr = {k: jnp.asarray(v.numpy()) for k, v in tr.items()}
    monkeypatch.setattr(jek, "rollout_traj_im", lambda *a, **k: jtr)
    monkeypatch.setattr(tek, "rollout_traj_im", lambda *a, **k: tr)
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        jupdate = jppo.make_update_fn(jim.ENV, jp, jcfg, 3)
    jnew, jmetrics = jax.jit(jupdate)(jstate, jax.random.PRNGKey(1))
    before = {k: v.clone() for k, v in tstate.params.state_dict().items()}
    tupdate = tppo.make_update_fn(tim.ENV, tp, tcfg, 3, device=CPU)
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


def test_train_on_cpu():
    _, tp = _params()
    cfg = tppo.PPOConfig(**dict(RECIPE, num_envs=100, shuffle_minibatches=None))
    launches = tek.rollout_traj_im.launches
    state, metrics = tppo.train(tim.ENV, tp, cfg, torch.Generator().manual_seed(0),
                                2 * 100 * STEPS, device=CPU)
    assert state.update_idx == 2 and tek.rollout_traj_im.launches == launches
    assert all(np.isfinite(v).all() and v.shape == (2,) for v in metrics.values())
    assert state.rms.mean.shape == (tim.observation_space(tp).shape[0],)
    with pytest.raises(ValueError, match="horizon"):
        tppo.train(tim.ENV, tp, cfg.replace(rollout_steps=5), torch.Generator(), 600,
                   device=CPU)


def test_evaluation_of_a_trained_policy_and_what_is_not_ported():
    _, tp = _params()
    cfg = tppo.PPOConfig(pi_arch=(16,), vf_arch=(16,))
    model = tppo._make_model(tim.ENV, tp, cfg, torch.Generator().manual_seed(0))
    rms = tppo.RunningMeanStd.create(tim.observation_space(tp).shape[0], CPU)
    policy = tppo.make_eval_policy(tim.ENV, tp, cfg, deterministic=True)
    totals, traj = vecenv.evaluate_episodes(tim.ENV, tp, policy, (model, rms),
                                            torch.Generator().manual_seed(1), 8, device=CPU)
    assert totals.shape == (8,) and torch.isfinite(totals).all()
    a = traj.action
    assert a.dtype == torch.int32 and int(a.min()) >= 0
    assert (a <= torch.tensor(tp.c)).all()
    actor = tek.fold_actor_params(cfg, model, rms)
    out = tfe.policy_episode_returns(tp, actor, torch.Generator().manual_seed(2), 4,
                                     device=CPU)
    assert out.shape == (4,) and torch.isfinite(out).all()
