"""Recurrent PPO through the LSTM trajectory kernel
(agents/recurrent_ppo.py with ``rollout="kernel"``, K24) against the JAX
package's ``update_kernel``, and the learner's own checks.

The update is compared on one trajectory, made by the port's plain K24 on
the CPU and handed to both sides: ``pallas_episode_kernels.rollout_traj_im_lstm``
and the port's ``episode_kernels.rollout_traj_im_lstm`` are patched to
return it, and ``jax.default_backend`` answers "tpu" only while JAX builds
its functions. Nothing in the JAX package changes. With one minibatch the
JAX key's env permutation only reorders sums. Tolerance: ``rtol=1e-4,
atol=1e-5`` for the update's new parameters, statistics and metrics (two
Adam steps over f32 losses summed in another order, the LSTM re-run over
six periods), as tests/test_torch_im_ppo.py holds the MLP update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import recurrent_ppo as trppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.parallel import make_mesh
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.agents import recurrent_ppo as jrppo
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
STEPS, ENVS = 6, 1024
RECIPE = dict(num_envs=ENVS, rollout_steps=STEPS, num_minibatches=1, update_epochs=2,
              hidden=16, encoder=(8,), rollout="kernel")


def _params(**kw):
    jp = jim.default_params(periods=STEPS, **kw)
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


@pytest.mark.parametrize("backlog", [True, False], ids=["backlog", "lost_sales"])
def test_kernel_update_matches_jax(monkeypatch, backlog):
    jp, tp = _params(backlog=backlog)
    jcfg, tcfg = jrppo.RecurrentPPOConfig(**RECIPE), trppo.RecurrentPPOConfig(**RECIPE)
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        jinit, jupdate, _ = jrppo.make_train_fns(jim.ENV, jp, jcfg, 3)
    jstate = jax.jit(jinit)(jax.random.PRNGKey(0))
    tinit, tupdate, _ = trppo.make_train_fns(tim.ENV, tp, tcfg, 3, device=CPU)
    tstate = tinit(torch.Generator().manual_seed(0))
    tstate.params.load_state_dict(interop.lstm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), device=CPU))
    actor = tek.fold_lstm_actor(tcfg, tstate.params, tstate.rms)
    tr = tek.rollout_traj_im_lstm(tp, actor, tstate.params.log_std.detach(), 5, ENVS,
                                  device=CPU)
    assert len(torch.unique(tr["actions"])) > 5
    jtr = {k: jnp.asarray(v.numpy()) for k, v in tr.items()}
    monkeypatch.setattr(jek, "rollout_traj_im_lstm", lambda *a, **k: jtr)
    monkeypatch.setattr(tek, "rollout_traj_im_lstm", lambda *a, **k: tr)
    jnew, jmetrics = jax.jit(jupdate)(jstate, jax.random.PRNGKey(1))
    before = {k: v.clone() for k, v in tstate.params.state_dict().items()}
    tnew, tmetrics = tupdate(tstate, torch.Generator().manual_seed(1))

    tol = dict(rtol=1e-4, atol=1e-5)
    want = interop.lstm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jnew.params),
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
    assert tnew.update_idx == 1 and tnew.opt_state.count == 2
    assert not torch.equal(got["cell.wh"], before["cell.wh"])


@settings(max_examples=20, deadline=None)
@given(n_mb=st.integers(1, 6), per_mb=st.integers(1, 9), seed=st.integers(0, 2 ** 31 - 1))
def test_env_slices_partition_the_envs(n_mb, per_mb, seed):
    """Each epoch's minibatches are equal, disjoint slices of the env axis
    that together hold every env."""
    slices = trppo.env_slices(n_mb * per_mb, n_mb, torch.Generator().manual_seed(seed))
    assert slices.shape == (n_mb, per_mb)
    assert sorted(slices.reshape(-1).tolist()) == list(range(n_mb * per_mb))


def test_four_minibatches_rerun_whole_sequences(monkeypatch):
    """With 4 minibatches every re-forward of the SGD phase sees whole
    sequences (all T periods) of a quarter of the envs, each env once per
    epoch, and the carry starts at zero."""
    _, tp = _params()
    cfg = trppo.RecurrentPPOConfig(**dict(RECIPE, num_envs=40, num_minibatches=4))
    init, _, _ = trppo.make_train_fns(tim.ENV, tp, cfg, 1, device=CPU)
    state = init(torch.Generator().manual_seed(0))
    D, m1 = tim.observation_space(tp).shape[0], tp.m1
    obs = torch.zeros((STEPS, 40, D))
    obs[:, :, 0] = torch.arange(40, dtype=torch.float32)   # the env's id in column 0
    done_in = torch.zeros((STEPS, 40), dtype=torch.bool)
    done_in[0] = True
    batch = dict(obs=obs, done_in=done_in, raw=torch.zeros((STEPS, 40, m1)),
                 logp=torch.zeros((STEPS, 40)), adv=torch.randn(STEPS, 40),
                 ret=torch.zeros((STEPS, 40)))
    seen = []
    real = tnetworks.LSTMActorCritic.forward_sequence

    def spy(self, carry, obs_seq, done_seq):
        assert all(float(c.abs().max()) == 0 for c in carry)
        seen.append((obs_seq[:, :, 0].detach().clone(), done_seq.clone()))
        return real(self, carry, obs_seq, done_seq)

    monkeypatch.setattr(tnetworks.LSTMActorCritic, "forward_sequence", spy)
    trppo.sgd_epochs(cfg, trppo.Optimizer(cfg, 1), state, batch, lambda x: x.float(),
                     torch.Generator().manual_seed(3))
    assert len(seen) == cfg.update_epochs * 4
    for epoch in range(cfg.update_epochs):
        ids = []
        for ids_t, done_t in seen[4 * epoch:4 * epoch + 4]:
            assert ids_t.shape == (STEPS, 10) and bool(done_t[0].all())
            assert bool((ids_t == ids_t[0]).all())   # one env per column, all T rows
            ids += ids_t[0].long().tolist()
        assert sorted(ids) == list(range(40))


def test_train_and_eval_on_cpu():
    _, tp = _params()
    cfg = trppo.RecurrentPPOConfig(**dict(RECIPE, num_envs=64, num_minibatches=4))
    launches = tek.rollout_traj_im_lstm.launches
    state, eval_episodes, metrics = trppo.train(
        tim.ENV, tp, cfg, torch.Generator().manual_seed(0), 2 * 64 * STEPS, device=CPU)
    assert state.update_idx == 2 and tek.rollout_traj_im_lstm.launches == launches
    assert set(metrics) == {"mean_step_reward", "pg_loss", "v_loss", "entropy", "update",
                            "timesteps"}
    assert all(np.isfinite(v).all() and v.shape == (2,) for v in metrics.values())
    totals = eval_episodes(state.params, state.rms, torch.Generator().manual_seed(4), 8)
    assert totals.shape == (8,) and torch.isfinite(totals).all()
    with pytest.raises(ValueError, match="horizon"):
        trppo.train(tim.ENV, tp, cfg.replace(rollout_steps=5), torch.Generator(), 600,
                    device=CPU)


def test_what_is_not_ported_raises():
    _, tp = _params()
    cfg = trppo.RecurrentPPOConfig(**RECIPE)
    # the xla path is ported: it trains (tests/test_torch_rppo_xla.py holds it)
    state, _, metrics = trppo.train(tim.ENV, tp, cfg.replace(rollout="xla"), torch.Generator(),
                                    6 * ENVS, device=CPU)
    assert state.update_idx == 1 and np.isfinite(metrics["v_loss"]).all()
    # so is the mesh: one rank here (two ranks: tests/test_torch_dp_train.py)
    state, _, metrics = trppo.train(tim.ENV, tp, cfg.replace(num_envs=8), torch.Generator(),
                                    6 * 8, mesh=make_mesh(CPU))
    assert state.update_idx == 1 and state.last_obs.shape[0] == 8
    assert np.isfinite(metrics["v_loss"]).all()
    nvp = tnv.default_params(step_limit=STEPS)
    with pytest.raises(NotImplementedError, match="InvManagement"):
        trppo.make_train_fns(tnv.ENV, nvp, cfg, 1, device=CPU)
    with pytest.raises(NotImplementedError, match="tanh"):
        trppo.train(tim.ENV, tp, cfg.replace(activation="relu", num_envs=8), torch.Generator(),
                    6 * 8, device=CPU)
    # the agents are ported: they construct (tests/test_torch_rppo_agents.py)
    for agent, name in ((trppo.RecurrentPPOAgent, "PPO_LSTM"), (trppo.A2CLSTMAgent, "A2C_LSTM")):
        built = agent(tim.ENV, tim.default_params)
        assert built.name == name and built.train_state is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trppo.train(tim.ENV, tp, cfg, torch.Generator(), 6 * ENVS)


@pytest.mark.parametrize("make", ["RecurrentPPOConfig", "A2CLSTMConfig"])
def test_configs_mirror_jax(make):
    jcfg, tcfg = getattr(jrppo, make)(), getattr(trppo, make)()
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tf = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    assert jf == tf
