"""Recurrent PPO's fused policy+env update (``rollout="xla"``,
agents/recurrent_ppo.py) against the JAX package's jitted
``make_train_fns(...)[1]`` on the same parameters and streams.

Both packages read the same NumPy streams, made from a seed, as
tests/test_torch_ppo_xla.py feeds PPO's update (its ``_patch``: the
policy's normals through ``networks.gaussian_sample``, each step's demand
through ``vecenv.batch_step`` patched to ``step_with_demand``, each
Newsvendor reset's economics through ``vecenv.batch_reset`` patched to
``reset_with_econ``), plus each SGD epoch's env permutation
(``jax.random.permutation`` in JAX, ``recurrent_ppo.env_slices`` in the
port). JAX's jitted update reads them through ordered ``io_callback``s;
nothing in the JAX package changes. The flax parameters are carried into
the port with ``utils.interop.lstm_params_from_numpy``.

Each case runs two updates of ``rollout_steps`` 8 on an env whose horizon
(10 or 12) it does not divide: the second update starts from the live carry
of episodes in flight, and episodes end inside it, where the carry is
zeroed through ``done_in``, the envs reset and the return accumulator is
zeroed after it is recorded. After each update the parameters, ``rms``,
``ret_rms``, ``ret_accum``, ``last_obs``, ``last_done``, the carry and the
metrics are held at ``rtol=1e-4, atol=1e-5``, the tolerance of
tests/test_torch_recurrent_ppo.py (Adam or RMSprop steps over f32 losses
summed in another order, the LSTM re-run over eight periods).

The second update is the one that holds ``sgd_epochs`` to the update's
initial carry, sliced per minibatch with the env indices (JAX
recurrent_ppo.py:148-149): re-running each minibatch from a zero carry
instead, as the kernel path may (its episodes start fresh), gives other
gradients there, and every case here fails its second update with that
change.

The float families' cases start both learners from the obs statistics of
a random-policy rollout, as tests/test_torch_ppo_xla.py's Newsvendor PPO
case does and as every update after a learner's first one runs: from unit
statistics their raw obs (Newsvendor's orders up to 2,000, NetInvMgmt's
stocks in the hundreds) drive the encoder's tanh units far past x = 8,
where XLA's CPU tanh is exactly 1 and torch's is not, so 1 - tanh^2
differs by up to 100% and Adam carries that into the encoder at 1e-4
relative (NetInvMgmt's PPO_LSTM case did so, 3 of 1,088 weights, from
unit statistics). InvManagement's runs from unit statistics within the
tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import io_callback
import pytest
import torch

from or_gym_inventory_torch.agents import recurrent_ppo as trppo
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.agents import recurrent_ppo as jrppo
from test_torch_ppo_xla import ENVS, STEPS, UPDATES, _Streams, _family, _patch, _rollout_rms

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-5)
PPO_LSTM = dict(num_envs=ENVS, rollout_steps=STEPS, num_minibatches=4, update_epochs=2,
                hidden=16, encoder=(16,))


class _RStreams(_Streams):
    """``_Streams`` with each SGD epoch's env permutation."""

    def __init__(self, family, tp, act_dim, n_retail, epochs):
        super().__init__(family, tp, act_dim, n_retail)
        r = np.random.default_rng(1)
        self.perm = np.stack([r.permutation(ENVS) for _ in range(UPDATES * epochs)]
                             ).astype(np.int32)
        self.at["perm"] = 0


def _patch_perms(monkeypatch, js, ts):
    def j_perm(_key, n):
        return io_callback(lambda: js.next("perm"), jax.ShapeDtypeStruct((n,), jnp.int32),
                           ordered=True)

    def t_slices(n_envs, num_minibatches, _generator):
        return torch.from_numpy(ts.next("perm")).long().reshape(num_minibatches, -1)

    monkeypatch.setattr(jax.random, "permutation", j_perm)
    monkeypatch.setattr(trppo, "env_slices", t_slices)


def _assert_states_match(tstate, tmetrics, jstate, jmetrics, label):
    want = interop.lstm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.params),
                                          device=CPU)
    got = tstate.params.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=f"{label} {k}",
                                   **TOL)
    for name in ("rms", "ret_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(getattr(tstate, name), f).numpy(),
                                       np.asarray(getattr(getattr(jstate, name), f)),
                                       err_msg=f"{label} {name}.{f}", **TOL)
    for f in ("ret_accum", "last_obs"):
        np.testing.assert_allclose(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                   err_msg=f"{label} {f}", **TOL)
    np.testing.assert_array_equal(tstate.last_done.numpy(), np.asarray(jstate.last_done))
    for i, name in enumerate(("c", "h")):
        np.testing.assert_allclose(tstate.carry[i].numpy(), np.asarray(jstate.carry[i]),
                                   err_msg=f"{label} carry {name}", **TOL)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   err_msg=f"{label} {k}", **TOL)


CASES = [(family, algo) for family in ("inv_management", "net_inv_management", "newsvendor")
         for algo in ("ppo_lstm", "a2c_lstm")]


@pytest.mark.parametrize("family,algo", CASES, ids=[f"{f}-{a}" for f, a in CASES])
def test_xla_updates_match_jax(monkeypatch, family, algo):
    jmod, tmod, jp, tp, n_retail = _family(family)
    if algo == "ppo_lstm":
        jcfg, tcfg = jrppo.RecurrentPPOConfig(**PPO_LSTM), trppo.RecurrentPPOConfig(**PPO_LSTM)
    else:
        jcfg, tcfg = jrppo.A2CLSTMConfig(num_envs=ENVS), trppo.A2CLSTMConfig(num_envs=ENVS)
    assert tcfg.rollout == "xla" and tcfg.rollout_steps == STEPS
    assert tmod.ENV.horizon(tp) % STEPS
    act_dim = int(np.prod(tmod.ENV.action_space(tp).shape))
    rms = _rollout_rms(tmod, tp) if family != "inv_management" else None
    js, ts = (_RStreams(family, tp, act_dim, n_retail, tcfg.update_epochs) for _ in range(2))
    _patch(monkeypatch, family, jmod, tmod, js, ts)
    _patch_perms(monkeypatch, js, ts)

    jinit, jupdate, _ = jrppo.make_train_fns(jmod.ENV, jp, jcfg, UPDATES)
    jstate = jax.jit(jinit)(jax.random.PRNGKey(0))
    jupdate = jax.jit(jupdate)
    tinit, tupdate, _ = trppo.make_train_fns(tmod.ENV, tp, tcfg, UPDATES, device=CPU)
    tstate = tinit(torch.Generator().manual_seed(0))
    tstate.params.load_state_dict(interop.lstm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), device=CPU))
    if rms is not None:
        tstate = dataclasses.replace(tstate, rms=rms)
        jstate = jstate.replace(rms=jppo.RunningMeanStd(
            mean=jnp.asarray(rms.mean.numpy()), var=jnp.asarray(rms.var.numpy()),
            count=jnp.asarray(rms.count.numpy())))
    np.testing.assert_array_equal(tstate.last_obs.numpy(), np.asarray(jstate.last_obs))
    gen = torch.Generator().manual_seed(1)
    for u in range(UPDATES):
        jstate, jmetrics = jupdate(jstate, jax.random.PRNGKey(10 + u))
        tstate, tmetrics = tupdate(tstate, gen)
        _assert_states_match(tstate, tmetrics, jstate, jmetrics,
                             f"{family} {algo}, update {u + 1}")
        if u == 0:   # the second update starts from a live carry
            assert float(tstate.carry[1].abs().max()) > 0
    assert tstate.update_idx == UPDATES
    assert js.at == ts.at and ts.at["noise"] == UPDATES * STEPS
    assert ts.at["perm"] == UPDATES * tcfg.update_epochs


def test_xla_path_trains_every_family_and_refuses_no_trunk():
    """The xla path takes the families and the trunk the kernel path
    refuses, as JAX's does (the refusals are the kernel path's alone)."""
    for family in ("newsvendor", "net_inv_management"):
        _, tmod, _, tp, _ = _family(family)
        cfg = trppo.RecurrentPPOConfig(**dict(PPO_LSTM, activation="relu"))
        state, _, metrics = trppo.train(tmod.ENV, tp, cfg, torch.Generator().manual_seed(0),
                                        ENVS * STEPS, device=CPU)
        assert state.update_idx == 1
        assert all(np.isfinite(v).all() for v in metrics.values())
        assert set(metrics) == {"mean_step_reward", "pg_loss", "v_loss", "entropy",
                                "update", "timesteps"}
