"""The port's batched Newsvendor env (or_gym_inventory_torch/envs/newsvendor.py)
against the JAX package's single-env functions.

The same NumPy econ, action and demand streams go through the port's batched
``step_with_demand`` chain and JAX's, vmapped over lanes
(``_nv_reference_returns`` of tests/test_pallas_episode_kernels.py, and a
per-step chain here). Tolerances:

- returns, rewards and pipelines: ``rtol=1e-5, atol=1e-2``, as
  tests/test_pallas_episode_kernels.py holds the Newsvendor kernel to the
  JAX chain (f32 sums; XLA may contract a product and a sum into an FMA and
  sums the pipeline in its own order; gamma^t is a float32 power in JAX);
- econ formulas, spaces, params, the reset and the assembled observations:
  exact;
- ``step``'s Poisson draws (``torch.poisson``, where JAX draws from
  ``jax.random.poisson``: the same law from another stream): a chi-squared
  test at p > 1e-4;
- the seed-42 goldens of BASELINE.md:24-26, drawn through the port's own
  ``core/parity.py``: the reset obs within 1e-3 and the 40-step total within
  1.0, as tests/test_newsvendor.py:40-49 holds JAX to them; the demands
  exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from test_pallas_episode_kernels import _nv_reference_returns
from test_torch_im_env import chi2_pvalue

from or_gym_inventory_torch.core import parity as tparity
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.vector import vecenv
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
B = 128


def _params(**kw):
    jp = jnv.default_params(**kw)
    return jp, tnv.NewsvendorParams(**dataclasses.asdict(jp))


def _streams(tp, seed, n=B):
    """NumPy econ (5, n) from uniforms through the reset's formulas, actions
    below 0 and above max_order, Poisson demand."""
    r = np.random.default_rng(seed)
    u = r.random((5, n)).astype(np.float32)
    econ = torch.stack(tnv.econ_from_uniforms(tp, torch.from_numpy(u))).numpy()
    T = tp.step_limit
    acts = r.uniform(-50.0, tp.max_order_quantity * 1.1, (T, n)).astype(np.float32)
    dems = r.poisson(econ[4], (T, n)).astype(np.float32)
    return econ, acts, dems


def _torch_chain(tp, econ, acts, dems):
    """The port's batched chain: (per-step rewards (T, n), obs (T+1, n, D),
    final state, per-step infos)."""
    state, ts = tnv.reset_with_econ(tp, torch.from_numpy(econ.T.copy()))
    obs, rews, infos = [ts.obs], [], []
    for t in range(tp.step_limit):
        state, ts = tnv.step_with_demand(tp, state, torch.from_numpy(acts[t]),
                                         torch.from_numpy(dems[t]))
        obs.append(ts.obs)
        rews.append(ts.reward)
        infos.append(ts.info)
    return torch.stack(rews), torch.stack(obs), state, infos


@pytest.mark.parametrize("L", [5, 0])
@pytest.mark.parametrize("gamma", [1.0, 0.99])
def test_step_chain_matches_vmapped_jax_chain(L, gamma):
    jp, tp = _params(step_limit=13, lead_time=L, gamma=gamma)
    econ, acts, dems = _streams(tp, 7 + L)
    rews, obs, state, infos = _torch_chain(tp, econ, acts, dems)
    disc = torch.tensor([np.float32(gamma ** t) for t in range(tp.step_limit)])
    got = (disc[:, None] * rews).sum(0).numpy()
    want = np.asarray(_nv_reference_returns(jp, jnp.asarray(econ), jnp.asarray(acts),
                                            jnp.asarray(dems)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)

    # step by step, vmapped: rewards, observations, the pipeline
    jstate = jax.vmap(lambda e: jnv.reset_with_econ(jp, e)[0], in_axes=1)(jnp.asarray(econ))
    step = jax.jit(jax.vmap(jnv.step_with_demand, in_axes=(None, 0, 0, 0)), static_argnums=0)
    for t in range(tp.step_limit):
        jstate, jts = step(jp, jstate, jnp.asarray(acts[t])[:, None], jnp.asarray(dems[t]))
        np.testing.assert_allclose(rews[t].numpy(), np.asarray(jts.reward), rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(obs[t + 1].numpy(), np.asarray(jts.obs), rtol=1e-5, atol=1e-2)
        for k in ("revenue", "purchase_cost", "holding_cost", "lost_sales_penalty"):
            np.testing.assert_allclose(infos[t][k].numpy(), np.asarray(jts.info[k]),
                                       rtol=1e-5, atol=1e-2)
    assert state.step_count.tolist() == [tp.step_limit] * B
    np.testing.assert_array_equal(state.pipeline.numpy(), np.asarray(jstate.pipeline))


def test_nan_action_propagates_and_truncation():
    _, tp = _params(step_limit=3)
    econ, acts, dems = _streams(tp, 1, 8)
    acts[1, 2] = np.nan
    rews, _, _, _ = _torch_chain(tp, econ, acts, dems)
    assert torch.isnan(rews[:, 2]).any() and torch.isfinite(rews[:, [0, 1, 3]]).all()
    state, ts = tnv.reset(tp, torch.Generator().manual_seed(0), 4, device=CPU)
    for t in range(tp.step_limit):
        state, ts = tnv.step(tp, state, torch.zeros(4, 1), torch.Generator().manual_seed(t))
        assert bool(ts.truncated.all()) == (t == tp.step_limit - 1)
        assert not ts.terminated.any()


def test_reset_econ_spaces_and_params_match_jax():
    jp, tp = _params()
    econ, _, _ = _streams(tp, 3, 16)
    state, ts = tnv.reset_with_econ(tp, torch.from_numpy(econ.T.copy()))
    jstate, jts = jax.vmap(lambda e: jnv.reset_with_econ(jp, e), in_axes=1)(jnp.asarray(econ))
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(jts.obs))
    np.testing.assert_array_equal(state.pipeline.numpy(), np.asarray(jstate.pipeline))
    assert ts.obs.shape == (16, tp.obs_dim) and not ts.done.any()
    for k in ("price", "cost", "holding_cost_rate", "penalty_cost_rate", "demand_mean"):
        np.testing.assert_array_equal(ts.info[k].numpy(), np.asarray(jts.info[k]))
    # the reset's formulas: the same five uniforms give JAX's econ bit for bit
    u = np.random.default_rng(5).random((5, 64)).astype(np.float32)
    got = tnv.econ_from_uniforms(tp, torch.from_numpy(u))
    want = jek._nv_econ_from_uniforms(jp, jnp.asarray(u))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    e = tnv.draw_econ(tp, torch.Generator().manual_seed(0), 4096, device=CPU)
    assert e.shape == (4096, 5) and e.dtype == torch.float32
    price, cost, h, k, mu = e.T
    assert (price >= 1).all() and (cost >= 1).all() and (cost <= price).all()
    assert (h <= torch.clamp(cost, max=tp.h_max)).all() and (k <= tp.k_max).all()
    assert (mu >= 0).all() and (mu < tp.mu_max).all()
    for a, b in ((tnv.observation_space(tp), jnv.observation_space(jp)),
                 (tnv.action_space(tp), jnv.action_space(jp))):
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
        assert a.dtype == b.dtype
    cfg = {"lead_time": -3, "step_limit": 50, "p_max": 80.0, "mu_max": 3.0, "gamma": 0.9}
    assert dataclasses.asdict(tnv.default_params(cfg)) == dataclasses.asdict(
        jnv.default_params(cfg))
    assert tnv.default_params(cfg).lead_time == 0 and tnv.default_params(cfg).obs_dim == 5
    with pytest.raises(KeyError):
        tnv.default_params({"bogus": 1})
    assert hash(tp) == hash(tnv.NewsvendorParams(**dataclasses.asdict(jp)))


@pytest.mark.parametrize("L", [5, 0])
def test_assemble_obs_from_streams_matches_jax(L):
    jp, tp = _params(step_limit=9, lead_time=L)
    econ, acts, dems = _streams(tp, 11, 32)
    _, obs, _, _ = _torch_chain(tp, econ, acts, dems)
    # the capped orders entering the pipeline, replayed from the chain
    state, _ = tnv.reset_with_econ(tp, torch.from_numpy(econ.T.copy()))
    orders = []
    for t in range(tp.step_limit):
        q = torch.clamp(torch.from_numpy(acts[t]), 0, tp.max_order_quantity)
        cap = tp.max_inventory - state.pipeline.sum(1)
        orders.append(torch.clamp(torch.minimum(q, cap), min=0))
        state, _ = tnv.step_with_demand(tp, state, torch.from_numpy(acts[t]),
                                        torch.from_numpy(dems[t]))
    orders = torch.stack(orders)
    got = tnv.assemble_obs_from_streams(tp, torch.from_numpy(econ), orders)
    want = jnv.assemble_obs_from_streams(jp, jnp.asarray(econ), jnp.asarray(orders.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (tp.step_limit + 1, 32, tp.obs_dim)
    np.testing.assert_allclose(got.numpy(), obs.numpy(), rtol=1e-6, atol=1e-3)


def test_step_draws_poisson_demand():
    _, tp = _params(step_limit=4)
    n = 20_000
    econ = torch.tensor([50.0, 20.0, 1.0, 5.0, 12.5]).expand(n, 5).contiguous()
    state, _ = tnv.reset_with_econ(tp, econ)
    gen = torch.Generator().manual_seed(4)
    draws = []
    for _ in range(tp.step_limit):
        state, ts = tnv.step(tp, state, torch.full((n, 1), 30.0), gen)
        draws.append(ts.info["demand"])
    d = torch.cat(draws).numpy()
    assert (d == np.round(d)).all() and d.min() >= 0
    assert chi2_pvalue(d.astype(np.int64), lambda k: stats.poisson.pmf(k, 12.5)) > 1e-4


def test_vecenv_runs_newsvendor():
    _, tp = _params(step_limit=6)
    space = tnv.action_space(tp)

    def policy(_s, obs, g, _t):
        return space.sample(g, (obs.shape[0],), device=CPU)

    gen = torch.Generator().manual_seed(0)
    (state, obs), traj = vecenv.rollout(tnv.ENV, tp, policy, None, gen, 16, 9, device=CPU)
    assert traj.reward.shape == (9, 16) and torch.isfinite(traj.reward).all()
    assert traj.done[5].all() and not traj.done[4].any()   # auto-reset after step 6
    assert (state.step_count == 3).all() and obs.shape == (16, tp.obs_dim)
    totals, _ = vecenv.evaluate_episodes(tnv.ENV, tp, policy, None, gen, 16, device=CPU)
    assert totals.shape == (16,) and torch.isfinite(totals).all()
    assert tnv.ENV.horizon(tp) == 6 and tnv.ENV.name == "newsvendor"


def test_golden_seed42():
    """BASELINE.md:24-26 through the port's parity module: the reference's
    reset(seed=42) obs, its first 5 Poisson demands, and the 40-step total
    reward of a constant order of 100."""
    params = tnv.default_params()
    r = tparity.reference_rng(42)
    econ = tparity.newsvendor_reset_draws(r, params.p_max, params.h_max, params.k_max,
                                          params.mu_max)
    state, ts = tnv.reset_with_econ(params, torch.tensor([econ], dtype=torch.float32))
    np.testing.assert_allclose(ts.obs[0].numpy(),
                               [77.3956, 33.9673, 4.2930, 6.9737, 18.8355, 0, 0, 0, 0, 0],
                               atol=1e-3)
    demands = tparity.newsvendor_demand_stream(r, econ[4], 40)
    assert list(demands[:5]) == [23, 18, 27, 23, 15]
    total = 0.0
    for t in range(40):
        state, ts = tnv.step_with_demand(params, state, torch.tensor([100.0]),
                                         torch.tensor([float(demands[t])]))
        total += float(ts.reward[0])
    assert abs(total - (-99353.0228)) < 1.0, total
