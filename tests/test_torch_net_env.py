"""The port's batched NetInvMgmt env against the JAX env under vmap.

Inputs are made once with NumPy from a seed and fed to both packages
(``utils.interop`` carries parameters and state across). Tolerances:

- X, Y, U, r_hist and obs hold integer-valued floats: they must match
  exactly;
- reward is a float sum over nodes taken in another order:
  ``atol=1e-3, rtol=1e-5``;
- the seed-42 goldens keep the JAX tests' bounds (0.5 and 2.0);
- ``sample_demand`` must pass a chi-square goodness-of-fit test against each
  spec's pmf from scipy at p > 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from or_gym_inventory_torch.core import parity as tparity
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import vecenv
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import topology as jtopo

CPU = "cpu"


def _params(graph, backlog, alpha, periods):
    jp = jnet.default_params(topology=getattr(jtopo, graph)(periods),
                             num_periods=periods, backlog=backlog, alpha=alpha)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology),
                                       periods, backlog, alpha)
    return jp, tp


def _streams(T, B, steps, seed):
    rng = np.random.default_rng(seed)
    acts = rng.uniform(0.0, 160.0, (steps, B, T.n_reorder)).astype(np.float32)
    # a quarter of the orders on exact .5 ties: rounding must be half-even
    ties = rng.random(acts.shape) < 0.25
    acts[ties] = np.floor(acts[ties]) + 0.5
    dems = rng.poisson(20.0, (steps, B, T.n_retail)).astype(np.float32)
    dems[:, ::3] += 0.5
    return acts, dems


@pytest.mark.parametrize("graph,backlog,alpha", [
    ("default_topology", True, 1.0),
    ("default_topology", False, 1.0),
    ("default_topology", True, 0.9),
    ("custom_topology", True, 1.0),
    ("custom_topology", False, 0.9),
])
def test_step_with_demand_matches_jax_vmap(graph, backlog, alpha):
    steps, B = 16, 8
    jp, tp = _params(graph, backlog, alpha, steps)
    acts, dems = _streams(jp.topology, B, steps, seed=3)
    jstep = jax.jit(jax.vmap(lambda s, a, d: jnet.step_with_demand(jp, s, a, d)))
    js, _ = jax.vmap(lambda _: jnet.reset(jp))(jnp.arange(B))
    ts_state, tts = tnet.reset(tp, batch=B, device=CPU)
    np.testing.assert_array_equal(tts.obs.numpy(), np.asarray(jnet.reset(jp)[1].obs)[None]
                                  .repeat(B, 0))
    for t in range(steps):
        js, jts = jstep(js, jnp.asarray(acts[t]), jnp.asarray(dems[t]))
        ts_state, tts = tnet.step_with_demand(tp, ts_state, torch.from_numpy(acts[t]),
                                              torch.from_numpy(dems[t]))
        for f in ("X", "Y", "U", "r_hist", "period"):
            np.testing.assert_array_equal(getattr(ts_state, f).numpy(),
                                          np.asarray(getattr(js, f)), err_msg=f)
        np.testing.assert_array_equal(tts.obs.numpy(), np.asarray(jts.obs))
        np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward),
                                   atol=1e-3, rtol=1e-5)
        for k in ("demand", "retail_sales", "fulfilled_orders", "arrivals"):
            np.testing.assert_array_equal(tts.info[k].numpy(), np.asarray(jts.info[k]))
        np.testing.assert_array_equal(tts.truncated.numpy(), np.asarray(jts.truncated))


def test_step_from_carried_state_matches_jax():
    """A mid-episode JAX state carried across by interop steps identically."""
    jp, tp = _params("default_topology", True, 1.0, 30)
    acts, dems = _streams(jp.topology, 4, 8, seed=5)
    jstep = jax.jit(jax.vmap(lambda s, a, d: jnet.step_with_demand(jp, s, a, d)))
    js, _ = jax.vmap(lambda _: jnet.reset(jp))(jnp.arange(4))
    for t in range(7):
        js, _ = jstep(js, jnp.asarray(acts[t]), jnp.asarray(dems[t]))
    ts = interop.net_state_from_numpy(js.X, js.Y, js.U, js.r_hist, js.period, CPU)
    js, jts = jstep(js, jnp.asarray(acts[7]), jnp.asarray(dems[7]))
    ts, tts = tnet.step_with_demand(tp, ts, torch.from_numpy(acts[7]),
                                    torch.from_numpy(dems[7]))
    np.testing.assert_array_equal(ts.X.numpy(), np.asarray(js.X))
    np.testing.assert_allclose(tts.reward.numpy(), np.asarray(jts.reward),
                               atol=1e-3, rtol=1e-5)


def _parity_episode(seed, action_value, params):
    T = params.topology
    demands = tparity.net_inv_demand_stream(
        tparity.reference_rng(seed), T.retail_dist_params(), params.num_periods)
    state, _ = tnet.reset(params, device=CPU)
    action = torch.full((1, T.n_reorder), action_value)
    total = 0.0
    for t in range(params.num_periods):
        state, ts = tnet.step_with_demand(
            params, state, action, torch.tensor(demands[t][None], dtype=torch.float32))
        total += float(ts.reward[0])
    return total


def test_golden_default_backlog():
    total = _parity_episode(42, 20.0, tnet.default_params(num_periods=30))
    assert abs(total - 22.19) < 0.5, total


def test_golden_custom_lost_sales():
    # backlog=True on purpose: the reference's LostSales subclass runs with
    # backlog on (tests/test_net_inv_management.py explains the quirk)
    params = tnet.default_params(topology=ttopo.custom_topology(40),
                                 num_periods=40, backlog=True)
    total = _parity_episode(42, 20.0, params)
    assert abs(total - 38561.60) < 2.0, total


def _pmf(spec, k):
    name = spec[0]
    if name == "poisson":
        return stats.poisson(spec[1]).pmf(k)
    if name == "binomial":
        return stats.binom(int(spec[1]), spec[2]).pmf(k)
    if name == "negbinomial":
        return stats.nbinom(spec[1], spec[2]).pmf(k)
    if name == "randint":
        return stats.randint(int(spec[1]), int(spec[2])).pmf(k)
    if name == "geometric":
        return stats.geom(spec[1]).pmf(k)
    loc, scale = spec[1], spec[2]   # normal, rounded and clamped at 0
    upper = stats.norm.cdf((k + 0.5 - loc) / scale)
    lower = np.where(k == 0, 0.0, stats.norm.cdf((k - 0.5 - loc) / scale))
    return upper - lower


@pytest.mark.parametrize("spec", [
    ("poisson", 20.0), ("binomial", 40, 0.3), ("negbinomial", 5, 0.4),
    ("randint", 3, 11), ("geometric", 0.25), ("normal", 20.0, 4.0)],
    ids=lambda s: s[0])
def test_sample_demand_goodness_of_fit(spec):
    T = dataclasses.replace(ttopo.default_topology(5), rt_demand=(spec,))
    params = tnet.NetInvParams(topology=T, num_periods=5)
    n = 40_000
    g = torch.Generator().manual_seed(11)
    d = tnet.sample_demand(params, g, 0, n, device=CPU)[:, 0].numpy().astype(np.int64)
    ks = np.arange(0, d.max() + 1)
    expected = _pmf(spec, ks) * n
    observed = np.bincount(d, minlength=len(ks)).astype(float)
    # pool into bins of expected count >= 5; the last bin takes the tail
    bins_o, bins_e, acc_o, acc_e = [], [], 0.0, 0.0
    for o, e in zip(observed, expected):
        acc_o, acc_e = acc_o + o, acc_e + e
        if acc_e >= 5:
            bins_o.append(acc_o)
            bins_e.append(acc_e)
            acc_o = acc_e = 0.0
    bins_o[-1] += acc_o
    bins_e[-1] += acc_e + (n - expected.sum())
    assert len(bins_o) >= 5
    p = stats.chisquare(bins_o, bins_e).pvalue
    assert p > 1e-4, (spec, p)


def test_sample_demand_user_zero_and_hostfn():
    T = ttopo.default_topology(3)
    user = dataclasses.replace(T, rt_demand=(("user", (3.0, 1.0, 4.0)),))
    params = tnet.NetInvParams(topology=user, num_periods=3)
    g = torch.Generator().manual_seed(0)
    period = torch.tensor([0, 1, 2, 7])
    d = tnet.sample_demand(params, g, period, 4, device=CPU)
    assert d[:, 0].tolist() == [3.0, 1.0, 4.0, 4.0]
    zero = tnet.NetInvParams(topology=dataclasses.replace(T, rt_demand=(("zero",),)),
                             num_periods=3)
    assert tnet.sample_demand(zero, g, 0, 5, device=CPU).abs().sum() == 0
    hostfn = dataclasses.replace(T, rt_demand=(("hostfn", lambda **kw: 1, ()),))
    with pytest.raises(NotImplementedError) as mine:
        tnet.sample_demand(tnet.NetInvParams(topology=hostfn, num_periods=3), g, 0, 2,
                           device=CPU)
    jhostfn = dataclasses.replace(jtopo.default_topology(3),
                                  rt_demand=(("hostfn", lambda **kw: 1, ()),))
    with pytest.raises(NotImplementedError) as ref:
        jnet.sample_demand(jnet.NetInvParams(topology=jhostfn, num_periods=3),
                           jax.random.PRNGKey(0), 0)
    assert str(mine.value) == str(ref.value)


def test_spaces_match_jax():
    for backlog in (True, False):
        jp, tp = _params("default_topology", backlog, 1.0, 30)
        for fn in ("observation_space", "action_space"):
            a, b = getattr(tnet, fn)(tp), getattr(jnet, fn)(jp)
            np.testing.assert_array_equal(a.low, b.low)
            np.testing.assert_array_equal(a.high, b.high)
    space = tnet.action_space(tp)
    g = torch.Generator().manual_seed(0)
    x = space.sample(g, (1000,), device=CPU)
    assert x.shape == (1000, 11) and x.min() >= 0 and x.max() < 1700
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(x, space.sample(g2, (1000,), device=CPU))


def test_rollout_auto_resets_at_the_horizon():
    tp = tnet.default_params(num_periods=5)
    space = tnet.action_space(tp)
    g = torch.Generator().manual_seed(1)
    policy = lambda _s, obs, gen, _t: space.sample(gen, (obs.shape[0],), device=CPU)
    (state, obs), traj = vecenv.rollout(tnet.ENV, tp, policy, None, g, 6, 7,
                                        device=CPU)
    assert traj.reward.shape == (7, 6) and traj.obs.shape == (7, 6, 68)
    assert traj.done[4].all() and not traj.done[:4].any()
    fresh = tnet.reset(tp, batch=6, device=CPU)[1].obs
    assert torch.equal(traj.obs[5], fresh)
    assert state.period.tolist() == [2] * 6
    totals, etraj = vecenv.evaluate_episodes(tnet.ENV, tp, policy, None, g, 6,
                                             device=CPU)
    assert totals.shape == (6,) and torch.allclose(totals, etraj.reward.sum(0))
