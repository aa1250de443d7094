"""The port's InvManagement env (envs/inv_management.py) against the JAX
package's, and ``core.config.apply_env_config``.

Both envs get the same action and demand streams, made with numpy from a
seed; the JAX step runs vmapped under ``lax.scan`` on the CPU. Tolerances:
the int32 state, the observation and every int32 info field exactly;
rewards ``rtol=1e-5`` (f32 ``pow`` and a four-element sum in another
order); the seed-42 goldens within 0.5, as tests/test_inv_management.py
holds JAX to them; ``sample_demand`` by a chi-squared test per dist mode at
p > 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from or_gym_inventory_torch.core import config as tconfig
from or_gym_inventory_torch.core import parity as tparity
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.core import config as jconfig
from or_gym_inventory_tpu.envs import inv_management as jim

CPU = "cpu"
STEPS, B = 12, 16
INT_INFO = ("demand_realized", "sales", "unfulfilled", "ending_inventory",
            "backlog_start_of_next", "fulfilled_orders", "requested_orders")


def _params(**kw):
    jp = jim.default_params(**kw)
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


def _streams(params, seed):
    """Actions beyond both ends of [0, c] and Poisson demand, (T, B, m1) and
    (T, B) int32."""
    r = np.random.default_rng(seed)
    hi = np.asarray(params.c)[None, None, :] + 40
    acts = r.integers(-10, hi, (STEPS, B, params.m1)).astype(np.int32)
    dems = r.poisson(25.0, (STEPS, B)).astype(np.int32)
    return acts, dems


def _jax_chain(jp, acts, dems):
    """Per step: the JAX state's fields, obs, reward and int info, stacked."""
    @jax.jit
    def run(acts, dems):
        state = jax.vmap(lambda _: jim.reset(jp)[0])(jnp.arange(B))

        def body(state, ad):
            state, ts = jax.vmap(jim.step_with_demand, in_axes=(None, 0, 0, 0))(
                jp, state, ad[0], ad[1])
            info = {k: ts.info[k] for k in INT_INFO}
            return state, (dataclasses.asdict(state), ts.obs, ts.reward, info)

        return jax.lax.scan(body, state, (acts, dems))[1]

    return jax.tree_util.tree_map(np.asarray, run(jnp.asarray(acts), jnp.asarray(dems)))


@pytest.mark.parametrize("backlog", [True, False], ids=["backlog", "lost_sales"])
@pytest.mark.parametrize("L", [(1, 5, 10), (0, 5, 10)], ids=["L1-5-10", "L0-5-10"])
def test_step_with_demand_matches_jax(backlog, L):
    jp, tp = _params(backlog=backlog, L=L, periods=STEPS)
    acts, dems = _streams(tp, 7)
    states, obs, rew, info = _jax_chain(jp, acts, dems)
    state, ts = tim.reset(tp, batch=B, device=CPU)
    np.testing.assert_array_equal(ts.obs.numpy(),
                                  np.asarray(jax.vmap(lambda _: jim.reset(jp)[1].obs)(
                                      jnp.arange(B))))
    for t in range(STEPS):
        state, ts = tim.step_with_demand(tp, state, torch.from_numpy(acts[t]),
                                         torch.from_numpy(dems[t]))
        for f in ("inv", "backlog_v", "action_hist", "r_hist", "period"):
            got = getattr(state, f)
            assert got.dtype == torch.int32, f
            np.testing.assert_array_equal(got.numpy(), states[f][t], err_msg=f"{f}[{t}]")
        np.testing.assert_array_equal(ts.obs.numpy(), obs[t], err_msg=f"obs[{t}]")
        np.testing.assert_allclose(ts.reward.numpy(), rew[t], rtol=1e-5, err_msg=f"reward[{t}]")
        for k in INT_INFO:
            np.testing.assert_array_equal(ts.info[k].numpy(), info[k][t], err_msg=f"{k}[{t}]")
        assert bool(ts.truncated.all()) == (t == STEPS - 1)


@pytest.mark.parametrize("backlog,golden", [(True, 4700.7806), (False, 4796.0254)],
                         ids=["backlog", "lost_sales"])
def test_golden_seed42(backlog, golden):
    """tests/test_inv_management.py:12-41 through the port's own parity
    module: seed 42, action (20, 20, 20), 30 periods."""
    params = tim.default_params(backlog=backlog)
    demands = tparity.inv_management_demand_stream(
        tparity.reference_rng(42), params.dist, params.dist_param_dict, params.periods,
        params.user_D)
    assert list(demands[:5]) == [24, 14, 18, 22, 19]
    state, _ = tim.reset(params, device=CPU)
    total = 0.0
    for t in range(params.periods):
        state, ts = tim.step_with_demand(params, state, torch.tensor([[20, 20, 20]]),
                                         torch.tensor([int(demands[t])]))
        total += float(ts.reward[0])
    assert abs(total - golden) < 0.5, total


def test_obs_packs_orders_at_the_front():
    """At t < lt_max the reference packs past orders at the FRONT of the
    pipeline block, zero-padded at the end (inventory_management.py:377-383)."""
    params = tim.default_params(L=(1, 2, 3))
    state, _ = tim.reset(params, device=CPU)
    state, ts = tim.step_with_demand(params, state, torch.tensor([[5, 6, 7]]),
                                     torch.tensor([0]))
    assert ts.obs[0, 3:].tolist() == [5, 6, 7] + [0] * 6
    state, ts = tim.step_with_demand(params, state, torch.tensor([[8.9, 9.2, -3.0]]),
                                     torch.tensor([0]))
    assert ts.obs[0, 3:].tolist() == [5, 6, 7, 8, 9, 0, 0, 0, 0]


@pytest.mark.parametrize("L", [(1, 5, 10), (0, 0, 0)])
def test_assemble_obs_from_streams_matches_jax(L):
    jp, tp = _params(L=L, periods=STEPS)
    r = np.random.default_rng(3)
    inv = r.integers(-50, 300, (STEPS + 1, tp.m1, B)).astype(np.int32)
    acts = r.integers(-20, 250, (STEPS, tp.m1, B)).astype(np.int32)
    got = tim.assemble_obs_from_streams(tp, torch.from_numpy(inv), torch.from_numpy(acts))
    want = np.asarray(jim.assemble_obs_from_streams(jp, jnp.asarray(inv), jnp.asarray(acts)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


CONFIGS = [
    dict(),
    dict(backlog=False),
    dict(env_config={"periods": 50, "I0": [10, 20], "r": [1, 2, 3], "k": [0, 0, 0],
                     "h": [1, 1], "c": [5, 6], "L": [0, 3]}),
    dict(env_config={"dist": 2, "dist_param": {"n": 40, "p": 0.5}}),
    dict(dist=3, dist_param={"low": 5, "high": 15}, alpha=1.0),
    dict(dist=4, dist_param={"p": 0.2}),
    dict(dist=5, periods=3, user_D=[4, 5, 6]),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_params_and_spaces_match_jax(kw):
    jp = jim.default_params(**kw)
    tp = tim.default_params(**kw)
    for f in dataclasses.fields(tp):
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    for prop in ("num_stages", "m1", "lt_max", "pipeline_length", "horizon",
                 "dist_param_dict", "obs_bound"):
        assert getattr(tp, prop) == getattr(jp, prop), prop
    for prop in ("unit_price", "unit_cost", "holding_cost_vec"):
        np.testing.assert_array_equal(getattr(tp, prop), getattr(jp, prop))
    for space in ("observation_space", "action_space"):
        a, b = getattr(tim, space)(tp), getattr(jim, space)(jp)
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
        assert a.dtype == b.dtype
    hash(tp)


BAD = [dict(I0=(-1, 0, 0)), dict(periods=0), dict(c=(0, 1, 1)), dict(L=(-1, 1, 1)),
       dict(h=(1.0,)), dict(dist=9), dict(dist=5, user_D=(1, 2)),
       dict(dist_param={"lam": 3}), dict(dist=2, dist_param={"n": 2.5, "p": 0.5}),
       dict(dist=3, dist_param={"low": 9, "high": 2}), dict(alpha=0.0),
       dict(env_config={"nonsense": 1})]


@pytest.mark.parametrize("kw", BAD, ids=range(len(BAD)))
def test_validate_raises_as_jax_does(kw):
    with pytest.raises((AssertionError, KeyError)) as want:
        jim.default_params(**kw)
    with pytest.raises(want.type) as got:
        tim.default_params(**kw)
    assert str(got.value) == str(want.value)


def test_apply_env_config_matches_jax():
    @dataclasses.dataclass(frozen=True)
    class P:
        num_periods: int = 3
        alpha: float = 1.0

    for cfg, aliases in (({"periods": 9}, {"periods": "num_periods"}), (None, None),
                         ({"alpha": 0.5, "num_periods": 4}, None)):
        assert tconfig.apply_env_config(P(), cfg, aliases) == \
            jconfig.apply_env_config(P(), cfg, aliases)
    with pytest.raises(KeyError, match="valid keys"):
        tconfig.apply_env_config(P(), {"gamma": 1.0})


def test_state_from_jax_continues_the_chain():
    """A JAX state carried across mid-episode steps on like the port's own."""
    jp, tp = _params(periods=STEPS)
    acts, dems = _streams(tp, 11)
    jstate = jax.vmap(lambda _: jim.reset(jp)[0])(jnp.arange(B))
    step = jax.jit(jax.vmap(jim.step_with_demand, in_axes=(None, 0, 0, 0)),
                   static_argnums=0)
    for t in range(4):
        jstate, _ = step(jp, jstate, jnp.asarray(acts[t]), jnp.asarray(dems[t]))
    tstate = interop.im_state_from_numpy(*(np.asarray(getattr(jstate, f)) for f in (
        "inv", "backlog_v", "action_hist", "r_hist", "period")), device=CPU)
    jstate, jts = step(jp, jstate, jnp.asarray(acts[4]), jnp.asarray(dems[4]))
    tstate, tts = tim.step_with_demand(tp, tstate, torch.from_numpy(acts[4]),
                                       torch.from_numpy(dems[4]))
    np.testing.assert_array_equal(tts.obs.numpy(), np.asarray(jts.obs))
    np.testing.assert_array_equal(tstate.inv.numpy(), np.asarray(jstate.inv))


LAWS = [
    (dict(), lambda k: stats.poisson.pmf(k, 20)),
    (dict(dist=2, dist_param={"n": 30, "p": 0.4}), lambda k: stats.binom.pmf(k, 30, 0.4)),
    (dict(dist=3, dist_param={"low": 3, "high": 17}), lambda k: stats.randint.pmf(k, 3, 18)),
    (dict(dist=4, dist_param={"p": 0.3}), lambda k: stats.geom.pmf(k, 0.3)),
]


def chi2_pvalue(draws, pmf):
    """Chi-squared goodness of fit of integer ``draws`` to ``pmf``, the
    support binned so that every expected count is at least 5."""
    n = draws.size
    lo, hi = int(draws.min()), int(draws.max())
    ks = np.arange(lo, hi + 1)
    obs = np.bincount(draws - lo, minlength=ks.size).astype(float)
    exp = pmf(ks) * n
    # fold the tails outside [lo, hi] into the end bins, then merge sparse bins
    exp[0] += n * sum(pmf(np.arange(min(lo, 0) - 50, lo)))
    exp[-1] = n - exp[:-1].sum()
    o_bins, e_bins, o_acc, e_acc = [], [], 0.0, 0.0
    for o, e in zip(obs, exp):
        o_acc, e_acc = o_acc + o, e_acc + e
        if e_acc >= 5:
            o_bins.append(o_acc)
            e_bins.append(e_acc)
            o_acc = e_acc = 0.0
    o_bins[-1] += o_acc
    e_bins[-1] += e_acc
    return stats.chisquare(o_bins, np.asarray(e_bins) * sum(o_bins) / sum(e_bins)).pvalue


@pytest.mark.parametrize("kw,pmf", LAWS, ids=["poisson", "binomial", "randint", "geometric"])
def test_step_draws_each_dist_mode_from_its_law(kw, pmf):
    params = tim.default_params(**kw)
    d = tim.sample_demand(params, torch.Generator().manual_seed(1), 0, 40_000, device=CPU)
    assert d.dtype == torch.int32
    assert chi2_pvalue(d.numpy().astype(np.int64), pmf) > 1e-4


def test_step_user_mode_and_wide_laws():
    params = tim.default_params(dist=5, periods=4, user_D=[3, 0, 9, 2])
    state, _ = tim.reset(params, batch=5, device=CPU)
    g = torch.Generator().manual_seed(0)
    seen = []
    for _ in range(4):
        state, ts = tim.step(params, state, torch.zeros(5, 3, dtype=torch.int32), g)
        seen.append(ts.info["demand_realized"].tolist())
    assert seen == [[3] * 5, [0] * 5, [9] * 5, [2] * 5]
    wide = tim.default_params(dist_param={"mu": 50_000})
    d = tim.sample_demand(wide, torch.Generator().manual_seed(0), 3, 20_000, device=CPU)
    assert abs(float(d.double().mean()) - 50_000) < 5 * np.sqrt(50_000 / 20_000)
