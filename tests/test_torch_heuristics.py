"""The port's demand samplers, Poisson quantile and heuristic roster
(``ops/distributions.py``, ``agents/heuristics.py``) against the JAX
package's and SciPy.

- The named samplers pass the moment and goodness-of-fit checks of
  tests/test_distributions.py at its sizes (200,000 draws), and their means
  agree with the JAX samplers' within 5 standard errors; ``sample_from_law``
  draws bit for bit what its body drew before it called them.
- ``poisson_cdf`` within ``1e-6`` of SciPy's exact CDF, and of JAX's beyond
  JAX's own f32 error (up to 1.2e-4); ``poisson_ppf`` exactly
  against ``scipy.stats.poisson.ppf`` on JAX's test grids and 20,000 random
  points a mu band up to 16,000, and equal to JAX's wherever JAX's equals
  SciPy.
- The host forms equal JAX's host forms on JAX's own ``envs.adapters`` envs,
  and on the port's ``envs.adapters`` envs, action for action over 10
  periods; the device forms equal JAX's device
  forms on the same obs exactly, and their own host forms as
  tests/test_heuristics.py holds JAX's (Newsvendor within one unit: the
  host computes in float64, the device in f32).
- Over 2,048 seeds, one heuristic a family, the mean return through the
  port's ``evaluate_episodes_seeded`` is within 4 standard errors of JAX's
  seeded evaluator with JAX's heuristic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from or_gym_inventory_torch.agents import heuristics as TH
from or_gym_inventory_torch.envs import adapters as tad
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import distributions as TD
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import evaluate_episodes_seeded
from or_gym_inventory_tpu.agents import heuristics as JH
from or_gym_inventory_tpu.envs import adapters as ad
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.ops import distributions as JD
from or_gym_inventory_tpu.vector import vecenv as jvecenv
from test_distributions import N, _chi2_poisson
from test_torch_ppo_xla import _family
from test_torch_seeded_eval import _mean_se

CPU = "cpu"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _means_agree(port, jax_draws):
    (m1, s1), (m2, s2) = _mean_se(port), _mean_se(jax_draws)
    assert abs(m1 - m2) <= 5 * np.hypot(s1, s2), (m1, m2, s1, s2)


# ------------------------------------------------------------------ samplers

@pytest.mark.parametrize("lam", [0.5, 5.0, 20.0, 200.0])
def test_poisson_sampler_distribution(lam):
    s = TD.sample_poisson(_gen(int(lam * 7)), lam, (N,)).numpy()
    assert s.dtype == np.int32
    assert abs(s.mean() - lam) < 4 * np.sqrt(lam / N) + 0.02
    assert abs(s.var() - lam) < 0.05 * lam + 0.1
    assert _chi2_poisson(s, lam) > 1e-4
    _means_agree(s, np.asarray(JD.sample_poisson(jax.random.PRNGKey(int(lam * 7)), lam, (N,))))


def test_binomial_randint_geometric_samplers():
    n, p = 50, 0.3
    s = TD.sample_binomial(_gen(1), n, p, (N,)).numpy()
    assert abs(s.mean() - n * p) < 0.1 and abs(s.var() - n * p * (1 - p)) < 0.3
    assert s.min() >= 0 and s.max() <= n and s.dtype == np.int32
    _means_agree(s, np.asarray(JD.sample_binomial(jax.random.PRNGKey(1), n, p, (N,))))
    s = TD.sample_randint(_gen(2), 10, 20, (N,)).numpy()
    assert s.min() == 10 and s.max() == 20           # inclusive bounds
    assert stats.chisquare(np.bincount(s - 10, minlength=11))[1] > 1e-4
    _means_agree(s, np.asarray(JD.sample_randint(jax.random.PRNGKey(2), 10, 20, (N,))))
    p = 0.25
    s = TD.sample_geometric(_gen(3), p, (N,)).numpy()
    assert s.min() >= 1                              # the number of trials
    assert abs(s.mean() - 1 / p) < 0.05 and abs(s.var() - (1 - p) / p ** 2) < 0.5
    _means_agree(s, np.asarray(JD.sample_geometric(jax.random.PRNGKey(3), p, (N,))))


def test_negbinomial_and_normal_rounded_samplers():
    n, p = 8, 0.35
    s = TD.sample_negbinomial(_gen(4), n, p, (N,)).numpy()
    mean, var = n * (1 - p) / p, n * (1 - p) / p ** 2
    assert abs(s.mean() - mean) < 4 * np.sqrt(var / N) + 0.05 and abs(s.var() - var) / var < 0.05
    hi = int(mean + 6 * np.sqrt(var))
    ks = np.arange(hi)
    probs = np.concatenate([stats.nbinom.pmf(ks, n, p), [1 - stats.nbinom.cdf(hi - 1, n, p)]])
    counts = np.concatenate([[np.sum(s == k) for k in ks], [np.sum(s >= hi)]])
    mask = probs * N >= 5
    assert stats.chisquare(counts[mask], probs[mask] / probs[mask].sum()
                           * counts[mask].sum())[1] > 1e-4
    _means_agree(s, np.asarray(JD.sample_negbinomial(jax.random.PRNGKey(4), n, p, (N,))))
    loc, scale = 20.0, 5.0
    s = TD.sample_normal_rounded(_gen(5), loc, scale, (N,)).numpy()
    assert s.min() >= 0 and abs(s.mean() - loc) < 0.1
    ks = np.arange(1, 45)
    probs = stats.norm.cdf(ks + 0.5, loc, scale) - stats.norm.cdf(ks - 0.5, loc, scale)
    probs = np.concatenate([[stats.norm.cdf(0.5, loc, scale)], probs,
                            [1 - stats.norm.cdf(44.5, loc, scale)]])
    counts = np.concatenate([[np.sum(s == 0)], [np.sum(s == k) for k in ks],
                             [np.sum(s >= 45)]])
    mask = probs * N >= 5
    assert stats.chisquare(counts[mask], probs[mask] / probs[mask].sum()
                           * counts[mask].sum())[1] > 1e-4
    _means_agree(s, np.asarray(JD.sample_normal_rounded(jax.random.PRNGKey(5), loc, scale,
                                                        (N,))))
    # half-even rounding: 2.5 -> 2, 3.5 -> 4, below 0 -> 0
    g = torch.Generator().manual_seed(0)
    assert TD.sample_normal_rounded(g, 2.5, 0.0, 3).tolist() == [2, 2, 2]
    assert TD.sample_normal_rounded(g, 3.5, 0.0, 1).tolist() == [4]
    assert TD.sample_normal_rounded(g, -3.0, 0.0, 1).tolist() == [0]


MODES = [(TD.POISSON, {"mu": 20}, 20.0), (TD.BINOMIAL, {"n": 40, "p": .4}, 16.0),
         (TD.RANDINT, {"low": 5, "high": 15}, 10.0), (TD.GEOMETRIC, {"p": 0.3}, 1 / 0.3)]


@pytest.mark.parametrize("dist,param,mean", MODES)
def test_make_demand_sampler_modes(dist, param, mean):
    sampler = TD.make_demand_sampler(dist, param)
    d = sampler(_gen(0), 0, 20_000, CPU)
    assert d.shape == (20_000,) and d.dtype == torch.int32 and (d >= 0).all()
    assert abs(float(d.double().mean()) - mean) < 0.1 * mean
    jsampler = JD.make_demand_sampler(dist, param)
    jd = np.asarray(jax.vmap(lambda k: jsampler(k, 0))(jax.random.split(jax.random.PRNGKey(0),
                                                                         20_000)))
    _means_agree(d.numpy(), jd)


def test_make_demand_sampler_user_mode():
    sampler = TD.make_demand_sampler(TD.USER, {}, user_D=[3, 1, 4, 1, 5])
    jsampler = JD.make_demand_sampler(JD.USER, {}, user_D=[3, 1, 4, 1, 5])
    for t in range(9):   # past the end -> 0 (reference inventory_management.py:182)
        want = int(jsampler(jax.random.PRNGKey(0), jnp.asarray(t)))
        assert sampler(_gen(0), t, 4).tolist() == [want] * 4, t
        assert sampler(_gen(0), torch.tensor(t), 2).tolist() == [want] * 2
    assert [int(jsampler(jax.random.PRNGKey(0), jnp.asarray(t))) for t in range(6)] == \
        [3, 1, 4, 1, 5, 0]
    with pytest.raises(ValueError, match="Invalid distribution"):
        TD.make_demand_sampler(9, {})


def _sample_from_law_before(spec, generator, batch, dev):
    """sample_from_law's body before it called the named samplers."""
    f32 = dict(dtype=torch.float32, device=dev)
    tag = spec[0]
    if tag == "poisson":
        return torch.poisson(torch.full((batch,), float(spec[1]), **f32), generator=generator)
    if tag == "binomial":
        return torch.binomial(torch.full((batch,), float(spec[1]), **f32),
                              torch.full((batch,), float(spec[2]), **f32), generator=generator)
    if tag == "negbinomial":
        n, p = float(spec[1]), float(spec[2])
        lam = torch._standard_gamma(torch.full((batch,), n, **f32),
                                    generator=generator) * ((1.0 - p) / p)
        return torch.poisson(lam, generator=generator)
    if tag == "randint":
        return torch.randint(int(spec[1]), int(spec[2]), (batch,), generator=generator,
                             device=dev).to(torch.float32)
    if tag == "geometric":
        return torch.empty((batch,), **f32).geometric_(float(spec[1]), generator=generator)
    x = torch.normal(float(spec[1]), float(spec[2]), (batch,), generator=generator, **f32)
    return torch.clamp_min(torch.round(x), 0.0)


@pytest.mark.parametrize("spec", [("poisson", 20.0), ("poisson", 50_000.0),
                                  ("binomial", 40, 0.4), ("negbinomial", 8, 0.35),
                                  ("randint", 5, 16), ("geometric", 0.3), ("normal", 20.0, 5.0)])
def test_sample_from_law_draws_unchanged(spec):
    """Three calls on one generator: the same values and the same stream
    position as before, so every env draw and pinned golden stays."""
    g1, g2 = _gen(11), _gen(11)
    for _ in range(3):
        got = TD.sample_from_law(spec, g1, 1000, CPU)
        want = _sample_from_law_before(spec, g2, 1000, CPU)
        assert got.dtype == torch.float32 and torch.equal(got, want), spec
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    with pytest.raises(NotImplementedError):
        TD.sample_from_law(("hostfn", None), g1, 4, CPU)


# ------------------------------------------------------------------ quantile

def test_poisson_cdf_matches_jax():
    """Within 1e-6 of the exact CDF (SciPy's, float64) in f32, and of JAX's
    beyond JAX's own departure from it: JAX's f32 gammaincc is off by up
    to 1.2e-4 at mu 300 (7e-5 at mu 200), the port's by under 1e-6."""
    rng = np.random.default_rng(0)
    k = rng.uniform(-3.0, 300.0, 5000).astype(np.float32)
    mu = rng.uniform(0.1, 200.0, 5000).astype(np.float32)
    got = TD.poisson_cdf(torch.from_numpy(k), torch.from_numpy(mu))
    want = np.asarray(JD.poisson_cdf(jnp.asarray(k), jnp.asarray(mu)), np.float64)
    exact = stats.poisson.cdf(np.floor(k), mu.astype(np.float64))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-6)
    assert (np.abs(got.numpy() - want) <= 1e-6 + np.abs(want - exact)).all()
    assert float(TD.poisson_cdf(torch.tensor(-0.5), 3.0)) == 0.0
    got64 = TD.poisson_cdf(torch.from_numpy(k.astype(np.float64)), torch.from_numpy(mu))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), exact, rtol=0, atol=1e-9)


QS = np.array([0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.999, 0.833333, 0.6,
               0.3711], np.float32)


def test_poisson_ppf_exact_on_jax_grids():
    """tests/test_distributions.py:126-163 and tests/test_heuristics.py:20-36."""
    for mu in [0.5, 5, 20, 200, 500, 1200, 1440, 2000, 4000]:
        want = stats.poisson.ppf(QS.astype(np.float64), mu)
        got = TD.poisson_ppf(torch.from_numpy(QS), float(mu))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"mu={mu}")
    rng = np.random.default_rng(7)
    q = rng.uniform(0.001, 0.999, 500).astype(np.float32)
    mu = np.exp(rng.uniform(np.log(0.5), np.log(5000), 500)).astype(np.float32)
    np.testing.assert_array_equal(TD.poisson_ppf(torch.from_numpy(q), torch.from_numpy(mu)).numpy(),
                                  stats.poisson.ppf(q.astype(np.float64), mu.astype(np.float64)))
    for seed, (lo, hi) in ((0, (0.1, 500.0)), (1, (500.0, 2000.0))):
        rng = np.random.default_rng(seed)
        q, mu = rng.uniform(0.001, 0.999, 200), rng.uniform(lo, hi, 200)
        np.testing.assert_array_equal(TD.poisson_ppf(q, mu).numpy(),
                                      stats.poisson.ppf(q.astype(np.float32).astype(np.float64),
                                                        mu.astype(np.float32).astype(np.float64)))
    # broadcasting: vector q with a scalar mu, and a scalar q with vector mu
    np.testing.assert_array_equal(TD.poisson_ppf(torch.tensor([0.1, 0.5, 0.9]), 20.0).numpy(),
                                  stats.poisson.ppf(np.float32([0.1, 0.5, 0.9]).astype(np.float64),
                                                    20.0))
    np.testing.assert_array_equal(TD.poisson_ppf(0.9, torch.tensor([5.0, 50.0, 500.0])).numpy(),
                                  stats.poisson.ppf(0.9, np.array([5.0, 50.0, 500.0])))


@pytest.mark.parametrize("band", [(0.1, 50.0), (50.0, 500.0), (500.0, 2000.0),
                                  (2000.0, 16000.0)])
def test_poisson_ppf_exact_on_random_bands(band):
    rng = np.random.default_rng(int(band[0] * 10))
    q = rng.uniform(0.001, 0.999, 20_000).astype(np.float32)
    mu = rng.uniform(*band, 20_000).astype(np.float32)
    got = TD.poisson_ppf(torch.from_numpy(q), torch.from_numpy(mu)).numpy()
    want = stats.poisson.ppf(q.astype(np.float64), mu.astype(np.float64))
    np.testing.assert_array_equal(got, want)
    # equal to JAX's wherever JAX's equals SciPy (JAX's f32 misses past mu 2,000)
    jgot = np.asarray(JD.poisson_ppf(jnp.asarray(q[:1000]), jnp.asarray(mu[:1000])))
    agree = jgot == want[:1000]
    assert agree.mean() > 0.99
    np.testing.assert_array_equal(got[:1000][agree], jgot[agree])


def test_poisson_ppf_edges():
    """JAX's edge rules: q <= 0 gives 0, q >= 1 gives max_k; a vanishing mu 0."""
    got = TD.poisson_ppf(torch.tensor([0.0, -0.5, 1.0, 1.5, 0.5]),
                         torch.tensor([10.0, 10.0, 10.0, 10.0, 1e-6]))
    assert got.tolist() == [0.0, 0.0, float(1 << 22), float(1 << 22), 0.0]
    want = np.asarray(JD.poisson_ppf(jnp.asarray([0.0, 1.0, 0.5]), jnp.asarray([10.0, 10.0, 1e-6])))
    assert TD.poisson_ppf(torch.tensor([0.0, 1.0, 0.5]),
                          torch.tensor([10.0, 10.0, 1e-6])).tolist() == want.tolist()
    assert float(TD.poisson_ppf(1.0, 5.0, max_k=1000)) == 1000.0


# ------------------------------------------------------------ the roster

NV_PAIRS = [(JH.OrderUpToHeuristicAgent(1.0), TH.OrderUpToHeuristicAgent(1.0)),
            (JH.OrderUpToHeuristicAgent(0.8), TH.OrderUpToHeuristicAgent(0.8)),
            (JH.OrderUpToHeuristicAgent(1.2), TH.OrderUpToHeuristicAgent(1.2)),
            (JH.ClassicNewsvendorAgent("k_vs_h", 1.0), TH.ClassicNewsvendorAgent("k_vs_h", 1.0)),
            (JH.ClassicNewsvendorAgent("profit_margin", 1.2),
             TH.ClassicNewsvendorAgent("profit_margin", 1.2)),
            (JH.sSPolicyAgent(0.5, 1.2), TH.sSPolicyAgent(0.5, 1.2))]
IM_PAIRS = [(JH.BaseStockAgent(sf), TH.BaseStockAgent(sf)) for sf in (0.8, 1.0, 1.2)]
NET_PAIRS = [(JH.ConstantOrderAgent(f), TH.ConstantOrderAgent(f)) for f in (0.05, 0.1)]


def _nv_params():
    jp = jnv.default_params()
    return jp, tnv.NewsvendorParams(**dataclasses.asdict(jp))


def _im_params():
    jp = jim.default_params()
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


def _net_params():
    jp = jnet.default_params()
    return jp, interop.net_params_from_numpy(dataclasses.asdict(jp.topology), jp.num_periods,
                                             jp.backlog, jp.alpha)


def _host_episode(make_env, jagent, tagent, seed, periods=10):
    """Both host forms on one adapter env (JAX's or the port's), stepped on
    JAX's actions: (obs list, port actions, JAX actions)."""
    env = make_env()
    obs, _ = env.reset(seed=seed)
    rows, got, want = [], [], []
    for _ in range(periods):
        a_j = jagent.get_action(obs, env)
        a_t = tagent.get_action(obs, env)
        rows.append((np.array(obs), int(getattr(env, "period", 0))))
        got.append(a_t)
        want.append(a_j)
        obs, *_ = env.step(a_j)
    return rows, got, want


@pytest.mark.parametrize("pair", range(len(NV_PAIRS) + len(IM_PAIRS) + len(NET_PAIRS)))
def test_host_forms_equal_jax(pair):
    jagent, tagent = (NV_PAIRS + IM_PAIRS + NET_PAIRS)[pair]
    assert tagent.name == jagent.name
    make_env = (ad.NewsvendorEnv if pair < len(NV_PAIRS) else
                ad.InvManagementBacklogEnv if pair < len(NV_PAIRS) + len(IM_PAIRS) else
                (lambda: ad.NetInvMgmtBacklogEnv(num_periods=10)))
    for seed in (3, 4):
        _, got, want = _host_episode(make_env, jagent, tagent, seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pair", range(len(NV_PAIRS) + len(IM_PAIRS) + len(NET_PAIRS)))
def test_host_forms_equal_jax_on_port_adapters(pair):
    """The same as ``test_host_forms_equal_jax`` on the port's adapters."""
    jagent, tagent = (NV_PAIRS + IM_PAIRS + NET_PAIRS)[pair]
    make_env = (tad.NewsvendorEnv if pair < len(NV_PAIRS) else
                tad.InvManagementBacklogEnv if pair < len(NV_PAIRS) + len(IM_PAIRS) else
                (lambda: tad.NetInvMgmtBacklogEnv(num_periods=10)))
    for seed in (3, 4):
        _, got, want = _host_episode(make_env, jagent, tagent, seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_host_form_quirks(capsys):
    """BaseStock's warning and random action on an env without its
    attributes; ConstantOrder's inf -> 1000; sS's vestigial s_quantile."""
    class Bare:
        action_space = ad.InvManagementBacklogEnv().action_space

    a = TH.BaseStockAgent().get_action(np.zeros(33), Bare())
    assert "Warning: Env missing attributes" in capsys.readouterr().out
    assert a.shape == Bare.action_space.shape and Bare.action_space.contains(a)

    class InfBox:
        class action_space:
            high = np.array([10.0, np.inf], np.float32)
            dtype = np.float32

    np.testing.assert_array_equal(TH.ConstantOrderAgent(0.1).get_action(None, InfBox()),
                                  np.float32([1.0, 100.0]))
    env = ad.NewsvendorEnv()
    obs, _ = env.reset(seed=5)
    assert np.array_equal(TH.sSPolicyAgent(0.1).get_action(obs, env),
                          TH.sSPolicyAgent(0.9).get_action(obs, env))
    assert TH.sSPolicyAgent(0.1).name != TH.sSPolicyAgent(0.9).name


def _nv_obs():
    """Obs of the heuristics' range: two JAX adapter episodes per Newsvendor
    heuristic, and random obs with mu(L+1)SF up to 1,440 and degenerate
    costs."""
    rows = [r for ja, ta in NV_PAIRS for s in (3, 11)
            for r, _ in _host_episode(ad.NewsvendorEnv, ja, ta, s)[0]]
    rng = np.random.default_rng(0)
    B = 4096
    econ = np.stack([rng.uniform(0, 100, B), rng.uniform(0, 100, B), rng.uniform(0, 5, B),
                     rng.uniform(0, 10, B), rng.uniform(0, 200, B)], 1)
    econ[:64, 2:4] = 0.0                               # h = k = 0: the fallback
    econ[64:128, 1] = econ[64:128, 0] + econ[64:128, 3] + 1.0   # a negative underage
    pipe = rng.uniform(0, 600, (B, 5)) * (rng.random((B, 5)) < 0.7)
    return np.concatenate([np.stack(rows), np.concatenate([econ, pipe], 1)]).astype(np.float32)


@pytest.mark.parametrize("pair", range(len(NV_PAIRS)))
def test_newsvendor_device_forms(pair):
    """Equal to JAX's device form on the same obs, exactly; within one unit
    of the port's host form over a JAX adapter episode (the host computes
    in float64, as tests/test_heuristics.py allows JAX's)."""
    jagent, tagent = NV_PAIRS[pair]
    jp, tp = _nv_params()
    obs = _nv_obs()
    want = np.asarray(jagent.device_policy(jnv.ENV, jp)(None, jnp.asarray(obs),
                                                        jax.random.PRNGKey(0), 0))
    tpolicy = tagent.device_policy(tnv.ENV, tp)
    got = tpolicy(None, torch.from_numpy(obs), None, 0)
    assert got.shape == (len(obs), 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    env = ad.NewsvendorEnv()
    o, _ = env.reset(seed=3)
    for t in range(10):
        a_host = tagent.get_action(o, env)
        a_dev = tpolicy(None, torch.from_numpy(np.asarray(o, np.float32))[None], None, t)[0]
        np.testing.assert_allclose(a_dev.numpy(), a_host, atol=1.001)
        o, *_ = env.step(a_host)


@pytest.mark.parametrize("sf", [0.8, 1.0, 1.2])
def test_base_stock_device_form(sf):
    """Equal to JAX's device form on the obs of JAX adapter episodes at every
    period (t an int or a 0-d tensor), and to the port's host form."""
    jagent, tagent = JH.BaseStockAgent(sf), TH.BaseStockAgent(sf)
    jp, tp = _im_params()
    jpolicy, tpolicy = jagent.device_policy(jim.ENV, jp), tagent.device_policy(tim.ENV, tp)
    for seed in (4, 9):
        env = ad.InvManagementBacklogEnv()
        obs, _ = env.reset(seed=seed)
        for t in range(15):
            a_host = tagent.get_action(obs, env)
            o = np.asarray(obs, np.int32)[None]
            want = np.asarray(jpolicy(None, jnp.asarray(o), jax.random.PRNGKey(0), jnp.asarray(t)))
            for tt in (t, torch.tensor(t)):
                got = tpolicy(None, torch.from_numpy(o), None, tt)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got[0].numpy(), a_host)
            obs, *_ = env.step(a_host)


@pytest.mark.parametrize("frac", [0.05, 0.1])
def test_constant_order_device_form(frac):
    jagent, tagent = JH.ConstantOrderAgent(frac), TH.ConstantOrderAgent(frac)
    jp, tp = _net_params()
    obs = np.zeros((5, tnet.ENV.observation_space(tp).shape[0]), np.float32)
    want = np.asarray(jagent.device_policy(jnet.ENV, jp)(None, jnp.asarray(obs), None, 0))
    got = tagent.device_policy(tnet.ENV, tp)(None, torch.from_numpy(obs), None, 0)
    np.testing.assert_array_equal(got.numpy(), want)
    env = ad.NetInvMgmtBacklogEnv()
    host, _ = env.reset(seed=0)
    np.testing.assert_array_equal(got[0].numpy(), tagent.get_action(host, env))


SEEDED = {"newsvendor": (JH.ClassicNewsvendorAgent("k_vs_h", 1.0),
                         TH.ClassicNewsvendorAgent("k_vs_h", 1.0)),
          "inv_management": (JH.BaseStockAgent(1.0), TH.BaseStockAgent(1.0)),
          "net_inv_management": (JH.ConstantOrderAgent(0.1), TH.ConstantOrderAgent(0.1))}


@pytest.mark.parametrize("family", list(SEEDED))
def test_seeded_returns_match_jax(family):
    """Over 2,048 seeds the port's seeded mean return is within 4 standard
    errors of JAX's seeded evaluator running JAX's heuristic."""
    jmod, tmod, jp, tp, _ = _family(family)
    jagent, tagent = SEEDED[family]
    n = 2048
    totals, _ = evaluate_episodes_seeded(tmod.ENV, tp, tagent.device_policy(tmod.ENV, tp), None,
                                         torch.arange(n), device=CPU)
    jtotals, _ = jvecenv.evaluate_episodes_seeded(jmod.ENV, jp, jagent.device_policy(jmod.ENV, jp),
                                                  None, np.arange(n, dtype=np.uint32))
    (m1, s1), (m2, s2) = _mean_se(totals.numpy()), _mean_se(np.asarray(jtotals))
    assert np.isfinite(m1) and abs(m1 - m2) <= 4 * np.hypot(s1, s2), (family, m1, m2, s1, s2)
