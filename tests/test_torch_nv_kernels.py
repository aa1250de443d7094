"""The Newsvendor kernels' plain PyTorch versions (ops/episode_kernels.py
K13-K17) and the Newsvendor branch of ``random_episode_returns`` against the
JAX package.

The JAX side runs on the CPU as its own tests run it: the Pallas stream-in
kernel ``episode_returns_nv`` in interpret mode (as
tests/test_pallas_episode_kernels.py:50 does), and the pure-jnp Poisson
inversion ``_nv_poisson_setup``/``_nv_poisson_invert`` that its in-kernel
draws share. The port's random streams come from its Philox generator, so
they are handed to JAX as NumPy arrays. Tolerances:

- returns against JAX's K13: ``rtol=1e-5, atol=1e-2``, as
  tests/test_pallas_episode_kernels.py:50-54 holds JAX's kernel to its chain
  (f32 sums; XLA may contract a product and a sum into an FMA);
- the inversion against JAX's on the same uniforms: the cutoff kc exactly;
  demands equal on at least 99.9% of draws and never more than 1 apart
  (torch's and XLA's log and exp may differ by an ulp); against the float64
  quantile within TestNvDynamicPoissonInversion's bounds (at most 1 apart,
  under 0.2% of draws off);
- the chain K16 = K14 = K13 _random = K13 on K17's streams, the batch and
  chunk independence: bit for bit (the same words and the same arithmetic in
  the same order);
- the draws: chi-squared tests at p > 1e-4;
- the port's random-policy mean against JAX's XLA path: within 4 standard
  errors of the difference.

Kernel-against-plain checks need the card; they are marked ``cuda`` and skip
without one (chip_smoke.py makes them at full width).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek
from or_gym_inventory_tpu.vector import fast_episodes as jfe

CPU = "cpu"
B = 128


def _params(**kw):
    jp = jnv.default_params(**kw)
    return jp, tnv.NewsvendorParams(**dataclasses.asdict(jp))


def _jax_k13(jp, econ, acts, dems):
    return np.asarray(jek.episode_returns_nv(
        jp, jnp.asarray(np.asarray(econ)), jnp.asarray(np.asarray(acts)),
        jnp.asarray(np.asarray(dems)), block=econ.shape[1], interpret=True))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("L", [5, 0])
@pytest.mark.parametrize("gamma", [1.0, 0.99])
def test_plain_k13_matches_jax_interpret(L, gamma):
    jp, tp = _params(step_limit=13, lead_time=L, gamma=gamma)
    r = np.random.default_rng(L)
    u = r.random((5, B)).astype(np.float32)
    econ = np.stack([np.asarray(x) for x in jek._nv_econ_from_uniforms(jp, jnp.asarray(u))])
    acts = r.uniform(-50.0, tp.max_order_quantity * 1.1, (tp.step_limit, B)).astype(np.float32)
    dems = r.poisson(econ[4], (tp.step_limit, B)).astype(np.float32)
    got = tek.episode_returns_nv(tp, _t(econ), _t(acts), _t(dems))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_k13(jp, econ, acts, dems),
                               rtol=1e-5, atol=1e-2)


MU_GRID = [0.0, 0.05, 0.7, 3.0, 20.0, 87.0, 130.0, 199.9]


def _f64_quantile(mu, u):
    """TestNvDynamicPoissonInversion._f64_quantile: #{k : F(k) <= u}."""
    n = int(mu + 12 * np.sqrt(mu + 1) + 30)
    pmf = np.zeros(n)
    pmf[0] = np.exp(-mu)
    for i in range(1, n):
        pmf[i] = pmf[i - 1] * mu / i
    return np.searchsorted(np.cumsum(pmf), u.astype(np.float64), side="right")


@pytest.mark.parametrize("mu", MU_GRID)
def test_poisson_inversion_matches_jax(mu):
    jp, tp = _params()
    n = 20_000
    u = (np.random.default_rng(int(mu * 10) + 1).integers(0, 1 << 24, n)
         * 2.0 ** -24).astype(np.float32)
    u[:3] = [0.0, 2.0 ** -24, 1.0 - 2.0 ** -24]
    mu_arr = np.full(n, mu, np.float32)
    setup = tek._nv_poisson_setup(tp, _t(mu_arr))
    jsetup = jek._nv_poisson_setup(jp, jnp.asarray(mu_arr))
    np.testing.assert_array_equal(setup[1].numpy(), np.asarray(jsetup[1]))   # kc
    for a, b in zip(setup, jsetup):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    _, K, _ = tek._nv_window(tp)
    got = tek._nv_poisson_invert(*setup, K, [_t(u)])[0].numpy()
    want = np.asarray(jek._nv_poisson_invert(*jsetup, K, [jnp.asarray(u)])[0])
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    if mu == 0.0:   # mu clamps at 1e-6
        assert (got[u < 0.9999] == 0).all()
    else:   # the three extreme uniforms clamp to the tails' resolution floor
        f64 = np.abs(got[3:] - _f64_quantile(mu, u[3:]))
        assert f64.max() <= 1 and (f64 != 0).mean() < 2e-3


def test_plain_k17_streams_through_jax_k13_give_plain_k16():
    for E in (1, 4):
        jp, tp = _params(step_limit=13, gamma=0.99)
        econ, acts, dems = tek.sample_streams_debug_nv_reset(tp, 41, B, episodes_per_lane=E,
                                                             device=CPU)
        k16 = tek.episode_returns_nv_reset_fused(tp, 41, B, episodes_per_lane=E, device=CPU)
        assert econ.shape == (E, 5, B) and acts.shape == dems.shape == (13, E, B)
        assert k16.shape == ((B,) if E == 1 else (E, B)) and k16.dtype == torch.float32
        k16 = k16.reshape(E, B)
        for e in range(E):
            np.testing.assert_allclose(
                k16[e].numpy(), _jax_k13(jp, econ[e].numpy(), acts[:, e].numpy(),
                                         dems[:, e].numpy()), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("L", [5, 0])
def test_chain_k16_k14_k13_random_k13_in_plain_versions(L):
    _, tp = _params(step_limit=21, lead_time=L)
    econ, acts, dems = tek.sample_streams_debug_nv_reset(tp, 8, B, device=CPU)
    econ, acts, dems = econ[0].contiguous(), acts[:, 0].contiguous(), dems[:, 0].contiguous()
    k16 = tek.episode_returns_nv_reset_fused(tp, 8, B, device=CPU)
    k14 = tek.episode_returns_nv_fused(tp, econ, 8)
    k15_a, k15_d = tek.sample_streams_debug_nv(tp, econ, 8)
    assert torch.equal(k15_a, acts) and torch.equal(k15_d, dems)
    assert torch.equal(k14, k16)
    assert torch.equal(tek.episode_returns_nv_random(tp, econ, dems, 8), k16)
    assert torch.equal(tek.episode_returns_nv(tp, econ, acts, dems), k16)


def test_k16_does_not_depend_on_batch_or_chunk():
    _, tp = _params(step_limit=50)
    small = tek.episode_returns_nv_reset_fused(tp, 3, 16, episodes_per_lane=2, device=CPU)
    big = tek.episode_returns_nv_reset_fused(tp, 3, 200, episodes_per_lane=3, device=CPU)
    assert torch.equal(small, big[:2, :16])
    # the count of a uniform does not depend on the chunk it is inverted in
    mu = tnv.draw_econ(tp, torch.Generator().manual_seed(1), 64, device=CPU)[:, 4]
    _, K, _ = tek._nv_window(tp)
    us = list(torch.rand((50, 64), generator=torch.Generator().manual_seed(2)))
    setup = tek._nv_poisson_setup(tp, mu)
    whole = torch.stack(tek._nv_poisson_invert(*setup, K, us))
    chunks = torch.cat([torch.stack(tek._nv_poisson_invert(*setup, K, us[i:i + 16]))
                        for i in range(0, 50, 16)])
    assert torch.equal(whole, chunks)
    for fn in (tek.episode_returns_nv_fused, tek.episode_returns_nv_reset_fused,
               tek.sample_streams_debug_nv, tek.sample_streams_debug_nv_reset):
        assert "demand_chunk" not in inspect.signature(fn).parameters


def _chi2_counts(obs, expected):
    """Chi-squared p-value of the counts ``obs`` against ``expected``, bins
    merged from the left until each expects at least 5."""
    o_bins, e_bins, o_acc, e_acc = [], [], 0.0, 0.0
    for o, e in zip(obs, expected):
        o_acc, e_acc = o_acc + o, e_acc + e
        if e_acc >= 5:
            o_bins.append(o_acc)
            e_bins.append(e_acc)
            o_acc = e_acc = 0.0
    o_bins[-1] += o_acc
    e_bins[-1] += e_acc
    e_bins = np.asarray(e_bins)
    return stats.chisquare(o_bins, e_bins * sum(o_bins) / e_bins.sum()).pvalue


def test_kernel_draws_follow_their_laws():
    _, tp = _params(step_limit=8, mu_max=30.0)
    n = 8192
    econ, acts, dems = tek.sample_streams_debug_nv_reset(tp, 77, n, device=CPU)
    price, cost, h, k, mu = econ[0].double().numpy()
    for name, u in (("price", price / tp.p_max), ("h", h / np.minimum(cost, tp.h_max)),
                    ("k", k / tp.k_max), ("mu", mu / tp.mu_max)):
        counts = np.histogram(u, bins=20, range=(0.0, 1.0))[0]
        assert stats.chisquare(counts).pvalue > 1e-4, name
    assert (cost >= 1).all() and (cost <= price).all()
    a = acts.double().numpy().ravel() / tp.max_order_quantity
    assert a.min() >= 0 and a.max() < 1
    assert stats.chisquare(np.histogram(a, bins=20, range=(0.0, 1.0))[0]).pvalue > 1e-4
    # demand given each lane's mu: counts against the mixture of its Poissons
    d = dems[:, 0].numpy().astype(np.int64)
    assert (d == dems[:, 0].numpy()).all() and d.min() >= 0
    ks = np.arange(d.max() + 1)
    expected = tp.step_limit * stats.poisson.pmf(ks[:, None], mu[None]).sum(1)
    assert _chi2_counts(np.bincount(d.ravel(), minlength=ks.size), expected) > 1e-4


@pytest.mark.parametrize("L", [5, 0])
def test_nan_action_gives_nan_return(L):
    _, tp = _params(step_limit=7, lead_time=L)
    econ, acts, dems = tek.sample_streams_debug_nv_reset(tp, 5, 16, device=CPU)
    econ, acts, dems = econ[0].contiguous(), acts[:, 0].clone(), dems[:, 0].contiguous()
    acts[3, 9] = float("nan")
    ret = tek.episode_returns_nv(tp, econ, acts, dems)
    assert torch.isnan(ret).nonzero().flatten().tolist() == [9]


@pytest.mark.parametrize("E", [1, 4])
def test_random_episode_returns_runs_plain_k16(E):
    _, tp = _params(step_limit=10)
    out = tfe.random_episode_returns(tp, torch.Generator().manual_seed(0), 32,
                                     episodes_per_lane=E, device=CPU)
    assert out.shape == (E * 32,) and out.dtype == torch.float32
    seed = tfe.kernel_seed(torch.Generator().manual_seed(0))
    ref = tek.episode_returns_nv_reset_fused(tp, seed, 32, episodes_per_lane=E, device=CPU)
    assert torch.equal(out, ref.reshape(-1))


def test_random_mean_matches_jax_xla_path():
    jp, tp = _params(step_limit=10, gamma=0.95)
    n = 4096
    mine = tfe.random_episode_returns(tp, torch.Generator().manual_seed(3), n,
                                      device=CPU).double().numpy()
    ref = np.asarray(jfe.random_episode_returns(jp, jax.random.PRNGKey(3), n,
                                                use_pallas=False), np.float64)
    se = np.sqrt(mine.var(ddof=1) / n + ref.var(ddof=1) / n)
    assert abs(mine.mean() - ref.mean()) < 4 * se, (mine.mean(), ref.mean(), se)


def test_wrappers_check_inputs_and_count_no_launches_on_cpu():
    _, tp = _params(step_limit=6)
    wrappers = (tek.episode_returns_nv, tek.episode_returns_nv_random,
                tek.episode_returns_nv_fused, tek.sample_streams_debug_nv,
                tek.episode_returns_nv_reset_fused, tek.sample_streams_debug_nv_reset)
    counts = [w.launches for w in wrappers]
    econ, acts, dems = tek.sample_streams_debug_nv_reset(tp, 1, 8, device=CPU)
    econ, acts, dems = econ[0].contiguous(), acts[:, 0].contiguous(), dems[:, 0].contiguous()
    tek.episode_returns_nv(tp, econ, acts, dems)
    tek.episode_returns_nv_random(tp, econ, dems, 1)
    tek.episode_returns_nv_fused(tp, econ, 1)
    tek.sample_streams_debug_nv(tp, econ, 1)
    tek.episode_returns_nv_reset_fused(tp, 1, 8, device=CPU)
    assert counts == [w.launches for w in wrappers]
    with pytest.raises(TypeError, match="float32"):
        tek.episode_returns_nv(tp, econ, acts.double(), dems)
    with pytest.raises(ValueError, match="expected streams"):
        tek.episode_returns_nv(tp, econ, acts[:-1], dems[:-1])
    with pytest.raises(ValueError, match="expected econ"):
        tek.episode_returns_nv_fused(tp, econ[:4], 1)
    with pytest.raises(ValueError, match="episodes_per_lane"):
        tek.episode_returns_nv_reset_fused(tp, 1, 8, episodes_per_lane=0, device=CPU)
    with pytest.raises(ValueError, match="lead_time"):
        tek._nv_plan(tnv.default_params(lead_time=33), CPU)
    actor = ((torch.zeros(10, 4), torch.zeros(4, 1)), (torch.zeros(4), torch.zeros(1)))
    with pytest.raises(NotImplementedError, match="B15"):
        tfe.policy_episode_returns(tp, actor, torch.Generator(), 4, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfe.random_episode_returns(tp, torch.Generator(), 4)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [5, 0])
def test_k13_to_k17_match_plain_on_cuda(L, cuda):
    _, tp = _params(step_limit=50, lead_time=L, gamma=0.99)
    b, E = 3000, 3   # not a multiple of the block: the tail is masked
    econ, acts, dems = tek.sample_streams_debug_nv_reset(tp, 9, b, E, device=cuda)
    pe, pa, pd = tek._nv_fused_plain(tp, 9, b, E, cuda, dump=True)
    assert torch.equal(econ, pe) and torch.equal(acts, pa)
    assert float((dems == pd).double().mean()) >= 0.9999 and (dems - pd).abs().max() <= 1
    k16 = tek.episode_returns_nv_reset_fused(tp, 9, b, E, device=cuda)
    e0, a0, d0 = econ[0].contiguous(), acts[:, 0].contiguous(), dems[:, 0].contiguous()
    for got in (tek.episode_returns_nv_fused(tp, e0, 9),
                tek.episode_returns_nv_random(tp, e0, d0, 9),
                tek.episode_returns_nv(tp, e0, a0, d0)):
        torch.testing.assert_close(got, k16[0], rtol=1e-5, atol=1e-3)
    want = tek._nv_fused_plain(tp, 9, b, E, cuda)
    ok = (k16.double() - want.double()).abs() <= 1e-2 + 1e-5 * want.double().abs()
    assert float(ok.double().mean()) >= 0.99
