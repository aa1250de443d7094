"""The Newsvendor Poisson inversion as K14-K17 run it: one table of suffix
sums per episode, searched per period (csrc/nv_step.cuh ``nv_table_setup``
and ``nv_table_invert``), and its launch plan (ops/episode_kernels.py
``_nv_table_plan``).

The kernels cannot run here, so a plain-torch replica of their algorithm is
held bit for bit against the plain version ``_nv_poisson_invert``, the
oracle (itself pinned to the JAX package's ``_nv_poisson_invert`` by
tests/test_torch_nv_kernels.py). The replica does what the CUDA code does:
the setup's K recurrence steps, each pre-add sum S(k) kept, m = the first k
with S(k+1) < S(k) (K if none), the min and max of S over [m, K); then per
threshold v the branchless lower bound over the sorted prefix [0, m), all
thresholds taking the same rounds, plus 0 / K - m / a linear count over
[m, K). The plan is held against hand counts of an H100's shared memory
and registers (ptxas's count for k_nv_episodes, which chip_smoke.py checks
on the card), and the ctypes mirror ``_NvParams`` against ``struct
NvParams``.
"""

import numpy as np
import pytest
import torch
from test_torch_net_k2_plan import _c_struct_fields, _ctypes_fields

from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import nv_poisson as nvp

NV_CHUNK = 16   # csrc/nv_step.cuh: the thresholds one search round serves


def _params(mu_max):
    return tnv.default_params(dict(step_limit=50, lead_time=5, mu_max=mu_max))


def _table_setup(params, mu):
    """(anchor (mu_safe, kc, p_c, total), S (K, N), m (N,), lo (N,), hi (N,))
    as nv_table_setup builds them."""
    mu_safe, kc, p_c, _ = nvp.setup(params, mu)
    _, K, _ = nvp.window(params)
    T, comp, p, kf = torch.zeros_like(p_c), torch.zeros_like(p_c), p_c, kc
    n = p_c.shape[0]
    S = torch.empty((K, n), dtype=torch.float32)
    m = torch.full((n,), K, dtype=torch.int64)
    lo = torch.full((n,), float("inf"))
    hi = torch.full((n,), float("-inf"))
    for k in range(K):
        s = T
        S[k] = s
        T, comp, p, kf = nvp.recur(T, comp, p, kf, mu_safe)
        m = torch.where((m == K) & (T < s), torch.full_like(m, k), m)
        in_suffix = m <= k
        lo = torch.where(in_suffix, torch.fmin(lo, s), lo)
        hi = torch.where(in_suffix, torch.fmax(hi, s), hi)
    return (mu_safe, kc, p_c, T), S, m, lo, hi


def _table_invert(kc, S, m, lo, hi, vs):
    """nv_table_invert's demands for the thresholds ``vs`` (R, N)."""
    K, n = S.shape
    cols = torch.arange(n)
    base = torch.zeros(vs.shape, dtype=torch.int64)
    length = m.clone()
    while bool((length > 1).any()):   # a lane's rounds depend on its m alone
        half = length // 2
        probe = S[(base + half).clamp(max=K - 1), cols]
        step = (length > 1) & (probe < vs)
        base = torch.where(step, base + half, base)
        length = length - half
    cnt = torch.where(m > 0, base + (S[base.clamp(max=K - 1), cols] < vs).long(), 0)
    linear = torch.zeros_like(cnt)
    for k in range(K):
        linear += ((k >= m) & (S[k] < vs)).long()
    cnt = cnt + torch.where(vs > hi, K - m, torch.where(vs > lo, linear, 0))
    return torch.maximum(kc + 1.0 - cnt.to(torch.float32), torch.zeros_like(vs))


def _oracle(params, anchor, us):
    _, K, _ = nvp.window(params)
    return torch.stack(nvp.invert(*anchor, K, list(us)))


def _check(params, mu, us):
    """The replica's demands equal the oracle's bit for bit; returns m."""
    anchor, S, m, lo, hi = _table_setup(params, mu)
    us = torch.as_tensor(us, dtype=torch.float32)
    vs = (1.0 - us) * anchor[3]
    got = _table_invert(anchor[1], S, m, lo, hi, vs)
    want = _oracle(params, anchor, us)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    return m


def _mu_grid(mu_max, n):
    """n values from 1e-6 to mu_max, log-spaced, as f32."""
    return torch.from_numpy(np.geomspace(1e-6, mu_max, n).astype(np.float32))


@pytest.mark.parametrize("mu_max", [200.0, 3.0])
def test_search_matches_the_linear_count_on_random_uniforms(mu_max):
    params = _params(mu_max)
    mu = _mu_grid(mu_max, 512)
    rng = np.random.default_rng(int(mu_max))
    us = (rng.integers(0, 1 << 24, (NV_CHUNK, mu.shape[0])) * 2.0 ** -24).astype(np.float32)
    us[0], us[1] = 0.0, 1.0 - 2.0 ** -24
    _check(params, mu, us)


@pytest.mark.parametrize("mu_max", [200.0, 3.0])
def test_search_matches_on_every_boundary(mu_max):
    """For each lane and each k, the 24-bit uniforms whose thresholds fall
    just below, at and just above S(k): every count's edge."""
    params = _params(mu_max)
    mu = _mu_grid(mu_max, 48)
    anchor, S, _, _, _ = _table_setup(params, mu)
    u_at = 1.0 - S.double() / anchor[3].double()          # (K, N)
    grid = torch.round(u_at * 2.0 ** 24)
    us = torch.cat([(grid + d) for d in (-1.0, 0.0, 1.0)]).clamp(0, 2.0 ** 24 - 1)
    us = (us * 2.0 ** -24).to(torch.float32)
    us = torch.nan_to_num(us, nan=0.0)
    for rows in torch.split(us, NV_CHUNK):
        _check(params, mu, rows)


def test_nan_mu_counts_zero_as_the_linear_count():
    params = _params(200.0)
    mu = torch.tensor([float("nan"), 5.0, float("nan"), 150.0])
    us = torch.full((NV_CHUNK, 4), 0.25)
    m = _check(params, mu, us)
    assert int(m[0]) == nvp.window(params)[1]   # no decrease is seen in NaNs


def test_a_lane_whose_sums_decrease_is_searched_in_two_parts():
    """The grid holds lanes where a Kahan step adds a negative y (m < K) in
    the far tail; each is counted over [0, m) by search and over [m, K) by
    its min, max or a linear count, and matches the oracle."""
    params = _params(200.0)
    mu = _mu_grid(200.0, 4096)
    anchor, S, m, lo, hi = _table_setup(params, mu)
    _, K, _ = nvp.window(params)
    bent = torch.nonzero(m < K).flatten()
    assert bent.numel() > 0, "no lane of the grid has a decreasing suffix sum"
    mu_b = mu[bent]
    anchor_b, S_b, m_b, lo_b, hi_b = _table_setup(params, mu_b)
    # thresholds on each suffix value and its neighbours, so the linear
    # branch runs
    v_rows = []
    for k in range(K):
        in_suffix = k >= m_b
        v = torch.where(in_suffix, S_b[k], lo_b)
        v_rows += [v, torch.nextafter(v, torch.full_like(v, np.inf)),
                   torch.nextafter(v, torch.full_like(v, -np.inf))]
    vs = torch.stack(v_rows)
    got = _table_invert(anchor_b[1], S_b, m_b, lo_b, hi_b, vs)
    cnt = (S_b[None] < vs[:, None]).sum(1)
    want = torch.maximum(anchor_b[1] + 1.0 - cnt.to(torch.float32), torch.zeros_like(vs))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_hand_built_table_with_a_dip():
    """A table that rises, dips in the middle of its suffix and recovers:
    the count of every threshold equals the brute-force count."""
    S = torch.tensor([0.0, 1.0, 2.0, 3.0, 5.0, 8.0, 8.0, 7.5, 8.0, 7.75, 8.0])[:, None]
    diffs = S[1:, 0] < S[:-1, 0]
    m = torch.tensor([int(torch.nonzero(diffs)[0])])
    lo, hi = S[int(m):].min(0).values, S[int(m):].max(0).values
    assert (int(m), float(lo), float(hi)) == (6, 7.5, 8.0)
    vs = torch.tensor([-1.0, 0.0, 0.5, 1.0, 4.0, 5.0, 7.5, 7.6, 7.75, 7.9, 8.0, 8.5])[:, None]
    kc = torch.tensor([20.0])
    got = _table_invert(kc, S, m, lo, hi, vs)
    want = kc + 1.0 - (S[:, 0][None] < vs).sum(1, keepdim=True).to(torch.float32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# (mu_max, K by hand: 2 (ceil(5.75 sqrt(mu_max)) + 6) + 1, threads, bytes a
# block, blocks an SM, table)
PLANS = {
    # 708 B a thread: 5 blocks of 64 (45,312 B + 1 KB each) in 228 KB = 320
    # threads, as many as 160 a block gives; 32 a block gives 9 x 32 = 288
    200.0: (177, 64, 45_312, 5, True),
    # 132 B a thread: the registers bind, 65,536 / (32 x 96) = 21 warps an
    # SM; 21 blocks of 32 (4,224 B + 1 KB) = 672 threads, which 96 and 224
    # a block tie and 64 (10 blocks), 128 (5) and 256 (2) do not reach
    3.0: (33, 32, 4_224, 21, True),
    # K = 2005: 32 threads would need 256,640 B > 227 KB; the linear count,
    # 5 blocks of 128 in 21 warps' registers
    30_000.0: (2005, 128, 0, 5, False),
}


@pytest.mark.parametrize("mu_max", list(PLANS))
def test_plan_matches_a_hand_count(mu_max):
    K, threads, nbytes, blocks, table = PLANS[mu_max]
    params = _params(mu_max)
    assert nvp.window(params)[1] == K
    plan = tek._nv_table_plan(K)
    assert plan == tek.NvTablePlan(threads, nbytes, blocks, table)
    assert plan.bytes <= tek.SMEM_OPTIN_BYTES
    assert plan.blocks_per_sm * (plan.bytes + tek.SMEM_PER_BLOCK_RESERVED) <= tek.SMEM_PER_SM
    assert plan.blocks_per_sm * plan.threads * tek._NV_TABLE_REGS <= tek.REGS_PER_SM
    st = tek._nv_plan(params, "cpu")["struct"]
    assert (st.K, st.threads, st.table) == (K, threads, int(table))


def test_plan_cutover_is_where_32_threads_stop_fitting():
    """4 K * 32 <= 232,448 holds up to K = 1,816."""
    assert tek._nv_table_plan(1816) == tek.NvTablePlan(32, 232_448, 1, True)
    assert not tek._nv_table_plan(1817).table
    assert 4 * 1817 * 32 > tek.SMEM_OPTIN_BYTES


def test_nv_params_mirror_has_the_c_fields():
    fields = _c_struct_fields("nv_step.cuh", "NvParams")
    assert _ctypes_fields(tek._NvParams) == fields


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mu_max", [200.0, 3.0, 30_000.0])
def test_k14_to_k17_match_plain_on_cuda(mu_max, cuda):
    """The table (mu_max 200 and 3) and the linear variant (30,000)."""
    tp = _params(mu_max)
    b, E = 3000, 2
    econ, acts, dems = tek.sample_streams_debug_nv_reset(tp, 5, b, E, device=cuda)
    pe, pa, pd = tek._nv_fused_plain(tp, 5, b, E, cuda, dump=True)
    assert torch.equal(econ, pe) and torch.equal(acts, pa)
    assert float((dems == pd).double().mean()) >= 0.9999 and (dems - pd).abs().max() <= 1
    k16 = tek.episode_returns_nv_reset_fused(tp, 5, b, E, device=cuda)
    e0 = econ[0].contiguous()
    a15, d15 = tek.sample_streams_debug_nv(tp, e0, 5)
    assert torch.equal(a15, acts[:, 0]) and torch.equal(d15, dems[:, 0])
    torch.testing.assert_close(tek.episode_returns_nv_fused(tp, e0, 5), k16[0],
                               rtol=1e-5, atol=1e-3)
    want = tek._nv_fused_plain(tp, 5, b, E, cuda)
    ok = (k16.double() - want.double()).abs() <= 1e-2 + 1e-5 * want.double().abs()
    assert float(ok.double().mean()) >= 0.99
