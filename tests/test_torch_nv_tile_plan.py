"""The tensor-core tile of K19/K20, the Newsvendor learned-policy returns
kernel (csrc/nv_policy.cu ``k_nv_policy_returns`` on csrc/mlp_tile.cuh):
its shared-memory plan (ops/episode_kernels.py ``_nv_tile_plan``,
``_nv_tile_choice``, ``_nv_tile_structs``), the ctypes mirror of ``struct
NvTile``, and the order in which the kernel takes its demand.

The kernel cannot run here, so what surrounds it is checked on the CPU:
- both demand layouts' regions against hand counts at
  benchmark_newsvendor.py's ENV_CONFIG_EVAL (10-64-64-1 actor, lead time
  5, K = 177, 50 periods) and at the maxima (lead time 32; the largest
  mu_max whose table still fits a block of 32), with the shared bytes and
  the blocks an H100 SM holds;
- the entry points' choice: the up-front layout while its table fits a
  block, the linear count past it (at mu_max 30,000 too);
- a plain-torch replica of the up-front demand (the table's search of
  every period at the reset, chunk by chunk, each demand kept as 16 bits,
  two a word, and read back, a NaN mu read back from kc) against the plain
  version's ``_nv_poisson_invert``, bit for bit, on hypothesis-drawn mu;
- the mirror against the C struct, and the MlpTile the wrapper hands over.
The cuda-marked cases hold K19/K20 against the plain version on the card
on a ragged batch (1,000 x 3, deterministic and stochastic), with a NaN
std and with a NaN weight, and on the linear count at mu_max 30,000.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_net_k2_plan import CSRC, _c_struct_fields, _ctypes_fields
from test_torch_nv_search import NV_CHUNK, _table_invert, _table_setup

from or_gym_inventory_torch.agents import networks, ppo
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import nv_poisson as nvp

DIMS = (10, 64, 64, 1)   # ENV_CONFIG_EVAL's obs_dim 5 + lead_time 5, the default actor


def _params(mu_max=200.0, lead_time=5):
    return tnv.default_params(dict(step_limit=50, lead_time=lead_time, mu_max=mu_max))


# layout -> offsets (x0, dem, ring, table), demand rows, floats, blocks of 64
# an SM, by hand at 64 lanes: the activation buffer 64 rows x 72 = 4,608
# floats (one buffer: both hidden layers are one group of 4 M-tiles, the
# output one M-tile); the pipeline 5 rows x 64 = 320; the table 177 x 64 =
# 11,328; blocks = min(233,472 // (bytes + 1,024), 65,536 // (32 x 184) //
# 2 = 5 by registers (178 a thread, allocated as 184), 32 by threads)
DEFAULTS = {
    # 4,608 + 16 x 64 of chunk demand + 320 = 5,952 floats, 23,808 B: 9 by
    # shared memory, 5 by registers
    "linear": ((0, 4608, 5632, -1), 16, 5_952, 5),
    # 25 rows of demand (50 periods, two a word) = 1,600 floats, then
    # max(11,328, 4,608 + 320): 12,928 floats, 51,712 B: 4
    "upfront": ((1600, 0, 6208, 1600), 25, 12_928, 4),
}
NAMES = ("x0", "dem", "ring", "table")


def test_the_general_class_holds_groups_of_two():
    """K18-K20's general class holds two M-tiles at once in a hidden layer
    (csrc/nv_policy.cu NvTileGroup, so that its instances do not spill), so
    its plan keeps a hidden layer of 4 M-tiles out of place, which the
    fixed class's group of 4 computes in place."""
    assert "value = MLP_TILE_GROUP / 2;" in (CSRC / "nv_policy.cu").read_text()
    assert tek._NV_TILE_GROUP_ANY * 2 == tek._MLP_TILE_GROUP
    params = _params()
    _, K, _ = nvp.window(params)
    args = (params.lead_time, K, params.step_limit, 64, "linear", False)
    assert tek._nv_tile_plan(DIMS, params.lead_time, K, params.step_limit, 64,
                             "linear").in_place
    assert not tek._nv_tile_plan_any(DIMS, *args).in_place
    assert tek._nv_tile_plan_any((10, 32, 32, 1), *args).in_place


@pytest.mark.parametrize("layout", list(DEFAULTS))
def test_plan_matches_a_hand_count_at_the_defaults(layout):
    params = _params()
    _, K, _ = nvp.window(params)
    assert (K, params.obs_dim) == (177, DIMS[0])
    offsets, dem_rows, floats, blocks = DEFAULTS[layout]
    plan = tek._nv_tile_plan(DIMS, params.lead_time, K, params.step_limit, 64, layout)
    assert (plan.lanes, plan.stride, plan.rows, plan.in_place) == (64, 72, 64, True)
    assert plan.offsets == dict(zip(NAMES, offsets))
    assert (plan.dem_rows, plan.floats, plan.bytes) == (dem_rows, floats, 4 * floats)
    assert plan.blocks_per_sm == blocks
    assert plan.bytes <= tek.SMEM_OPTIN_BYTES
    assert plan.blocks_per_sm * (plan.bytes + tek.SMEM_PER_BLOCK_RESERVED) <= tek.SMEM_PER_SM
    assert plan.blocks_per_sm * 64 * tek._NV_TILE_REGS <= tek.REGS_PER_SM


def test_the_entry_points_take_the_upfront_layout_at_the_defaults():
    params = _params()
    st = tek._nv_plan(params, "cpu")["struct"]
    plan = tek._nv_tile_choice(DIMS, st.L, st.K, params.step_limit, st.kc_max)
    assert (plan.layout, plan.lanes) == ("upfront", 64)
    assert st.kc_max + 1 < 1 << 16   # every demand fits its 16 bits


def test_the_entry_points_count_linearly_past_the_table():
    """mu_max 30,000 (chip_smoke.py's NV_LINEAR_MU_MAX) at lead time 5: K =
    2,005, so the up-front region needs 800 + 2,005 x 32 = 64,960 floats
    (259,840 B) even at 32 lanes; every demand would fit its 16 bits, so
    the shared memory alone sends it to the linear count: 4,608 + (16 + 5)
    x 64 = 5,952 floats at 64 lanes."""
    params = _params(30_000.0)
    st = tek._nv_plan(params, "cpu")["struct"]
    assert st.K == 2005 and st.kc_max + 1 < 1 << 16
    plan = tek._nv_tile_choice(DIMS, st.L, st.K, params.step_limit, st.kc_max)
    assert (plan.layout, plan.lanes, plan.floats) == ("linear", 64, 5_952)
    assert tek._nv_tile_plan(DIMS, st.L, st.K, params.step_limit, 32, "upfront").bytes == 259_840


# mu_max 23,900: Wb = ceil(5.75 sqrt(23,900)) + 6 = 889 + 6 = 895, K =
# 1,791; at lead time 32 (obs 37, padded to 40 < 64 rows). At 64 lanes the
# up-front region needs 1,600 + 1,791 x 64 floats (464,896 B); at 32 lanes
# (stride 40: a buffer of 64 x 40 = 2,560) 800 + max(1,791 x 32, 2,560 +
# 32 x 32) = 58,112 floats = 232,448 B, the whole of a block's opt-in.
# mu_max 23,920 gives K = 1,793: 58,176 floats, past it, so the entry points
# count linearly: 64 rows x 72 + (16 + 32) x 64 = 7,680 floats at 64 lanes,
# 7 blocks by shared memory, 5 by registers.
MAXIMA = {
    23_900.0: (1791, "upfront", 32, 40, (800, 0, 3360, 800), 58_112, 1),
    23_920.0: (1793, "linear", 64, 72, (0, 4608, 5632, -1), 7_680, 5),
}


@pytest.mark.parametrize("mu_max", list(MAXIMA))
def test_plan_at_the_maxima(mu_max):
    K, layout, lanes, stride, offsets, floats, blocks = MAXIMA[mu_max]
    params = _params(mu_max, lead_time=tek.NV_MAX_L)
    st = tek._nv_plan(params, "cpu")["struct"]
    assert st.K == K and st.L == 32 and params.obs_dim == 37
    dims = (37, 64, 64, 1)
    plan = tek._nv_tile_choice(dims, st.L, st.K, params.step_limit, st.kc_max)
    assert (plan.layout, plan.lanes, plan.stride) == (layout, lanes, stride)
    assert plan.offsets == dict(zip(NAMES, offsets)) and plan.floats == floats
    assert plan.bytes <= tek.SMEM_OPTIN_BYTES and plan.blocks_per_sm == blocks
    if layout == "linear":
        too_big = tek._nv_tile_plan(dims, st.L, st.K, params.step_limit, 32, "upfront")
        assert too_big.bytes > tek.SMEM_OPTIN_BYTES


def test_the_packed_layouts_need_demands_below_two_to_the_16():
    """A demand above 65,535 would not fit its 16 bits: the choice falls
    back to the linear count, whatever the shared memory says."""
    plan = tek._nv_tile_choice(DIMS, 5, 177, 50, kc_max=1 << 16)
    assert plan.layout == "linear"
    assert tek._nv_tile_choice(DIMS, 5, 177, 50, kc_max=(1 << 16) - 2).layout == "upfront"


def test_the_structs_carry_the_plan():
    params = _params()
    g = torch.Generator().manual_seed(0)
    actor = (tuple(torch.randn(a, b, generator=g) for a, b in zip(DIMS, DIMS[1:])),
             tuple(torch.randn(b, generator=g) for b in DIMS[1:]))
    tile, _ = tek._pack_tile_actor(actor, None, 10, 1, tek._nv_half_hi(params), "cpu")
    plan = tek._nv_tile_plan(DIMS, 5, 177, 50, 64, "upfront")
    m, nt = tek._nv_tile_structs(tile, plan)
    assert (m.lanes, m.stride, m.s_x0, m.s_x1, m.s_state, m.s_total) == (
        64, 72, 1600, 1600, 6208, 12_928)
    assert (m.s_dem, m.s_z, m.s_scratch) == (-1, -1, -1)
    assert (nt.layout, nt.s_dem, nt.s_ring, nt.s_table) == (1, 0, 6208, 1600)
    assert list(m.w) == list(tile.w) and m.half_hi[0] == tile.half_hi[0]
    assert tile.s_x0 == 0   # the cached pack is left as it was


def test_nv_tile_mirror_has_the_c_fields():
    fields = _c_struct_fields("nv_policy.cu", "NvTile")
    assert _ctypes_fields(tek._NvTile) == fields
    assert ctypes.sizeof(tek._NvTile) == 4 * len(fields)


def test_the_layout_numbers_are_the_sources():
    text = (CSRC / "nv_policy.cu").read_text()
    found = {k: int(v) for k, v in re.findall(r"#define NV_DEM_(\w+) (\d+)", text)}
    assert {k.lower(): v for k, v in found.items()} == tek.NV_TILE_LAYOUTS
    assert int(re.search(r"#define NV_CHUNK (\d+)", (CSRC / "nv_step.cuh").read_text())
               .group(1)) == tek.NV_CHUNK == NV_CHUNK


# ---------------------------------------------- the up-front demand order

def _upfront_demands(params, mu, us):
    """The demand of every period as the up-front kernel takes it: the
    table built once, each chunk of NV_CHUNK periods searched (thresholds
    past the horizon 0), the demands packed two to a 32-bit word (16 bits
    each) and unpacked; a NaN mu (kc NaN) reads back NaN."""
    anchor, S, m, lo, hi = _table_setup(params, mu)
    T = us.shape[0]
    words = torch.zeros((-(-T // 2), mu.shape[0]), dtype=torch.int64)
    for t0 in range(0, T, NV_CHUNK):
        u = torch.zeros((NV_CHUNK, mu.shape[0]), dtype=torch.float32)
        n = min(NV_CHUNK, T - t0)
        u[:n] = us[t0:t0 + n]
        vs = (1.0 - u) * anchor[3]
        vs[n:] = 0.0
        d = _table_invert(anchor[1], S, m, lo, hi, vs)
        as_u16 = torch.nan_to_num(d, nan=0.0).to(torch.int64)   # the card's cast of a NaN
        assert int(as_u16.max()) < 1 << 16
        for i in range(0, NV_CHUNK, 2):
            if t0 + i < T:
                words[(t0 + i) // 2] = as_u16[i] | (as_u16[i + 1] << 16)
    out = torch.stack([((words[t // 2] >> (16 * (t % 2))) & 0xFFFF).to(torch.float32)
                       for t in range(T)])
    return torch.where(torch.isnan(anchor[1]), torch.full_like(out, float("nan")), out)


def _check_upfront(mu_max, mu_values, seed, T=50):
    params = _params(mu_max)
    mu = torch.tensor(mu_values, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    us = torch.from_numpy((rng.integers(0, 1 << 24, (T, mu.shape[0])) * 2.0 ** -24)
                          .astype(np.float32))
    got = _upfront_demands(params, mu, us)
    _, K, _ = nvp.window(params)
    want = torch.stack(nvp.invert(*nvp.setup(params, mu), K, list(us)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@settings(max_examples=25, deadline=None)
@given(mu_max=st.sampled_from([200.0, 3.0, 2_000.0]),
       fractions=st.lists(st.floats(0.0, 1.0), min_size=1, max_size=12),
       nan_at=st.lists(st.integers(0, 11), max_size=3),
       seed=st.integers(0, 2 ** 31 - 1),
       T=st.sampled_from([50, 33, 1]))
def test_upfront_demand_equals_the_linear_count(mu_max, fractions, nan_at, seed, T):
    """mu = fraction x mu_max (the reset's u x mu_max), some lanes NaN; T
    odd leaves a half word, T = 1 a single period."""
    mu = [float(np.float32(f * mu_max)) for f in fractions]
    for i in nan_at:
        if i < len(mu):
            mu[i] = float("nan")
    _check_upfront(mu_max, mu, seed, T)


@pytest.mark.parametrize("mu_max", [200.0, 3.0])
def test_upfront_demand_on_a_grid(mu_max):
    mu = np.geomspace(1e-6, mu_max, 256).astype(np.float32).tolist() + [0.0, float("nan")]
    _check_upfront(mu_max, mu, int(mu_max))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _actor(dev, seed=3):
    """The default 64x64 actor-critic's actor from its own initialisation,
    obs statistics (mean ~50, std ~20) folded into layer 1, as a trained
    PPO actor reaches the entry points."""
    g = torch.Generator().manual_seed(seed)
    model = networks.MLPActorCritic(DIMS[0], DIMS[-1], generator=g)
    rms = ppo.RunningMeanStd(mean=50.0 + 5.0 * torch.randn(DIMS[0], generator=g),
                             var=(20.0 + 5.0 * torch.rand(DIMS[0], generator=g)) ** 2,
                             count=torch.tensor(1e3))
    Ws, bs = tek.fold_actor_params(ppo.PPOConfig(), model, rms)
    return tuple(W.to(dev) for W in Ws), tuple(b.to(dev) for b in bs)


def _share(got, want, rtol=1e-4, atol=1e-2):
    ok = (got.double() - want.double()).abs() <= atol + rtol * want.double().abs()
    return float(ok.reshape(-1, got.shape[-1]).all(0).double().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [False, True])
def test_k19_k20_ragged_batch_on_cuda(cuda, stochastic):
    """B x E = 1,000 x 3: not a multiple of the 64-lane tile nor of a warp."""
    params = _params()
    actor = _actor(cuda)
    log_std = torch.full((1,), -0.5, device=cuda) if stochastic else None
    b, E = 1000, 3
    k19 = tek.episode_returns_nv_policy(params, actor, 9, b, E, log_std, cuda)
    r20, econ, acts, dems = tek.sample_policy_streams_debug_nv(params, actor, 9, b, E, log_std,
                                                              cuda)
    std = None if log_std is None else tek.clipped_std(log_std)
    want, we, wa, wd = tek._nv_policy_plain(params, actor, std, 9, b, E, cuda, True)
    assert torch.equal(k19, r20) and torch.equal(econ, we) and torch.equal(dems, wd)
    assert _share(k19, want) >= 0.99
    assert _share(acts.reshape(-1, E * b), wa.reshape(-1, E * b)) >= 0.99


@pytest.mark.cuda
def test_k19_with_a_nan_std_or_a_nan_weight_on_cuda(cuda):
    """NaN orders and returns, as the plain version's; the econ and the
    demand untouched."""
    params = _params()
    actor = _actor(cuda)
    ret, econ, acts, dems = tek.sample_policy_streams_debug_nv(
        params, actor, 4, 300, 2, torch.full((1,), float("nan"), device=cuda), cuda)
    _, we, _, wd = tek._nv_policy_plain(params, actor, None, 4, 300, 2, cuda, True)
    assert torch.isnan(ret).all() and torch.isnan(acts).all()
    assert torch.equal(econ, we) and torch.equal(dems, wd)
    Ws = [W.clone() for W in actor[0]]
    Ws[1][5, 1] = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)[0]
    bad = (tuple(Ws), actor[1])
    ret, econ, acts, dems = tek.sample_policy_streams_debug_nv(params, bad, 4, 300, 2, None,
                                                              cuda)
    want, we, wa, wd = tek._nv_policy_plain(params, bad, None, 4, 300, 2, cuda, True)
    assert torch.isnan(ret).all() and torch.isnan(acts).all()
    assert torch.isnan(want).all() and torch.isnan(wa).all()
    assert torch.equal(econ, we) and torch.equal(dems, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [False, True])
def test_k19_k20_on_the_linear_count_on_cuda(cuda, stochastic):
    """mu_max 30,000, where no table fits a block: econ and demand bit for
    bit, K20 = K19, returns and orders on >= 99% of lanes."""
    params = _params(30_000.0)
    actor = _actor(cuda)
    log_std = torch.full((1,), -0.5, device=cuda) if stochastic else None
    b, E = 2_048, 2
    k19 = tek.episode_returns_nv_policy(params, actor, 5, b, E, log_std, cuda)
    r20, econ, acts, dems = tek.sample_policy_streams_debug_nv(params, actor, 5, b, E, log_std,
                                                              cuda)
    std = None if log_std is None else tek.clipped_std(log_std)
    want, we, wa, wd = tek._nv_policy_plain(params, actor, std, 5, b, E, cuda, True)
    assert torch.equal(k19, r20) and torch.equal(econ, we) and torch.equal(dems, wd)
    assert _share(k19, want) >= 0.99
    assert _share(acts.reshape(-1, E * b), wa.reshape(-1, E * b)) >= 0.99
