"""K9 (``episode_kernels.sample_streams_debug_im``) over (lane, episode,
period group), an instance per m1, and K21
(``episode_kernels.sample_normals_debug``) over (lane, row group), as far
as the CPU reaches them.

- A replica of K9's threads (thread (lane, q), q = period group x E +
  episode, each of its P periods drawn from its own counter: the m1 action
  words, then the demand word) equal to the plain dump
  (``_im_fused_plain(..., dump=True)``) bit for bit, at P = 1, 2 and 4, E =
  1 and 3, T = 1, 5 and 30 (a last group shorter than P), m1 = 1, 3 and 8,
  in every demand mode, USER included.
- The 2-D grids' rows (K9's (group, episode) rows, K21's row groups) cover
  every (period, episode) or row once, also where the rows pass the grid's
  65,535 and the y-stride folds them; the launches and constants as the
  sources have them.
- A replica of K21's threads (thread (lane, g) walks rows [g R, min(g R +
  R, rows)), each from its own counter, the next row's block drawn while
  this row's normal is formed) equal to ``_sample_normals_plain`` bit for
  bit at R = 1, 2, 4 and 8; the source's rolled row loop.
- One K9 instance for each m1 from 1 to 8 in the source; the ctypes
  signatures of both entry points unchanged and equal to the C parameter
  lists.
- Plain K9's streams at m1 = 8 and lt 32 through the JAX package's
  ``episode_returns_im`` in interpret mode equal plain K8's returns
  (``rtol=1e-5, atol=1e-3``, as tests/test_torch_im_kernels.py does at the
  defaults: f32 profit sums in the same order, but XLA may contract a
  product and a sum into an FMA).

The cuda-marked cases hold K9 at every m1 from 1 to 8 in every demand mode,
E = 1 and 16, on ragged batches (1,000 and 1,025 lanes) against the plain
dump exactly, and K21 at rows 1, 63 and 64 on a ragged batch within
``atol=1e-5`` of plain (the card's logf and cosf may differ from the CPU's
by an ulp). JAX is imported by the interpret test's fixture alone, so that
those cases run where JAX is not installed.
"""

import ctypes
import dataclasses
import re
import types

import numpy as np
import pytest
import torch
from test_torch_k3_k7_plan import _chain_kwargs
from test_torch_net_k2_plan import CSRC
from test_torch_ppo_traj_plan import _c_entry_points

from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.ops import _build
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop

SEED = 2024

# the five demand modes (chip_smoke.py IM_DIST_MODES); USER's values by period
DIST_MODES = {
    "poisson": {},
    "binomial": {"dist": 2, "dist_param": {"n": 40, "p": 0.5}},
    "randint": {"dist": 3, "dist_param": {"low": 10, "high": 30}},
    "geometric": {"dist": 4, "dist_param": {"p": 0.05}},
    "user": {"dist": 5},
}


def _params(mode, m1, T, backlog=True, L=None):
    kw = dict(DIST_MODES[mode])
    if mode == "user":
        kw["user_D"] = tuple((7 * t) % 41 for t in range(T))
    params = tim.default_params(backlog=backlog, periods=T, **_chain_kwargs(m1, L), **kw)
    assert (params.m1, params.periods) == (m1, T)
    return params


def _source_constant(src, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, (CSRC / src).read_text())
               .group(1))


# ---------------------------------------------------- K9's thread mapping

def _k9_replica(params, seed, batch, E, periods):
    """K9's streams as its threads write them: thread (lane, q) for each of
    the batch lanes and E x ceil(T / periods) rows, q = group x E +
    episode, draws periods [group x periods, group x periods + periods) of
    its (lane, episode), each from its own counter (the m1 action words,
    then the demand word: ``_im_draws_plain``), and writes them to (T, E,
    m1, B) and (T, E, B). Also returns how often each (t, e, lane) was
    written."""
    m1, T = params.m1, params.periods
    plan = tek._im_host_plan(params, "cpu")
    groups = -(-T // periods)
    idx = torch.arange(batch * E * groups, dtype=torch.int64)
    q, lane = idx // batch, idx % batch
    e, t0 = q % E, (q // E) * periods
    acts = torch.full((T, E, m1, batch), -1, dtype=torch.int32)
    dems = torch.full((T, E, batch), -1, dtype=torch.int32)
    written = torch.zeros((T, E, batch), dtype=torch.int64)
    for k in range(periods):
        t = t0 + k
        for tv in t.unique().tolist():
            if tv >= T:
                continue
            sel = t == tv
            a, d = tek._im_draws_plain(params, plan, seed, lane[sel], e[sel], tv)
            acts[tv, e[sel], :, lane[sel]] = torch.stack(a).T
            dems[tv, e[sel], lane[sel]] = d
            written[tv, e[sel], lane[sel]] += 1
    return acts, dems, written


@pytest.mark.parametrize("m1", [1, 3, 8])
@pytest.mark.parametrize("mode", list(DIST_MODES))
def test_k9_threads_write_the_whole_dump(mode, m1):
    batch = 37
    for T in (1, 5, 30):
        params = _params(mode, m1, T)
        for E in (1, 3):
            want_a, want_d = tek._im_fused_plain(params, SEED, batch, E, "cpu", dump=True)
            for periods in (1, 2, 4):
                acts, dems, written = _k9_replica(params, SEED, batch, E, periods)
                assert bool((written == 1).all()), (T, E, periods)
                assert torch.equal(acts, want_a) and torch.equal(dems, want_d), (T, E, periods)
            got_a, got_d = tek.sample_streams_debug_im(params, SEED, batch, E, device="cpu")
            if E == 1:
                got_a, got_d = got_a[:, None], got_d[:, None]
            assert torch.equal(got_a, want_a) and torch.equal(got_d, want_d)


def _grid_coverage(n_rows, grid_y, unit, E, T):
    """How often K9's (or, with E = 1, K21's) launch writes each (t, e):
    block row by of the grid takes rows q = by, by + grid_y, ... < n_rows;
    row q is (episode q % E, units [q // E x unit, + unit)), clipped at T."""
    hits = np.zeros((T, E), dtype=np.int64)
    for by in range(grid_y):
        q = np.arange(by, n_rows, grid_y)
        e, t0 = q % E, q // E * unit
        for k in range(unit):
            t = t0 + k
            keep = t < T
            np.add.at(hits, (t[keep], e[keep]), 1)
    return hits


@pytest.mark.parametrize("E, T", [(1, 1), (3, 5), (16, 30), (20_000, 30)])
def test_k9_grid_rows_cover_every_period_and_episode_once(E, T):
    """The launch's rows are k9_groups(T) x E, the grid's y capped at 65,535;
    at E = 20,000 x 8 groups = 160,000 rows the blocks stride over the rest."""
    P = _source_constant("im_episode.cu", "kK9Periods")
    rows = -(-T // P) * E
    grid_y = min(rows, 65535)
    assert (rows > 65535) == (E == 20_000)
    hits = _grid_coverage(rows, grid_y, P, E, T)
    assert bool((hits == 1).all())


@pytest.mark.parametrize("rows", [1, 6, 64, 65, 600_000])
def test_k21_grid_groups_cover_every_row_once(rows):
    """The launch's y is k21_groups(rows), capped at 65,535; at 600,000 rows
    and 8 a thread, 75,000 groups, so the blocks stride over the rest."""
    R = _source_constant("nv_policy.cu", "kK21Rows")
    groups = -(-rows // R)
    assert (groups > 65535) == (rows == 600_000)
    hits = _grid_coverage(groups, min(groups, 65535), R, 1, rows)
    assert bool((hits == 1).all())


def test_k9_launches_an_instance_per_m1_on_a_2d_grid():
    """im_episode.cu: K9 templated on M1, drawing through
    im_draw_actions<M1> into a register array of M1, dispatched by
    launch_k9_m1 from m1 = 1 up to IM_MAX_M1 (8), on a grid of blocks over
    the lanes along x and one row of blocks for each of the E x
    k9_groups(T) rows along y, four periods a thread; no 64-bit division
    in the kernel."""
    text = (CSRC / "im_episode.cu").read_text()
    assert _source_constant("im_episode.cu", "kK9Periods") == 4
    body = text[text.index("template <int M1>\n__global__ void k_im_sample_streams("):]
    body = body[:body.index("\n}\n")]
    assert "int act[M1];" in body and "im_draw_actions<M1>(p, ws, act);" in body
    assert "for (int q = blockIdx.y; q < rows; q += gridDim.y) {" in body
    assert "/ B" not in body and "% B" not in body and "IM_MAX_M1" not in body
    launch = text[text.index("template <int M1 = 1>\nint launch_k9_m1("):]
    launch = launch[:launch.index("\n}\n")]
    assert "const int rows = k9_groups(T) * E;" in launch
    assert "const dim3 grid(blocks_for(B), rows < 65535 ? rows : 65535);" in launch
    assert "k_im_sample_streams<M1><<<grid, kThreads, 0, stream>>>(" in launch
    assert "if constexpr (M1 < IM_MAX_M1)\n    return launch_k9_m1<M1 + 1>(" in launch
    assert "return launch_k9_m1(*p, table, user_d, acts, dems, seed, B, E, T, stream);" in text
    assert int(re.search(r"#define IM_MAX_M1 (\d+)", (CSRC / "im_step.cuh").read_text())
               .group(1)) == tek.IM_MAX_M1 == 8
    assert text.count("__global__ void k_im_sample_streams(") == 1


def test_k21_launches_a_2d_grid():
    """nv_policy.cu: K21 over (lane, group of eight rows), the row loop
    rolled with one copy of normal01 in it (so cosf's never-run reduction
    keeps no stack frame), no 64-bit division in the kernel."""
    text = (CSRC / "nv_policy.cu").read_text()
    assert _source_constant("nv_policy.cu", "kK21Rows") == 8
    body = text[text.index("__global__ void k_sample_normals("):]
    body = body[:body.index("\n}\n")]
    assert "for (int g = blockIdx.y; g < groups; g += gridDim.y) {" in body
    assert "#pragma unroll 1\n    for (int row = r0; row < r1; ++row) {" in body
    assert body.count("normal01(") == 1 and "if (row + 1 < r1) {" in body
    assert "/ B" not in body and "% B" not in body
    assert "const dim3 grid(blocks_for(B), groups < 65535 ? groups : 65535);" in text
    assert "k_sample_normals<<<grid, kThreads, 0, stream>>>(out, seed, B, rows);" in text


# --------------------------------------------------- K21's thread mapping

def _k21_replica(seed, rows, batch, R):
    """K21's normals as its threads write them: thread (lane, g) walks rows
    [g R, min(g R + R, rows)), drawing the first row's words 0 and 1 of
    counter (lane, 0, row, 0) under key (seed, 1) before the loop and each
    next row's inside it, while it stores normal01 of this row's. Also
    returns how often each element was written."""
    out = torch.full((rows, batch), float("nan"))
    written = torch.zeros((rows, batch), dtype=torch.int64)
    lanes = torch.arange(batch, dtype=torch.int64)

    def words(row):
        return rng.period_words(seed, lanes, 0, row, 2, key1=rng.POLICY_KEY)
    for g in range(-(-rows // R)):
        r0, r1 = g * R, min(g * R + R, rows)
        w = words(r0)
        for row in range(r0, r1):
            nxt = words(row + 1) if row + 1 < r1 else None
            out[row] = rng.normal01(*w)
            written[row] += 1
            w = nxt
    return out, written


@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", [1, 6, 64, 65])
def test_k21_threads_write_the_plain_normals(rows, R):
    batch = 45
    got, written = _k21_replica(SEED, rows, batch, R)
    assert bool((written == 1).all())
    want = tek._sample_normals_plain(SEED, rows, batch, "cpu")
    assert torch.equal(got, want)
    assert torch.equal(tek.sample_normals_debug(SEED, rows, batch, device="cpu"), want)


# ------------------------------------------------------- the entry points

def test_the_ctypes_signatures_are_unchanged():
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    k9 = ((P, P, P, P, P, U, LL, I, I, P), I)
    k21 = ((P, U, LL, I, P), I)
    assert _build.SIGNATURES["im_episode"]["im_sample_streams"] == k9
    assert _build.SIGNATURES["nv_policy"]["sample_normals"] == k21
    assert _c_entry_points("im_episode")["im_sample_streams"] == k9
    assert _c_entry_points("nv_policy")["sample_normals"] == k21


# ------------------------------------------ plain K9 through JAX's K7

@pytest.fixture
def ref():
    """The JAX package's interpret kernels: imported here, not at the top,
    so that the cuda-marked cases run on a machine without JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from or_gym_inventory_tpu.envs import inv_management as jim
    from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek
    return types.SimpleNamespace(jnp=jnp, jim=jim, jek=jek)


@pytest.mark.parametrize("backlog", [True, False])
def test_plain_k9_at_the_maxima_through_jax_k7_equals_plain_k8(ref, backlog):
    """m1 = 8 stocked stages, lead times 3, 5, 10, 32 twice (lt_max 32, the
    struct maxima), 34 periods so that the longest lead time delivers; the
    second of two episodes a lane (the first is the defaults' case in
    tests/test_torch_im_kernels.py)."""
    T, B, E = 34, 64, 2
    jp = ref.jim.default_params(periods=T, backlog=backlog,
                                **_chain_kwargs(8, (3, 5, 10, 32) * 2))
    tp = interop.im_params_from_numpy(dataclasses.asdict(jp))
    assert (tp.m1, tp.lt_max, tp.periods) == (8, 32, T)
    acts, dems = tek.sample_streams_debug_im(tp, 31, B, E, device="cpu")
    ret = tek.episode_returns_im_fused(tp, 31, B, E, device="cpu")
    assert acts.shape == (T, E, 8, B) and ret.shape == (E, B)
    want = np.asarray(ref.jek.episode_returns_im(
        jp, ref.jnp.asarray(acts[:, 1].numpy()), ref.jnp.asarray(dems[:, 1].numpy()),
        block=B, interpret=True))
    np.testing.assert_allclose(ret[1].numpy(), want, rtol=1e-5, atol=1e-3)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(DIST_MODES))
@pytest.mark.parametrize("m1", range(1, 9))
def test_k9_ragged_on_cuda(cuda, m1, mode):
    """Every instance in every demand mode, E = 1 and 16, on 1,000 and 1,025
    lanes: the plain dump bit for bit."""
    params = _params(mode, m1, 30)
    for batch in (1000, 1025):
        for E in (1, 16):
            got = tek.sample_streams_debug_im(params, 7, batch, E, device=cuda)
            want = tek._im_fused_plain(params, 7, batch, E, cuda, dump=True)
            if E == 1:
                want = (want[0][:, 0], want[1][:, 0])
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (batch, E)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 63, 64])
def test_k21_ragged_on_cuda(cuda, rows):
    got = tek.sample_normals_debug(7, rows, 1000, device=cuda)
    want = tek._sample_normals_plain(7, rows, 1000, cuda)
    assert got.shape == (rows, 1000)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)
