"""K3 (``net_step.sample_streams_debug``) over (lane, episode, period) and
K7 (``episode_kernels.episode_returns_im`` and ``episode_returns_im_random``)
on K8's shared-memory episode, as far as the CPU reaches them.

- K7's launch plan (``episode_kernels._im_k7_plan``): the ring's lt m1
  words, then two staging buffers of ``chunk`` periods of m1 + 1 words a
  thread, by hand-counted words, bytes and blocks an SM for m1 = 1, 3 and 8
  and lt = 0, 1, 10 and 32; the layout it takes (the first of
  ``IM_K7_CHUNKS`` x ``IM_K7_THREADS`` that holds ``IM_K7_RESIDENT``
  threads an SM, else the most: 64 threads and 2 periods at the struct
  maxima) and its refusal of a layout no block holds;
  the ctypes mirror of ``struct ImStage``, field by field; the plan the
  wrapper's ``_im_plan`` carries; an instance for each m1 and mode in the
  source.
- Plain K7 against the JAX package's ``episode_returns_im`` in interpret
  mode (as tests/test_torch_im_kernels.py does) at m1 = 1 and 8, in
  backlog, at lt = 0 (every L = 0) and in lost sales, ``rtol=1e-5,
  atol=1e-3`` (f32 profit sums in the same order, but XLA may contract a
  product and a sum into an FMA; the atol covers returns near 0).
- A replica of K3's threads (thread (lane, q), q = period group x W +
  episode, each drawing its periods alone from their counters) equal to the
  plain version's whole dump bit for bit, at 1, 2 and 4 periods a thread,
  with and without ``dump_range``.

The cuda-marked cases hold K7 at every m1 from 1 to 8, backlog and lost
sales, streamed and ``_random``, on ragged batches (1,000 and 1,025 lanes)
against the plain version and K8 exactly (one episode body, int32 state),
and K3 on a ragged batch with a dump range against plain exactly. JAX is
imported by the interpret test's fixture alone, so that those cases run
where JAX is not installed.
"""

import ctypes
import dataclasses
import re
import types

import numpy as np
import pytest
import torch
from test_torch_net_k2_plan import CSRC, _c_struct_fields, _ctypes_fields

from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.utils import interop

# (m1, lt) -> (words a thread, bytes a block, blocks an SM) at 4 periods a
# buffer and 128 threads (each holds 256 threads an SM or more), by hand:
# words = lt m1 + 2 x 4 x (m1 + 1); bytes = 4 x words x 128; blocks =
# min(233,472 // (bytes + 1,024), 2,048 // 128 = 16, 32)
K7_CASES = {
    (1, 0): (16, 8_192, 16),       # 233,472 // 9,216 = 25
    (1, 1): (17, 8_704, 16),       # // 9,728 = 24
    (1, 10): (26, 13_312, 16),     # // 14,336 = 16
    (1, 32): (48, 24_576, 9),      # // 25,600 = 9
    (3, 0): (32, 16_384, 13),      # // 17,408 = 13
    (3, 1): (35, 17_920, 12),      # // 18,944 = 12
    (3, 10): (62, 31_744, 7),      # the defaults: // 32,768 = 7
    (3, 32): (128, 65_536, 3),     # // 66,560 = 3
    (8, 0): (72, 36_864, 6),       # // 37,888 = 6
    (8, 1): (80, 40_960, 5),       # // 41,984 = 5
    (8, 10): (152, 77_824, 2),     # // 78,848 = 2: 256 threads
}


@pytest.mark.parametrize("m1, lt", list(K7_CASES))
def test_k7_plan_matches_a_hand_count(m1, lt):
    words, nbytes, blocks = K7_CASES[m1, lt]
    assert tek.IM_K7_CHUNKS[0] == 4 and tek.IM_K7_THREADS[0] == 128
    assert tek.IM_K7_RESIDENT == 256
    plan = tek._im_k7_plan(m1, lt)
    assert plan == tek.ImK7Plan(threads=128, words=words, stage=lt * m1, chunk=4,
                                bytes=nbytes, blocks_per_sm=blocks)
    assert plan.words == plan.stage + 2 * plan.chunk * (m1 + 1)
    assert plan.bytes <= tek.SMEM_OPTIN_BYTES
    assert plan.blocks_per_sm * (plan.bytes + tek.SMEM_PER_BLOCK_RESERVED) <= tek.SMEM_PER_SM


def test_k7_plan_at_the_struct_maxima_holds_the_most_threads():
    """m1 = 8, lt 32: 256 ring words. No layout holds 256 threads an SM; by
    hand, resident threads = blocks x threads:
    - 4 periods (328 words): 128 threads 167,936 B, 1 block (128); 64
      threads 83,968 B, 2 blocks (128); 32 threads 41,984 B, 5 (160);
    - 2 periods (292 words): 128 threads 149,504 B, 1 (128); 64 threads
      74,752 B, 233,472 // 75,776 = 3 blocks (192), the first that holds
      the most; 32 threads 37,376 B, 6 (192);
    - 1 period (274 words): 1 (128), 3 (192), 6 (192)."""
    plan = tek._im_k7_plan(8, 32)
    assert plan == tek.ImK7Plan(threads=64, words=292, stage=256, chunk=2, bytes=74_752,
                                blocks_per_sm=3)
    assert tek._im_k7_plan(8, 32, chunk=4) == tek.ImK7Plan(32, 328, 256, 4, 41_984, 5)
    assert tek._im_k7_plan(8, 32, threads=128).chunk == 4   # 128 threads an SM each


@pytest.mark.parametrize("threads, chunk", [(64, 1), (64, 2), (256, 4), (256, 1)])
def test_k7_plan_at_the_sweeps_block_sizes_and_chunks(threads, chunk):
    """The defaults (m1 = 3, lt = 10) at a forced block size and depth: 30
    ring words and 2 x chunk x 4 staging words a thread."""
    plan = tek._im_k7_plan(3, 10, chunk=chunk, threads=threads)
    words = 30 + 8 * chunk
    nbytes = 4 * words * threads
    blocks = min(tek.SMEM_PER_SM // (nbytes + tek.SMEM_PER_BLOCK_RESERVED),
                 tek.THREADS_PER_SM // threads, tek.BLOCKS_PER_SM)
    assert (plan.threads, plan.words, plan.stage, plan.chunk, plan.bytes,
            plan.blocks_per_sm) == (threads, words, 30, chunk, nbytes, blocks)


def test_k7_refuses_a_layout_no_block_holds():
    # the maxima at 256 threads: one period a buffer is 274 words, 280,576
    # bytes
    with pytest.raises(ValueError, match="fit no block"):
        tek._im_k7_plan(8, 32, threads=256)
    # 128 periods a buffer: 256 + 2 x 128 x 9 = 2,560 words, 327,680 bytes
    # even at 32 threads
    with pytest.raises(ValueError, match="fit no block"):
        tek._im_k7_plan(8, 32, chunk=128)
    with pytest.raises(ValueError, match="at least one period"):
        tek._im_k7_plan(3, 10, chunk=0)
    # 40 periods a buffer hold the maxima at 32 threads alone: 976 words,
    # 124,928 bytes (249,856 at 64)
    plan = tek._im_k7_plan(8, 32, chunk=40)
    assert (plan.threads, plan.bytes) == (32, 124_928)


def test_im_stage_mirrors_the_c_struct():
    fields = _c_struct_fields("im_episode.cu", "ImStage")
    assert fields == [("threads", "int", 1), ("words", "int", 1), ("stage", "int", 1),
                      ("chunk", "int", 1)]
    assert _ctypes_fields(tek._ImStage) == fields
    assert ctypes.sizeof(tek._ImStage) == 16
    st = tek._im_k7_plan(3, 10).struct()
    assert (st.threads, st.words, st.stage, st.chunk) == (128, 62, 30, 4)


def _chain_kwargs(m1, L=None):
    """A chain of m1 stocked stages: the default's values taken in turn
    (lead times ``L`` if given)."""
    d = tim.default_params()

    def cycle(xs, n):
        return tuple(xs[i % len(xs)] for i in range(n))
    return dict(I0=cycle(d.I0, m1), r=cycle(d.r, m1 + 1), k=cycle(d.k, m1 + 1),
                h=cycle(d.h, m1), c=cycle(d.c, m1), L=cycle(d.L, m1) if L is None else L)


def _chain(m1, backlog):
    return tim.default_params(backlog=backlog, **_chain_kwargs(m1))


@pytest.mark.parametrize("m1", [1, 3, 8])
def test_the_wrapper_carries_the_plan(m1):
    params = _chain(m1, True)
    st = tek._im_plan(params, "cpu", False)["k7"]
    plan = tek._im_k7_plan(params.m1, params.lt_max)
    assert (st.threads, st.words, st.stage, st.chunk) == (plan.threads, plan.words,
                                                           plan.stage, plan.chunk)
    assert st.stage == params.m1 * params.lt_max


def test_an_instance_for_each_m1_and_mode():
    """im_episode.cu dispatches K7 to an instance for every m1 up to the
    struct maxima, in backlog and lost sales, streamed and _random."""
    text = (CSRC / "im_episode.cu").read_text()
    assert "k_im_returns<BACKLOG, RANDOM, M1>" in text
    assert "if constexpr (M1 < IM_MAX_M1)\n    return launch_k7_m1<" in text
    for backlog in ("true", "false"):
        for random in ("true", "false"):
            assert f"launch_k7_m1<{backlog}, {random}>" in text
    assert int(re.search(r"#define IM_MAX_M1 (\d+)", (CSRC / "im_step.cuh").read_text())
               .group(1)) == tek.IM_MAX_M1


# ------------------------------------------------- plain K7 against JAX

STEPS, B = 10, 128


@pytest.fixture
def ref():
    """The JAX package's interpret kernels: imported here, not at the top,
    so that the cuda-marked cases run on a machine without JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from or_gym_inventory_tpu.envs import inv_management as jim
    from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek
    return types.SimpleNamespace(jnp=jnp, jim=jim, jek=jek)


# (backlog, lead times as a function of m1: None cycles the default's)
K7_JAX_CASES = {"backlog": (True, None), "lt0": (True, lambda m1: (0,) * m1),
                "lost_sales": (False, None)}


@pytest.mark.parametrize("case", list(K7_JAX_CASES))
@pytest.mark.parametrize("m1", [1, 8])
def test_plain_k7_matches_jax_interpret(ref, m1, case):
    backlog, lead = K7_JAX_CASES[case]
    jp = ref.jim.default_params(periods=STEPS, backlog=backlog,
                                **_chain_kwargs(m1, None if lead is None else lead(m1)))
    tp = interop.im_params_from_numpy(dataclasses.asdict(jp))
    assert (tp.m1, tp.backlog, tp.periods) == (m1, backlog, STEPS)
    assert (tp.lt_max == 0) == (case == "lt0")
    r = np.random.default_rng(11 + m1)
    c = np.asarray(tp.c)[None, :, None]
    acts = r.integers(-20, c + 30, (STEPS, m1, B)).astype(np.int32)
    dems = r.poisson(20.0, (STEPS, B)).astype(np.int32)
    got = tek.episode_returns_im(tp, torch.from_numpy(acts), torch.from_numpy(dems))
    want = np.asarray(ref.jek.episode_returns_im(jp, ref.jnp.asarray(acts),
                                                 ref.jnp.asarray(dems), block=B,
                                                 interpret=True))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


# --------------------------------------------------- K3's thread mapping

def _k3_replica(params, seed, act_hi, batch, num_steps, e0, e1, periods):
    """K3's streams as its threads write them: thread (lane, q) for each of
    the batch lanes and W x ceil(T / periods) rows, q = group x W + episode,
    draws periods [group x periods, group x periods + periods) of its
    (lane, episode) from their own counters (the plain
    ``_draw_period_plain``) and writes them to (T, W, rows, B). Also returns
    how often each (t, w, lane) was written."""
    T = params.topology
    n_ro, n_rt = T.n_reorder, T.n_retail
    plan = tns._device_link_plan(tns._topology_link_specs(T, num_steps), "cpu")
    scale = tns._act_scale(act_hi)
    W = e1 - e0
    groups = -(-num_steps // periods)
    idx = torch.arange(batch * W * groups, dtype=torch.int64)
    q, lane = idx // batch, idx % batch
    w, t0 = q % W, (q // W) * periods
    acts = torch.full((num_steps, W, n_ro, batch), float("nan"))
    dems = torch.full((num_steps, W, n_rt, batch), float("nan"))
    written = torch.zeros((num_steps, W, batch), dtype=torch.int64)
    for k in range(periods):
        t = t0 + k
        for tv in t.unique().tolist():
            if tv >= num_steps:
                continue
            sel = t == tv
            a, d = tns._draw_period_plain(plan, seed, lane[sel], e0 + w[sel], tv, n_ro, scale)
            acts[tv, w[sel], :, lane[sel]] = torch.stack(a).T
            dems[tv, w[sel], :, lane[sel]] = torch.stack(d).T
            written[tv, w[sel], lane[sel]] += 1
    return acts, dems, written


@pytest.mark.parametrize("periods", [1, 2, 4])
@pytest.mark.parametrize("dump_range", [None, (1, 4)])
def test_k3_threads_write_the_whole_dump(periods, dump_range):
    params = tnet.default_params(num_periods=7)
    hi = float(params.topology.order_cap_heuristic * 2)
    batch, E, T = 37, 5, 7
    e0, e1 = dump_range or (0, E)
    acts, dems, written = _k3_replica(params, 2024, hi, batch, T, e0, e1, periods)
    assert bool((written == 1).all())
    want_a, want_d = tns._sample_streams_plain(params, 2024, hi, batch, T, e0, e1, "cpu")
    assert torch.equal(acts, want_a) and torch.equal(dems, want_d)
    got_a, got_d = tns.sample_streams_debug(params, 2024, hi, batch, T, E,
                                            dump_range=dump_range, device="cpu")
    assert torch.equal(got_a, want_a) and torch.equal(got_d, want_d)


def test_k3_launches_a_2d_grid():
    """The source launches a 2-D grid, blocks over the lanes along x and one
    row of blocks for each of the W x k3_groups(T) rows along y (capped at
    the grid's 65,535, the blocks striding over the rest), four periods a
    thread."""
    text = (CSRC / "net_episode.cu").read_text()
    assert "constexpr int kK3Periods = 4;" in text
    assert "const int rows = k3_groups(T) * (e1 - e0);" in text
    assert "const dim3 grid(blocks_for(B), rows < 65535 ? rows : 65535);" in text
    assert "for (int q = blockIdx.y; q < rows; q += gridDim.y) {" in text


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backlog", [True, False])
@pytest.mark.parametrize("m1", range(1, 9))
def test_k7_ragged_on_cuda(cuda, m1, backlog):
    """Every instance, streamed and _random, on 1,000 and 1,025 lanes: equal
    to the plain version and to K8 bit for bit."""
    params = _chain(m1, backlog)
    assert params.m1 == m1
    for batch in (1000, 1025):
        a, d = tek.sample_streams_debug_im(params, 7, batch, device=cuda)
        k8 = tek.episode_returns_im_fused(params, 7, batch, device=cuda)
        k7 = tek.episode_returns_im(params, a, d)
        k7r = tek.episode_returns_im_random(params, d, 7)
        assert torch.equal(k7, tek._episode_returns_im_plain(params, a, d))
        assert torch.equal(k7r, tek._episode_returns_im_plain(params, None, d, 7))
        assert torch.equal(k7, k8) and torch.equal(k7r, k8)


@pytest.mark.cuda
def test_k3_ragged_dump_range_on_cuda(cuda):
    params = tnet.default_params(num_periods=30)
    hi = float(params.topology.order_cap_heuristic * 2)
    got = tns.sample_streams_debug(params, 2024, hi, 1000, 30, 5, dump_range=(1, 4),
                                   device=cuda)
    want = tns._sample_streams_plain(params, 2024, hi, 1000, 30, 1, 4, cuda)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
