"""K13 (``episode_kernels.episode_returns_nv`` and
``episode_returns_nv_random``) with its pipeline in registers and its
streams staged into shared memory, as far as the CPU reaches it.

- K13's launch plan (``episode_kernels._nv_k13_plan``): two staging
  buffers of ``NV_K13_CHUNK`` periods of 2 words a thread (1 for
  ``_random``), by hand-counted words, bytes and blocks an SM at 32, 64,
  128 and 256 threads; its refusals; the block the wrapper's ``_nv_plan``
  carries in ``struct NvParams``; the chunk it mirrors from the source; an
  instance for each mode and each lead time from 0 to ``NV_MAX_L`` in the
  source, the C entry's parameters unchanged.
- A replica of K13's threads: each lane's column of the block's shared
  memory (the two buffers, [word][thread]) filled with NaN before the
  launch, the chunks staged and stepped as the kernel does (the next chunk
  copied into the other buffer before this one is stepped; RANDOM's orders
  drawn for the chunk at its start) with the pipeline a shift register,
  equal to the plain version bit for bit at L = 0, 5 and 32, chunks of 1,
  3, 8 and 64 periods (a last chunk cut short, one chunk for the whole
  episode) and both modes. A slot read before it is written, or
  overwritten before it is read, shows as NaN or as another period's word.

The cuda-marked cases hold K13 on ragged batches (1,000 and 1,025 lanes)
at L = 0, 5 and 32, streamed and ``_random``, against the plain version
(``rtol=1e-5, atol=1e-2``, as chip_smoke.py holds it) and, on K17's
streams, K13 and K13 ``_random`` equal to K16 bit for bit (one step, one
order of sums; the same words).
"""

import re

import pytest
import torch
from test_torch_net_k2_plan import CSRC

from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import rng

# (random, threads) -> (words a thread, bytes a block, blocks an SM), by
# hand: words = 2 x 8 x (1 if random else 2); bytes = 4 x words x threads;
# blocks = min(233,472 // (bytes + 1,024), 2,048 // threads, 32)
K13_CASES = {
    (False, 128): (32, 16_384, 13),    # 233,472 // 17,408 = 13: the entry points' launch
    (True, 128): (16, 8_192, 16),      # // 9,216 = 25; 2,048 // 128 = 16
    (False, 64): (32, 8_192, 25),      # // 9,216 = 25; 32
    (False, 256): (32, 32_768, 6),     # // 33,792 = 6; 8
    (True, 32): (16, 2_048, 32),       # // 3,072 = 76; 64; 32 blocks
}


@pytest.mark.parametrize("random, threads", list(K13_CASES))
def test_k13_plan_matches_a_hand_count(random, threads):
    words, nbytes, blocks = K13_CASES[random, threads]
    plan = tek._nv_k13_plan(random, threads)
    assert (plan.threads, plan.chunk, plan.per_period) == (threads, 8, 1 if random else 2)
    assert (plan.words, plan.bytes, plan.blocks_per_sm) == (words, nbytes, blocks)


def test_k13_plan_refusals():
    for threads in (0, 48, 2048):
        with pytest.raises(ValueError, match="whole warps"):
            tek._nv_k13_plan(False, threads)


@pytest.mark.parametrize("L", [0, 5, 32])
def test_the_wrapper_carries_the_plan(L):
    params = tnv.default_params(lead_time=L)
    st = tek._nv_plan(params, "cpu")["struct"]
    assert (st.L, st.k13_threads) == (L, tek.NV_K13_THREADS)
    # K14-K17's table plan is untouched by K13's field
    assert st.threads == tek._nv_table_plan(st.K).threads


def test_an_instance_for_each_mode_and_lead_time():
    """nv_episode.cu holds K13 as one template over RANDOM and L, dispatched
    to the instance for the params' L from 0 to NV_MAX_L in both modes, its
    pipeline a shift register, and past NV_MAX_L to the column instance (L =
    kK13Column), its pipeline in the thread's column after the staging
    buffers; its streams copied by cp.async in chunks of NV_K13_CHUNK
    periods; the C entry keeps its parameters."""
    text = (CSRC / "nv_episode.cu").read_text()
    body = text[text.index("__global__ void k_nv_returns"):
                text.index("template <bool ECON_IN, bool DUMP, bool TABLE>\n__global__")]
    assert "template <bool RANDOM, int L>\n__global__ void k_nv_returns" in text
    assert "nv_step_shift<L>(" in body and "cp_async4(" in body
    assert "NvEpisode" not in body
    assert "constexpr int kK13Column = -1;" in text
    assert ("if constexpr (L == kK13Column)\n        reward = nv_step_ring(p, col, head"
            in body)
    assert "const NvSharedRing col{stage + 2 * kK13Chunk * kWords * n, n};" in body
    assert f"constexpr int kK13Chunk = {tek.NV_K13_CHUNK};" in text
    for random in ("true", "false"):
        assert f"launch_k13<{random}>(*p" in text
    assert "if constexpr (L == NV_MAX_L)\n    return launch_k13<RANDOM, kK13Column>" in text
    assert "else if constexpr (L != kK13Column)\n    return launch_k13<RANDOM, L + 1>" in text
    assert "(L == kK13Column ? p.L : 0)" in text
    assert "kernel<<<blocks, p.k13_threads, smem, stream>>>" in text
    assert int(re.search(r"#define NV_MAX_L (\d+)", (CSRC / "nv_step.cuh").read_text())
               .group(1)) == tek.NV_MAX_L
    sig = re.search(r"int nv_episode_returns\((.*?)\)", text, re.S).group(1)
    assert [a.split()[-1].lstrip("*") for a in sig.split(",")] == [
        "p", "econ", "acts", "dems", "disc", "out", "seed", "random", "B", "T", "stream"]


# ---------------------------------------------------- K13's thread walk

def _k13_replica(params, econ, acts, dems, chunk, seed=None):
    """K13's returns as its threads compute them: the columns of every lane
    as one (words, B) tensor of NaN (a thread touches only its column, so
    the blocks do not matter), buffer ``buf`` at buf x chunk x w words, a
    period's order word then its demand word (w = 2; w = 1 with ``acts``
    None: the demand alone, the chunk's orders drawn at its start); the
    step ``_nv_step_math`` on the pipeline as a list, the oldest first."""
    T, B = dems.shape
    w = 1 if acts is None else 2
    smem = torch.full((2 * chunk * w, B), float("nan"))
    lanes = torch.arange(B, dtype=torch.int64)
    discs = tek._discounts(params.gamma, T)

    def copy_chunk(t0, buf):
        for i in range(chunk):
            if t0 + i < T:
                if w == 2:
                    smem[buf * chunk * w + 2 * i] = acts[t0 + i]
                smem[buf * chunk * w + w * i + w - 1] = dems[t0 + i]

    P = [torch.zeros(B)] * params.lead_time
    total = torch.zeros(B)
    price, cost, h, k = econ[:4]
    copy_chunk(0, 0)
    for t0, buf in zip(range(0, T, chunk), [0, 1] * T):
        if t0 + chunk < T:
            copy_chunk(t0 + chunk, buf ^ 1)
        if w == 1:
            orders = [tek._nv_order(params, rng.period_words(seed, lanes, 0, t0 + i, 1)[0])
                      for i in range(chunk)]
        for i in range(min(chunk, T - t0)):
            row = buf * chunk * w + w * i
            order = orders[i] if w == 1 else tnv.clip_order(params, smem[row])
            P, reward, _ = tek._nv_step_math(params, P, price, cost, h, k, order,
                                             smem[row + w - 1])
            total = total + discs[t0 + i] * reward
    return total


@pytest.mark.parametrize("random", [False, True])
@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
@pytest.mark.parametrize("L", [0, 5, 32])
def test_k13_threads_equal_the_plain_version(L, chunk, random):
    params = tnv.default_params(lead_time=L, gamma=0.99)
    T, B = params.step_limit, 37
    g = torch.Generator().manual_seed(L * 10 + chunk)
    econ = torch.stack(tnv.econ_from_uniforms(params, torch.rand(5, B, generator=g)))
    acts = (torch.rand(T, B, generator=g) * 1.2 - 0.1) * float(params.max_order_quantity)
    dems = torch.poisson(econ[4].expand(T, B).contiguous(), generator=g)
    if random:
        got = _k13_replica(params, econ, None, dems, chunk, 9)
        want = tek._episode_returns_nv_plain(params, econ, None, dems, 9)
    else:
        got = _k13_replica(params, econ, acts, dems, chunk)
        want = tek._episode_returns_nv_plain(params, econ, acts, dems)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [0, 5, 32])
def test_k13_ragged_on_cuda(cuda, L):
    """1,000 and 1,025 lanes, streamed and _random: against the plain
    version, and on K17's streams equal to K16 bit for bit."""
    params = tnv.default_params(lead_time=L, step_limit=50, mu_max=200.0, gamma=0.99)
    for batch in (1000, 1025):
        econ, acts, dems = tek.sample_streams_debug_nv_reset(params, 7, batch, 1, cuda)
        econ, acts, dems = econ[0].contiguous(), acts[:, 0].contiguous(), dems[:, 0].contiguous()
        k16 = tek.episode_returns_nv_reset_fused(params, 7, batch, 1, cuda)
        k13 = tek.episode_returns_nv(params, econ, acts, dems)
        k13r = tek.episode_returns_nv_random(params, econ, dems, 7)
        assert torch.equal(k13, k16) and torch.equal(k13r, k16)
        wild = acts * 1.5 - 10.0        # orders past both clip bounds
        torch.testing.assert_close(tek.episode_returns_nv(params, econ, wild, dems),
                                   tek._episode_returns_nv_plain(params, econ, wild, dems),
                                   rtol=1e-5, atol=1e-2)
        torch.testing.assert_close(k13r, tek._episode_returns_nv_plain(params, econ, None,
                                                                       dems, 7),
                                   rtol=1e-5, atol=1e-2)
