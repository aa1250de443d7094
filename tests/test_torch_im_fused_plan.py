"""The launch plan of K8, the InvManagement random-policy returns kernel
(csrc/im_episode.cu ``k_im_returns_fused``), and the ctypes mirror of the
struct it takes.

K8 keeps each thread's ring of fulfilled orders (lt m1 words) in dynamic
shared memory, [word][thread], and its per-stage arrays in registers. The
block size is computed in Python (ops/episode_kernels.py
``_im_fused_plan``) and handed to the kernel as ``struct ImSmem``, so these
tests check it here, without a card: the words and the block size by hand
for m1 = 1, 3 and 8 and lt = 0, 10 and 32 (every pair the struct maxima
allow fits a block), the mirror against the C struct, and the plan the
wrapper's ``_im_plan`` carries. The cuda-marked case holds K8 bit for bit
against its plain version on a ragged batch, for chains of 1, 2, 3 and 8
stocked stages (each m1 its own instance).
"""

import ctypes
import re

import pytest
import torch
from test_torch_net_k2_plan import CSRC, _c_struct_fields, _ctypes_fields

from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.ops import episode_kernels as tek

# (m1, lt) -> (threads, words, bytes a block, blocks an SM), by hand: words
# = lt m1; at each block size t (32 .. 256) the SM holds min(233,472 //
# (4 words t + 1,024), warps by registers // (t / 32), 2,048 // t, 32)
# blocks, with 65,536 // (32 x 32) = 64 warps by registers for the
# instances of m1 = 1, 2 and 3 (32 registers) and 65,536 // (32 x 56) = 36
# for m1 = 8's (54, allocated as 56); the plan takes the most threads, the
# smallest block on a tie
CASES = {
    # no ring: 32 blocks of 64 = 2,048 threads, all an SM holds
    (1, 0): (64, 0, 0, 32),
    # 40 B a thread: 32 blocks of 64 (3,584 B with the reserve) = 2,048
    (1, 10): (64, 10, 2_560, 32),
    # 128 B a thread: 9 blocks of 192 (25,600 B) = 1,728; 128 gives 13 x
    # 128 = 1,664, 96 gives 17 x 96 = 1,632, 224 gives 7 x 224 = 1,568
    (1, 32): (192, 32, 24_576, 9),
    (3, 0): (64, 0, 0, 32),
    # 120 B a thread: 14 blocks of 128 (16,384 B with the reserve) = 1,792;
    # 64 gives 26 x 64 = 1,664, 224 and 256 tie at 1,792
    (3, 10): (128, 30, 15_360, 14),
    # 384 B a thread: 9 blocks of 64 (25,600 B) = 576; 32 gives 17 x 32, 96
    # gives 6 x 96 = 576 (a tie), 128 gives 4 x 128
    (3, 32): (64, 96, 24_576, 9),
    # no ring, 36 warps by registers: 18 blocks of 64 = 1,152 threads (96,
    # 128 and 192 tie, 32 gives 1,024)
    (8, 0): (64, 0, 0, 18),
    # 320 B a thread: 7 blocks of 96 (31,744 B) = 672, tied by 224 (3 x 224)
    (8, 10): (96, 80, 30_720, 7),
    # the maxima, 1 KB a thread: one block of 224 (229,376 B); 256 would need
    # 262,144 B, past a block's 232,448
    (8, 32): (224, 256, 229_376, 1),
}


@pytest.mark.parametrize("m1, lt", list(CASES))
def test_plan_matches_a_hand_count(m1, lt):
    threads, words, nbytes, blocks = CASES[m1, lt]
    plan = tek._im_fused_plan(m1, lt)
    assert plan == tek.ImFusedPlan(threads, words, nbytes, blocks)
    assert plan.bytes <= tek.SMEM_OPTIN_BYTES
    assert plan.blocks_per_sm * (plan.bytes + tek.SMEM_PER_BLOCK_RESERVED) <= tek.SMEM_PER_SM
    regs = tek._IM_FUSED_REGS[m1]
    assert plan.blocks_per_sm * plan.threads * regs <= tek.REGS_PER_SM


def test_the_wrapper_carries_the_plan():
    """The default params (m1 = 3, lt_max = 10) and a two-stage chain."""
    for params in (tim.default_params(), tim.default_params(
            I0=(100, 120), r=(1.5, 1.0, 0.75), k=(0.1, 0.075, 0.05), h=(0.15, 0.10),
            c=(100, 90), L=(3, 5))):
        plan = tek._im_fused_plan(params.m1, params.lt_max)
        lay = tek._im_plan(params, "cpu")["fused"]
        assert (lay.threads, lay.words) == (plan.threads, plan.words)
        assert lay.words == params.m1 * params.lt_max


def test_im_smem_mirror_has_the_c_fields():
    fields = _c_struct_fields("im_episode.cu", "ImSmem")
    assert fields == [("threads", "int", 1), ("words", "int", 1)]
    assert _ctypes_fields(tek._ImSmem) == fields
    assert ctypes.sizeof(tek._ImSmem) == 8


def test_an_instance_for_each_m1():
    """The source dispatches to an instance for every m1 up to the struct
    maxima (IM_MAX_M1 of im_step.cuh), and the plan counts registers for
    each."""
    text = (CSRC / "im_episode.cu").read_text()
    assert "if constexpr (M1 < IM_MAX_M1)" in text and "launch_fused_m1<true>(" in text
    assert int(re.search(r"#define IM_MAX_M1 (\d+)", (CSRC / "im_step.cuh").read_text())
               .group(1)) == tek.IM_MAX_M1
    assert sorted(tek._IM_FUSED_REGS) == list(range(1, tek.IM_MAX_M1 + 1))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _chain(m1, backlog):
    """A chain of m1 stocked stages: the default's values taken in turn."""
    d = tim.default_params()

    def cycle(xs, n):
        return tuple(xs[i % len(xs)] for i in range(n))
    return tim.default_params(backlog=backlog, I0=cycle(d.I0, m1), r=cycle(d.r, m1 + 1),
                              k=cycle(d.k, m1 + 1), h=cycle(d.h, m1), c=cycle(d.c, m1),
                              L=cycle(d.L, m1))


@pytest.mark.cuda
@pytest.mark.parametrize("backlog", [True, False])
@pytest.mark.parametrize("stages", [3, 2, 1, 8])
def test_k8_ragged_batch_on_cuda(cuda, backlog, stages):
    """B x E = 1,000 x 3, not a multiple of the block: bit for bit against
    the plain version, with the instance of each m1."""
    params = _chain(stages, backlog)
    assert params.m1 == stages
    got = tek.episode_returns_im_fused(params, 7, 1000, 3, device=cuda)
    assert torch.equal(got, tek._im_fused_plain(params, 7, 1000, 3, cuda))
