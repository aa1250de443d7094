"""The tensor-core LSTM kernels' plan (K22-K24, csrc/lstm.cuh and
csrc/im_lstm.cu): the packed actor, the tile and shared-memory layout that
ops/episode_kernels.py ``_pack_lstm_actor`` computes, the ctypes mirror of
``struct Lstm``, and the accuracy of the 3xTF32 gate product.

The kernels cannot run here, so what surrounds them is checked on the CPU:
- the layout against hand counts at the benchmark widths (obs 33, encoder
  64, hidden 128, 3 actions) and at the extremes, each within the 227 KB of
  an H100 block;
- the A fragments of the gate and encoder weights, read back through the
  m16n8k8 TF32 fragment layout of the PTX ISA (a0 = (gid, tig), a1 =
  (gid + 8, tig), a2 = (gid, tig + 4), a3 = (gid + 8, tig + 4), gid =
  lane / 4, tig = lane % 4), give the weights zero-padded, unit group g's
  M-tiles being [i; f] and [g; o];
- a NumPy emulation of the kernel's product (rounding to TF32 as
  cvt.rna does, by bit arithmetic, the three products in the kernel's order, FP32 accumulation)
  against the float64 product: within 1e-6 of sum |W| |X| per element, and
  no more than 4x the FP32 product's own error;
- a NaN: the split by bit arithmetic turns the canonical NaN 0x7fffffff
  into a zero, so the wrapper packs every NaN weight as the quiet NaN
  0x7fc00000 and the kernel writes its activations through keep_nan; the
  emulated split keeps that NaN, and the plain versions (the kernels' oracle,
  held on the card by the cuda-marked case) give NaN raws and actions 0.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
from test_torch_net_k2_plan import CSRC, _c_struct_fields, _ctypes_fields

from or_gym_inventory_torch.ops import episode_kernels as tek


def _actor(dims, h, act, seed=0):
    g = torch.Generator().manual_seed(seed)
    enc = [(torch.randn(o, i, generator=g) / i ** 0.5, torch.randn(o, 1, generator=g))
           for i, o in zip(dims, dims[1:])]
    e = dims[-1]
    return dict(enc=enc, wx=torch.randn(4 * h, e, generator=g) / e ** 0.5,
                wh=torch.randn(4 * h, h, generator=g) / h ** 0.5,
                bh=torch.randn(4 * h, 1, generator=g), wm=torch.randn(act, h, generator=g),
                bm=torch.randn(act, 1, generator=g))


def _pack(dims, h, act):
    return tek._pack_lstm_actor(_actor(dims, h, act), None, dims[0], act, [1.0] * act, "cpu")


# widths [obs, enc...], hidden, actions -> tile (lanes, warps_m), stride,
# rows (e, h0, h1, x0, x1, m, z) by hand: E padded to 16 (the encoder's
# M-tiles; 8 without an encoder), H to 8, the encoder's inputs to 8 and its
# hidden outputs to 16, the draws' two buffers of act + 1 rows; bytes = 4 *
# stride * sum(rows)
CASES = {
    # the benchmark: 64 + 2 * 128 + 40 + 3 + 8 = 371 rows x 72 = 106,848 B
    "benchmark": ([33, 64], 128, 3, (64, 4), 72, (64, 128, 128, 40, 0, 3, 8)),
    # no encoder: the obs rows (33, padded to 40) are the gate input
    "no_encoder": ([33], 128, 3, (64, 4), 72, (40, 128, 128, 0, 0, 3, 8)),
    # 4 encoder layers: 459 rows x 72 = 132,192 B
    "four_layers": ([33, 64, 64, 64, 64], 128, 3, (64, 4), 72, (64, 128, 128, 64, 64, 3, 8)),
    # hidden 4: one unit group of 8, units 4..7 zero
    "hidden_4": ([33, 64], 4, 3, (64, 4), 72, (64, 8, 8, 40, 0, 3, 8)),
    # 8 actions: 386 rows x 72 = 111,168 B
    "eight_actions": ([33, 64], 128, 8, (64, 4), 72, (64, 128, 128, 40, 0, 8, 18)),
    # wide encoders: 891 rows x 72 = 256,608 B > 227 KB, so 32 lanes (142,560 B)
    "wide_encoder": ([33, 200, 200], 128, 3, (32, 8), 40, (208, 128, 128, 208, 208, 3, 8)),
}
NAMES = ("e", "h0", "h1", "x0", "x1", "m", "z")


@pytest.mark.parametrize("name", list(CASES))
def test_layout_matches_a_hand_count(name):
    dims, h, act, tile, stride, rows = CASES[name]
    st, flat = _pack(dims, h, act)
    assert (st.lanes, st.warps_m, st.threads) == (*tile, tile[0] * tile[1])
    assert st.stride == stride == st.lanes + 8
    assert (st.e_pad, st.h_pad) == rows[:2]
    assert st.k_steps == (st.e_pad + st.h_pad) // 8
    offsets, at = {}, 0
    for n, r in zip(NAMES, rows):
        offsets[n] = at
        at += r * stride
    if len(dims) == 1:
        offsets["x0"] = offsets["e"]
    assert {n: getattr(st, f"s_{n}") for n in NAMES} == offsets
    assert st.s_total == at and 4 * at <= tek.SMEM_OPTIN_BYTES
    assert st.b_gate == 4 * st.h_pad * (st.e_pad + st.h_pad)
    pad8, pad16 = (lambda n: -(-n // 8) * 8), (lambda n: -(-n // 16) * 16)
    n_enc = sum(pad16(o) * pad8(i) + pad16(o) for i, o in zip(dims, dims[1:]))
    assert flat.numel() == st.b_gate + 4 * st.h_pad + n_enc + act * h + act


def test_benchmark_bytes():
    """Two blocks of 64 lanes an SM (2 x (106,848 + 1,024) <= 233,472)."""
    st, _ = _pack([33, 64], 128, 3)
    assert 4 * st.s_total == 106_848
    assert 2 * (4 * st.s_total + tek.SMEM_PER_BLOCK_RESERVED) <= tek.SMEM_PER_SM


def test_an_actor_beyond_a_block_raises():
    with pytest.raises(ValueError, match="bytes of shared memory"):
        _pack([33, 600, 600], 128, 3)
    with pytest.raises(ValueError, match="multiple of 4"):
        _pack([33, 64], 130, 3)


def _fragments_to_matrix(frag, n_tiles, k_steps):
    """The (16 n_tiles, 8 k_steps) A matrix that the packed fragments hold,
    read through the PTX m16n8k8 TF32 A layout."""
    F = frag.reshape(n_tiles, k_steps, 32, 4)
    A = torch.zeros((16 * n_tiles, 8 * k_steps))
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for j, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
            A.view(n_tiles, 16, k_steps, 8)[:, gid + dr, :, tig + dc] = F[:, :, lane, j]
    return A


@pytest.mark.parametrize("name", ["benchmark", "no_encoder", "hidden_4", "wide_encoder"])
def test_fragments_hold_the_zero_padded_weights(name):
    dims, h, act = CASES[name][:3]
    actor = _actor(dims, h, act)
    st, flat = tek._pack_lstm_actor(actor, None, dims[0], act, [1.0] * act, "cpu")
    n_ug, e = st.h_pad // 8, dims[-1]
    A = _fragments_to_matrix(flat[:st.b_gate], 2 * n_ug, st.k_steps)
    W = torch.zeros((4, st.h_pad, st.e_pad + st.h_pad))
    W[:, :h, :e] = actor["wx"].reshape(4, h, e)
    W[:, :h, st.e_pad:st.e_pad + h] = actor["wh"].reshape(4, h, h)
    for mt in range(2 * n_ug):
        ug, s = divmod(mt, 2)
        for r in range(16):
            gate, unit = 2 * s + r // 8, 8 * ug + r % 8
            assert torch.equal(A[16 * mt + r], W[gate, unit]), (mt, r)
    bias = flat[st.b_gate:st.b_gate + 4 * st.h_pad].reshape(st.h_pad, 4)
    assert torch.equal(bias[:h], actor["bh"].reshape(4, h).T)
    assert not bias[h:].any()
    for layer, (W, b) in enumerate(actor["enc"]):
        n_out, n_in = W.shape
        mp, kp = -(-n_out // 16) * 16, -(-n_in // 8) * 8
        A = _fragments_to_matrix(flat[st.w_enc[layer]:st.w_enc[layer] + mp * kp], mp // 16,
                                 kp // 8)
        assert torch.equal(A[:n_out, :n_in], W) and not A[n_out:].any()
        assert not A[:, n_in:].any()
        bp = flat[st.b_enc[layer]:st.b_enc[layer] + mp]
        assert torch.equal(bp[:n_out], b.reshape(-1)) and not bp[n_out:].any()


def test_lstm_mirror_has_the_c_fields():
    fields = _c_struct_fields("lstm.cuh", "Lstm")
    assert _ctypes_fields(tek._Lstm) == fields
    assert ctypes.sizeof(tek._Lstm) == 4 * sum(n for _, _, n in fields)


def test_entry_point_tiles_are_compiled():
    """The tiles the wrapper may pick are im_lstm.cu's LSTM_TILES, no more
    and no fewer (a tile built for no entry point only costs build time),
    and hidden 128 is LSTM_MAX_GROUPS unit groups."""
    text = (CSRC / "im_lstm.cu").read_text()
    macro = re.search(r"#define LSTM_TILES\(X\) (.*)", text).group(1)
    compiled = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", macro)}
    assert set(tek._LSTM_TILES) == compiled
    header = (CSRC / "lstm.cuh").read_text()
    groups = int(re.search(r"#define LSTM_MAX_GROUPS (\d+)", header).group(1))
    assert groups * 8 == tek.LSTM_MAX_HIDDEN


# ------------------------------------------- the 3xTF32 product, emulated

def _tf32_rna(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = _tf32_rna(x)
    return big, _tf32_rna((x - big).astype(np.float32))


def _mma_3xtf32(W, X):
    """G = W X as csrc/lstm.cuh gate_kstep runs it: per k-step of 8, the
    products W_small X_big, W_big X_small, W_big X_big, each an FP32 sum of
    8 exact products added to the FP32 accumulator."""
    Wb, Ws = _split(W)
    Xb, Xs = _split(X)
    acc = np.zeros((W.shape[0], X.shape[1]), np.float32)
    for k0 in range(0, W.shape[1], 8):
        sl = slice(k0, k0 + 8)
        for A, B in ((Ws, Xb), (Wb, Xs), (Wb, Xb)):
            prods = A[:, sl, None].astype(np.float64) * B[None, sl, :]   # exact in f32
            part = np.zeros_like(acc)
            for j in range(8):
                part = (part + prods[:, j].astype(np.float32)).astype(np.float32)
            acc = (acc + part).astype(np.float32)
    return acc


def _fp32_product(W, X):
    acc = np.zeros((W.shape[0], X.shape[1]), np.float32)
    for k in range(W.shape[1]):
        acc = (acc + (W[:, k, None] * X[None, k, :]).astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_product_keeps_fp32_accuracy(seed):
    """At the benchmark's gate shape (512 x 192, 32 lanes): activations in
    [-1, 1] as tanh and H give them, weights at the init's scale."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((512, 192)) / np.sqrt(192)).astype(np.float32)
    X = np.tanh(rng.standard_normal((192, 32)) * 2).astype(np.float32)
    exact = W.astype(np.float64) @ X.astype(np.float64)
    scale = np.abs(W).astype(np.float64) @ np.abs(X).astype(np.float64)
    err3 = np.abs(_mma_3xtf32(W, X) - exact) / scale
    err32 = np.abs(_fp32_product(W, X) - exact) / scale
    assert err3.max() < 1e-6
    assert err3.max() <= 4 * err32.max()
    # one TF32 product alone is ~1e3 times worse: why the split is needed
    one = np.abs(_tf32_rna(W).astype(np.float64) @ _tf32_rna(X) - exact) / scale
    assert one.max() > 100 * err3.max()


# ------------------------------------------------------- NaN through the split

NAN_BITS = {"canonical": 0x7FFFFFFF, "negative": 0xFFFFFFFF, "quiet": 0x7FC00000,
            "low_payload": 0x7F800001}


def _bits(u):
    return np.array([u], np.uint32)


def _kernel_split(x):
    """csrc/lstm.cuh split_tf32 on float32 bits: (big, small) as stored."""
    u = x.view(np.uint32)
    big = ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).astype(np.uint32)
    with np.errstate(invalid="ignore"):
        small = ((x - big.view(np.float32)).view(np.uint32) + np.uint32(0x1000)).astype(np.uint32)
    return big, small


def _keep_nan(x):
    """csrc/lstm.cuh keep_nan: a NaN as the quiet NaN."""
    return np.where(np.isnan(x), _bits(tek._QUIET_NAN_BITS).view(np.float32), x)


def _tensor_core_reads(bits):
    """A TF32 operand as the tensor core reads it: its top 19 bits."""
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("name", list(NAN_BITS))
def test_a_nan_through_keep_nan_stays_a_nan_through_the_split(name):
    """Rounding by bit arithmetic carries the canonical NaN 0x7fffffff (what
    CUDA's arithmetic makes) into the sign bit, a zero; the quiet NaN that
    keep_nan and the wrapper write stays a NaN: the tensor core reads big as
    NaN, and big + small is NaN."""
    x = _bits(NAN_BITS[name]).view(np.float32)
    big, small = _kernel_split(_keep_nan(x))
    assert np.isnan(_tensor_core_reads(big)).all()
    assert np.isnan(_tensor_core_reads(big) + _tensor_core_reads(small)).all()
    if name == "canonical":
        assert _tensor_core_reads(_kernel_split(x)[0])[0] == 0.0


def test_the_kernel_writes_activations_through_keep_nan():
    """The encoder's and the cell's outputs, the split's only operands that
    the kernel computes, pass keep_nan."""
    text = (CSRC / "lstm.cuh").read_text()
    assert text.count("make_float2(keep_nan(tanhf(acc[0][nt]") == 2
    assert "hv[l] = keep_nan(" in text


def test_split_of_finite_values_and_infinities_is_the_rounding():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32),
                        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40], np.float32)])
    big, small = _kernel_split(x)
    np.testing.assert_array_equal(big.view(np.float32), _tf32_rna(x))
    finite = np.isfinite(x)
    want = _tf32_rna((x[finite] - big.view(np.float32)[finite]).astype(np.float32))
    np.testing.assert_array_equal(_tensor_core_reads(small)[finite], want)


def _nan_actor(where):
    actor = _actor([33, 16], 32, 3)
    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)[0]
    if where == "enc":
        actor["enc"][0][0][5, 7] = nan
    else:
        actor[where][10, 3] = nan
    return actor


@pytest.mark.parametrize("where", ["wx", "wh", "enc"])
def test_the_pack_writes_a_nan_weight_as_the_quiet_nan(where):
    flat = tek._pack_lstm_actor(_nan_actor(where), None, 33, 3, [1.0] * 3, "cpu")[1]
    bits = flat.view(torch.int32)
    assert int(torch.isnan(flat).sum()) == 1
    assert int(bits[torch.isnan(flat)][0]) == tek._QUIET_NAN_BITS


@pytest.mark.parametrize("where", ["wx", "wh", "enc"])
def test_a_nan_weight_gives_nan_raws_in_the_plain_versions(where):
    """What the kernels must match: a NaN anywhere in the encoder or the
    gates makes every raw NaN and every action 0 (the cast of a NaN)."""
    from or_gym_inventory_torch.envs import inv_management as im
    tp = im.default_params()
    actor = _nan_actor(where)
    ret, acts, _ = tek._im_lstm_plain(tp, actor, 4, 16, torch.device("cpu"), True)
    std = tek.clipped_std(torch.full((3,), -0.7))
    tr = tek._rollout_traj_im_lstm_plain(tp, actor, std, 4, 16, torch.device("cpu"))
    assert torch.isfinite(ret).all() and int(acts.abs().max()) == 0
    assert torch.isnan(tr["raw"]).all() and int(tr["actions"].abs().max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["wx", "wh", "enc"])
def test_a_nan_weight_gives_nan_raws_on_cuda(where):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from or_gym_inventory_torch.envs import inv_management as im
    dev = torch.device("cuda")
    tp = im.default_params()
    actor = tek._lstm_on(_nan_actor(where), dev)
    log_std = torch.full((3,), -0.7, device=dev)
    ret, acts, dems = tek.sample_lstm_streams_debug_im(tp, actor, 4, 300, device=dev)
    want, want_a, want_d = tek._im_lstm_plain(tp, actor, 4, 300, dev, True)
    assert torch.equal(acts, want_a) and torch.equal(dems, want_d)
    torch.testing.assert_close(ret, want, rtol=1e-5, atol=1e-3)
    tr = tek.rollout_traj_im_lstm(tp, actor, log_std, 4, 300, device=dev)
    ptr = tek._rollout_traj_im_lstm_plain(tp, actor, tek.clipped_std(log_std), 4, 300, dev)
    assert torch.isnan(tr["raw"]).all() and torch.equal(tr["actions"], ptr["actions"])
