"""The tensor-core MLP tile of the learned-policy returns kernels (K5/K6 in
csrc/net_policy.cu, K11/K12 in csrc/im_policy.cu, on csrc/mlp_tile.cuh):
the packed actor, the tile and shared-memory layout that
ops/episode_kernels.py ``_pack_tile_actor`` / ``_mlp_tile_plan`` compute,
the ctypes mirror of ``struct MlpTile``, and the accuracy of the split
forward pass.

The kernels cannot run here, so what surrounds them is checked on the CPU:
- the layout against hand counts at K5's default 68-64-64-11 actor (a
  demand row and 18 rows of step scratch among the transient rows, 90
  words of NetInvMgmt state a lane) and K11's 33-64-64-3, and at the
  extremes (8 layers, width 256, 32 actions, obs 1), each within the 227
  KB of an H100 block; an actor beyond the maxima raises the first
  design's error, in its words;
- the A fragments read back through the PTX m16n8k8 TF32 layout give each
  layer's weights zero-padded, at the struct's offsets;
- a NumPy emulation of the kernel's forward pass (both operands split in
  three TF32 pieces, the six products per k-step in the kernel's order
  into a fresh sum, FP32 accumulation, tanh between the layers) against
  float64: each layer's product within 1e-6 of sum |W| |X| per element and
  no more than 4x the FP32 product's own error, and the output within 1e-5
  of the FP32 plain forward;
- the same product on a model of the card's tensor core (the terms of an
  mma aligned to the largest and truncated, the sum truncated toward
  zero), on C6's raw actors (PPO's initial actor and the all-normal one)
  over raw obs: within 2x the float32 product's error on every layer,
  where the first design (two pieces, three products into the running
  sum) misses by more;
- a NaN weight in layer 0, 1 or 2 packs as the quiet NaN 0x7fc00000, which
  the split keeps (tests/test_torch_lstm_mma_plan.py), and the plain
  versions, the kernels' oracle, give NaN raws.
The cuda-marked cases hold the kernels against the plain versions on the
card with a NaN weight, a ragged batch (B x E not a multiple of the tile
or of a warp) and an actor too wide for the in-place buffer.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
from test_torch_lstm_mma_plan import (TF32X6_PAIRS, _fp32_product, _fragments_to_matrix,
                                      _mma_6xtf32, _split, _split3)
from test_torch_net_k2_plan import CSRC, _ctypes_fields

from or_gym_inventory_torch.agents import networks, ppo
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import net_inv_management as net
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns

CPU = torch.device("cpu")


def _actor(dims, seed=0):
    g = torch.Generator().manual_seed(seed)
    Ws = tuple(torch.randn(a, b, generator=g) / a ** 0.5 for a, b in zip(dims, dims[1:]))
    bs = tuple(torch.randn(b, generator=g) * 0.1 for b in dims[1:])
    return Ws, bs


def _pack(dims, dem_rows=0, scratch_rows=0, state_words=0, std=None):
    return tek._pack_tile_actor(_actor(dims), std, dims[0], dims[-1], [1.0] * dims[-1], CPU,
                                dem_rows, scratch_rows, state_words)


# widths, demand rows, scratch rows, state words a lane -> lanes, stride,
# activation rows, in place, float offsets (x0, x1, dem, z, scratch,
# state), floats, by hand: rows = max(pad8(obs), pad16(each width),
# pad16(act) + dem + act + scratch); in place when each hidden width pads
# to 16 or 64 (one M-tile or one group of 4) and the actions to 16; the
# transient rows (dem, z, scratch) in H's buffer
# from row pad16(act); the state after the buffers, state words x lanes
CASES = {
    # K5: 72 rows x 72 = 5,184; dem at row 16; + 90 x 64 = 43,776 B
    "k5_default": ([68, 64, 64, 11], 1, 18, 90, 64, 72, 72, True,
                   (0, 0, 1152, 1224, 2016, 5184), 10_944),
    # K11: 64 rows (obs 33 -> 40 < 64); the normals at row 16: 18,432 B
    "k11_default": ([33, 64, 64, 3], 0, 0, 0, 64, 72, 64, True,
                    (0, 0, 1152, 1152, 1368, 4608), 4_608),
    # two 128-wide layers: 2 groups of 4 M-tiles, so two buffers of 128
    # rows; 3 layers end in x1, which holds the transient rows
    "wide_128": ([68, 128, 128, 11], 1, 18, 90, 64, 72, 128, False,
                 (0, 9216, 10368, 10440, 11232, 18432), 24_192),
    # the maxima: 8 layers of 256 and 32 actions, 16 retail links, 48 rows
    # of scratch and 352 words of state; 237,568 B at 64 lanes, so 32 lanes
    "maxima": ([256] * 8 + [32], 16, 48, 352, 32, 40, 256, False,
               (0, 10240, 1280, 1920, 3200, 20480), 31_744),
    # obs 1: one k-step of zero-padded rows
    "obs_1": ([1, 64, 1], 0, 0, 0, 64, 72, 64, True, (0, 0, 1152, 1152, 1224, 4608), 4_608),
    # narrow layers: the transient rows set the buffer's 16 + 1 + 11 + 18 rows
    "transient_rows": ([8, 16, 11], 1, 18, 90, 64, 72, 46, True,
                       (0, 0, 1152, 1224, 2016, 3312), 9_072),
    # a 32-wide layer is two single M-tiles, not one product: two buffers;
    # two layers end in x0
    "two_tiles": ([33, 32, 3], 0, 0, 0, 64, 72, 40, False,
                  (0, 2880, 1152, 1152, 1368, 5760), 5_760),
}
NAMES = ("x0", "x1", "dem", "z", "scratch", "state")


@pytest.mark.parametrize("name", list(CASES))
def test_layout_matches_a_hand_count(name):
    dims, dem, scratch, words, lanes, stride, rows, in_place, offsets, floats = CASES[name]
    st, flat = _pack(dims, dem, scratch, words)
    plan = tek._mlp_tile_plan(dims, dem, scratch, words, lanes)
    assert (plan.lanes, plan.stride, plan.rows, plan.in_place) == (lanes, stride, rows, in_place)
    assert plan.offsets == dict(zip(NAMES, offsets)) and plan.floats == floats
    assert (st.lanes, st.stride, st.s_total) == (lanes, stride, floats)
    assert tuple(getattr(st, f"s_{n}") for n in NAMES) == offsets
    assert 4 * floats <= tek.SMEM_OPTIN_BYTES
    pad8, pad16 = (lambda n: -(-n // 8) * 8), (lambda n: -(-n // 16) * 16)
    at = 0
    for layer, (i, o) in enumerate(zip(dims, dims[1:])):
        assert (st.w[layer], st.b[layer]) == (at, at + pad16(o) * pad8(i))
        at += pad16(o) * pad8(i) + pad16(o)
    assert st.n_layers == len(dims) - 1 and list(st.dims)[:len(dims)] == dims
    assert st.std == -1 and flat.numel() == at


def test_k5_and_k11_entry_points_pack_the_default_layouts():
    """The wrappers' own packs: K5 with the topology's demand row, its step
    scratch (3 x 6 rows) and the 90 words of state that last the episode
    (the 108 of K2's layout without the scratch), K11 with none; five and
    twelve blocks of 64 an SM by shared memory."""
    T = net.default_params(num_periods=30).topology
    st, flat = tns._pack_net_tile_actor(T, _actor([68, 64, 64, 11]), torch.ones(11), CPU)
    assert st.s_total == CASES["k5_default"][-1] and st.std == flat.numel() - 11
    full, compact = tns._shared_layout(T)[0], tns._shared_layout(T, False)[0]
    assert (full.words, compact.words) == (108, 90)
    assert compact.offsets == {"x": 0, "consumed": 6, "arrivals": 6, "sold": 6, "y": 6,
                               "slot": 17, "u": 28, "ring": 29}
    assert (tek.SMEM_PER_SM // (4 * st.s_total + tek.SMEM_PER_BLOCK_RESERVED)) == 5
    p = im.default_params()
    st, _ = tek._pack_tile_actor(_actor([33, 64, 64, 3]), None, 33, 3, tek._half_c(p), CPU)
    assert st.s_total == CASES["k11_default"][-1]
    assert (tek.SMEM_PER_SM // (4 * st.s_total + tek.SMEM_PER_BLOCK_RESERVED)) == 12


@pytest.mark.parametrize("dims", [[33] + [64] * 9 + [3], [33, 257, 3], [33, 64, 33],
                                  [257, 64, 3]])
def test_an_actor_beyond_the_maxima_raises_the_first_designs_error(dims):
    """The first design (``_pack_actor``, tools/ only) keeps its maxima; the
    tile takes the same actors on its general class (MlpTileG) in a
    block's shared memory."""
    with pytest.raises(ValueError, match=r"the kernels take at most 8 layers of "
                                         r"width <= 256 and 32 actions"):
        tek._pack_actor(_actor(dims), None, dims[0], dims[-1], [1.0] * dims[-1], CPU)
    st, _ = tek._pack_tile_actor(_actor(dims), None, dims[0], dims[-1], [1.0] * dims[-1], CPU)
    assert isinstance(st, tek._MlpTileG) and st.n_layers == len(dims) - 1
    assert st.ws_floats == 0 and 4 * st.s_total <= tek.SMEM_OPTIN_BYTES


def test_every_actor_the_first_design_took_still_fits():
    """The first design's cap was its shared memory (weights + two buffers
    of 128 threads); the tile reads the weights from L2, so an actor that
    fit it fits the tile, and so do the ones it refused."""
    for dims in ([68, 256, 256, 11], [68] + [256] * 4 + [11], [256] * 8 + [32]):
        st, _ = _pack(dims, 16, 48, 352)
        assert 4 * st.s_total <= tek.SMEM_OPTIN_BYTES


def test_the_group_is_the_headers():
    text = (CSRC / "mlp_tile.cuh").read_text()
    assert int(re.search(r"#define MLP_TILE_GROUP (\d+)", text).group(1)) == tek._MLP_TILE_GROUP


def _tile_fields():
    """[(name, element type, length)] of struct MlpTile in
    csrc/mlp_tile.cuh, its array lengths from csrc/mlp.cuh's maxima."""
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)",
                                                (CSRC / "mlp.cuh").read_text())}
    text = (CSRC / "mlp_tile.cuh").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct MlpTile \{(.*?)\n\};", text, re.S).group(1))
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, rest = decl.split(None, 1)
        for item in rest.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\w+)(?: \+ (\d+))?\])?", item.strip())
            length = defines[m.group(2)] + int(m.group(3) or 0) if m.group(2) else 1
            fields.append((m.group(1), ctype, length))
    return fields


def test_tile_mirror_has_the_c_fields():
    fields = _tile_fields()
    assert ("dims", "int", tek.MAX_LAYERS + 1) in fields
    assert ("half_hi", "float", tek.MAX_ACT) in fields
    assert _ctypes_fields(tek._MlpTile) == fields
    assert ctypes.sizeof(tek._MlpTile) == 4 * sum(n for _, _, n in fields)


def _padded(W, b):
    """W (in, out) and b as the tile's zero-padded (pad16(out), pad8(in))
    matrix and pad16(out) bias."""
    n_in, n_out = W.shape
    A = np.zeros((-(-n_out // 16) * 16, -(-n_in // 8) * 8), np.float32)
    A[:n_out, :n_in] = W.T.numpy()
    bp = np.zeros(A.shape[0], np.float32)
    bp[:n_out] = b.numpy()
    return A, bp


@pytest.mark.parametrize("dims", [[68, 64, 64, 11], [33, 64, 64, 3], [68, 128, 128, 11], [1, 64, 1]])
def test_fragments_hold_the_zero_padded_weights(dims):
    """Each layer's fragments, read back through the PTX m16n8k8 TF32 A
    layout, are its zero-padded W^T; the bias and the std as given."""
    actor = _actor(dims)
    st, flat = tek._pack_tile_actor(actor, torch.full((dims[-1],), 0.5), dims[0], dims[-1],
                                    [1.0] * dims[-1], CPU)
    for layer, (W, b) in enumerate(zip(*actor)):
        A, bp = _padded(W, b)
        got = _fragments_to_matrix(flat[st.w[layer]:st.w[layer] + A.size], A.shape[0] // 16,
                                   A.shape[1] // 8)
        np.testing.assert_array_equal(got.numpy(), A)
        np.testing.assert_array_equal(flat[st.b[layer]:st.b[layer] + bp.size].numpy(), bp)
    assert torch.equal(flat[st.std:], torch.full((dims[-1],), 0.5))


# ------------------------------------------- the split forward, emulated

def _emulated_forward(st, flat, actor, X):
    """The kernel's forward pass over the obs rows X (obs, lanes) float32:
    per layer the bias read from the packed buffer plus the 6xTF32 product
    (csrc/mma_tf32.cuh, its sums as IEEE FP32) of the padded W, tanh on the
    hidden layers.
    Returns ([(W, input, product)] per layer, the output rows)."""
    dims = list(st.dims)[:st.n_layers + 1]
    x = np.zeros((-(-dims[0] // 8) * 8, X.shape[1]), np.float32)
    x[:dims[0]] = X
    layers = []
    for layer, (W, b) in enumerate(zip(*actor)):
        A, _ = _padded(W, b)
        bp = flat[st.b[layer]:st.b[layer] + A.shape[0]].numpy()
        prod = _mma_6xtf32(A, x[:A.shape[1]])
        layers.append((A, x[:A.shape[1]].copy(), prod))
        y = (prod + bp[:, None]).astype(np.float32)
        x = np.tanh(y).astype(np.float32) if layer < st.n_layers - 1 else y
    return layers, x[:dims[-1]]


@pytest.mark.parametrize("dims, scale", [([68, 64, 64, 11], 60.0), ([33, 64, 64, 3], 40.0)])
def test_3xtf32_forward_keeps_fp32_accuracy(dims, scale):
    """K5's and K11's default widths with an obs-statistics fold (the first
    layer's weights ~1/scale of the init's, the obs integers up to ~3
    scale), 32 lanes."""
    rng = np.random.default_rng(1)
    Ws, bs = _actor(dims)
    Ws = (Ws[0] / scale,) + Ws[1:]
    st, flat = tek._pack_tile_actor((Ws, bs), None, dims[0], dims[-1], [1.0] * dims[-1], CPU)
    X = rng.integers(0, int(3 * scale), size=(dims[0], 32)).astype(np.float32)
    layers, H = _emulated_forward(st, flat, (Ws, bs), X)
    for A, x, prod in layers:
        exact = A.astype(np.float64) @ x.astype(np.float64)
        mag = np.abs(A).astype(np.float64) @ np.abs(x).astype(np.float64)
        err3 = np.abs(prod - exact) / np.maximum(mag, 1e-30)
        err32 = np.abs(_fp32_product(A, x) - exact) / np.maximum(mag, 1e-30)
        assert err3.max() < 1e-6
        assert err3.max() <= 4 * err32.max()
    plain = tek.mlp_forward(tek.kernel_layers((Ws, bs), CPU), "tanh",
                            list(torch.from_numpy(X))).numpy()
    np.testing.assert_allclose(H, plain, rtol=1e-5, atol=1e-5)


# ------------------- the k-step on the card's accumulator, on raw actors

def _rz32(x):
    """float64 x to float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tensor_core_mma(c, A, B):
    """C + A B for one m16n8k8 TF32 mma.sync as the card's tensor core sums
    it, modelled: C and the 8 exact products aligned to the largest term,
    each truncated toward zero at that term's float32 ulp, summed, and the
    sum truncated toward zero to float32 (on an H100 one mma of raw TF32
    operands matched the exact sum rounded to nearest on 55.5% of outputs,
    0.48 ulp toward zero on average: tools/c6_sweep.py's accumulator
    probe)."""
    P = A[:, :, None].astype(np.float64) * B[None, :, :].astype(np.float64)
    terms = np.concatenate([c[:, None, :].astype(np.float64), P], axis=1)
    _, e = np.frexp(np.abs(terms).max(axis=1))
    q = np.ldexp(1.0, e - 24)[:, None, :]
    return _rz32((np.trunc(terms / q) * q).sum(axis=1))


def _layer_on_the_card_model(W, X, b, kernels):
    """W X + b as csrc/mma_tf32.cuh runs it, the bias in the accumulator, on
    ``_tensor_core_mma``: with ``kernels`` the kernels' scheme (both
    operands in three pieces, per k-step the six products of
    ``TF32X6_PAIRS`` into a fresh accumulator added to the running sum in
    IEEE float32), else the first design's (two pieces, A_small B_big,
    A_big B_small, A_big B_big into the running sum)."""
    acc = np.repeat(b[:, None], X.shape[1], 1).astype(np.float32)
    if kernels:
        Wp, Xp = _split3(W), _split3(X)
        pairs = [(Wp[i], Xp[j]) for i, j in TF32X6_PAIRS]
    else:
        (Wb, Ws), (Xb, Xs) = _split(W), _split(X)
        pairs = [(Ws, Xb), (Wb, Xs), (Wb, Xb)]
    for k0 in range(0, W.shape[1], 8):
        sl = slice(k0, k0 + 8)
        if kernels:
            k = np.zeros_like(acc)
            for A, B in pairs:
                k = _tensor_core_mma(k, A[:, sl], B[sl])
            acc = (acc + k).astype(np.float32)
        else:
            for A, B in pairs:
                acc = _tensor_core_mma(acc, A[:, sl], B[sl])
    return acc


# (obs_dim, actions, the scale of the raw obs): K5's, K11's and K19's
C6_FAMILIES = {"net": (68, 11, 400), "im": (33, 3, 200), "nv": (10, 1, 300)}


@pytest.mark.parametrize("kind", ["ppo_init", "gaussian"])
@pytest.mark.parametrize("family", list(C6_FAMILIES))
def test_fresh_kstep_keeps_fp32_accuracy_on_raw_actors(family, kind):
    """C6's raw actors (chip_smoke.py ``c6_actors``) over raw obs, 256
    lanes: each layer's product and bias under the kernels' scheme within 2x
    the float32 product's error per unit of sum |W| |x| + |b| (the float32
    product sequential, the layer's inputs the float64 forward's
    activations); the first design on the same model misses by more on
    the actor's worst layer, the excess C6 measured on the card."""
    from chip_smoke import c6_actors
    obs_dim, act, scale = C6_FAMILIES[family]
    (Ws, bs), _ = c6_actors(obs_dim, act)[kind]
    X = np.random.default_rng(0).integers(0, scale + 1, (obs_dim, 256)).astype(np.float32)
    worst = {True: 0.0, False: 0.0}
    for layer, (Wt, bt) in enumerate(zip(Ws, bs)):
        W, b = Wt.numpy().T.astype(np.float32), bt.numpy().astype(np.float32)
        kp = -(-W.shape[1] // 8) * 8
        Wp = np.zeros((W.shape[0], kp), np.float32)
        Wp[:, :W.shape[1]] = W
        Xp = np.zeros((kp, X.shape[1]), np.float32)
        Xp[:X.shape[0]] = X
        exact = W.astype(np.float64) @ X.astype(np.float64) + b[:, None]
        mag = np.abs(W).astype(np.float64) @ np.abs(X).astype(np.float64) + np.abs(b)[:, None]
        e32 = (np.abs((_fp32_product(W, X) + b[:, None]).astype(np.float32) - exact) / mag).max()
        for kernels in (True, False):
            err = (np.abs(_layer_on_the_card_model(Wp, Xp, b, kernels) - exact) / mag).max()
            worst[kernels] = max(worst[kernels], err / e32)
        X = np.tanh(exact).astype(np.float32)
    assert worst[True] <= 2.0
    assert worst[False] > worst[True]


# ------------------------------------------------------- NaN through the pack

def _nan_actor(dims, layer):
    Ws, bs = _actor(dims, seed=2)
    Ws = list(Ws)
    Ws[layer] = Ws[layer].clone()
    Ws[layer][5, 1] = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)[0]
    return tuple(Ws), bs


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_the_pack_writes_a_nan_weight_as_the_quiet_nan(layer):
    flat = tek._pack_tile_actor(_nan_actor([33, 64, 64, 3], layer), None, 33, 3, [1.0] * 3,
                                CPU)[1]
    assert int(torch.isnan(flat).sum()) == 1
    assert int(flat.view(torch.int32)[torch.isnan(flat)][0]) == tek._QUIET_NAN_BITS


def _nan_rows(layer, act_dim):
    """The actions a NaN at W[5, 1] of ``layer`` (of 3) reaches: every one
    through a hidden layer, action 1 through the output layer."""
    return list(range(act_dim)) if layer < 2 else [1]


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_a_nan_weight_gives_nan_raws_in_the_plain_versions(layer):
    """What the kernels must match: a NaN weight makes the raws it reaches
    NaN (all of them through a hidden layer), so K11's actions there cast to
    0 and K5's are NaN."""
    p = im.default_params()
    actor = _nan_actor([33, 64, 64, 3], layer)
    rows = _nan_rows(layer, 3)
    ret, acts, _ = tek._im_policy_plain(p, actor, None, 4, 16, 2, CPU, True)
    assert torch.isfinite(ret).all() and int(acts[:, :, rows].abs().max()) == 0
    plan = tek._im_host_plan(p, "cpu")
    inv, _, RH = tek._im_reset_rows(p, 16, CPU)
    _, raw, _ = tek._im_policy_period_plain(p, plan, tek.kernel_layers(actor, CPU), None, 4,
                                            torch.arange(16), 0, 0, inv, list(RH))
    assert torch.isnan(raw[rows]).all() and bool(torch.isnan(raw).all()) == (layer < 2)
    np_ = net.default_params(num_periods=5)
    T = np_.topology
    _, acts5, _ = tns._policy_returns_plain(np_, _nan_actor([T.obs_dim, 64, 64, 11], layer),
                                            None, 4, 16, 2, CPU, True)
    assert torch.isnan(acts5[:, :, _nan_rows(layer, 11)]).all()


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _folded(obs_dim, act_dim, arch, dev, seed=3):
    g = torch.Generator().manual_seed(seed)
    model = networks.MLPActorCritic(obs_dim, act_dim, pi_arch=arch, generator=g)
    rms = ppo.RunningMeanStd(mean=50.0 + 5.0 * torch.randn(obs_dim, generator=g),
                             var=(20.0 + 5.0 * torch.rand(obs_dim, generator=g)) ** 2,
                             count=torch.tensor(1e3))
    Ws, bs = tek.fold_actor_params(ppo.PPOConfig(), model, rms)
    return tuple(W.to(dev) for W in Ws), tuple(b.to(dev) for b in bs)


def _share(got, want, rtol=1e-4, atol=1e-2):
    ok = (got.double() - want.double()).abs() <= atol + rtol * want.double().abs()
    return float(ok.reshape(-1, got.shape[-1]).all(0).double().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [(64, 64), (128, 128)])
@pytest.mark.parametrize("stochastic", [False, True])
def test_k5_k6_ragged_batch_on_cuda(cuda, arch, stochastic):
    """B x E = 1,000 x 3: not a multiple of the 64-lane tile nor of a warp;
    the 128-wide actor runs two ping-pong buffers."""
    params = net.default_params(num_periods=30)
    T = params.topology
    actor = _folded(T.obs_dim, T.n_reorder, arch, cuda)
    log_std = torch.full((T.n_reorder,), -0.5, device=cuda) if stochastic else None
    b, E = 1000, 3
    k5 = tns.episode_returns_net_policy(params, actor, 9, b, E, log_std, cuda)
    k6, acts, dems = tns.sample_policy_streams_debug_net(params, actor, 9, b, E, log_std, cuda)
    std = None if log_std is None else tek.clipped_std(log_std)
    want, want_a, want_d = tns._policy_returns_plain(params, actor, std, 9, b, E, cuda, True)
    assert torch.equal(k5, k6) and torch.equal(dems, want_d)
    assert _share(k5, want) >= 0.99
    assert _share(acts.permute(0, 2, 1, 3).reshape(-1, E * b),
                  want_a.permute(0, 2, 1, 3).reshape(-1, E * b)) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [(64, 64), (128, 128)])
@pytest.mark.parametrize("stochastic", [False, True])
def test_k11_k12_ragged_batch_on_cuda(cuda, arch, stochastic):
    p = im.default_params()
    actor = _folded(p.pipeline_length, p.m1, arch, cuda)
    log_std = torch.full((p.m1,), -0.7, device=cuda) if stochastic else None
    b, E = 1000, 3
    k11 = tek.episode_returns_im_policy(p, actor, 9, b, E, log_std, cuda)
    r12, acts, dems = tek.sample_policy_streams_debug_im(p, actor, 9, b, E, log_std, cuda)
    std = None if log_std is None else tek.clipped_std(log_std)
    want, want_a, want_d = tek._im_policy_plain(p, actor, std, 9, b, E, cuda, True)
    assert torch.equal(k11, r12) and torch.equal(dems, want_d)
    assert _share(k11, want) >= 0.99
    assert _share(acts.permute(0, 2, 1, 3).reshape(-1, E * b),
                  want_a.permute(0, 2, 1, 3).reshape(-1, E * b)) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 1, 2])
def test_a_nan_weight_gives_nan_raws_on_cuda(cuda, layer):
    """K11's actions and demand the plain version's (the NaN raws cast to
    0), K5's actions NaN where the plain version's are, the demand bit for
    bit."""
    p = im.default_params()
    actor = tuple(tuple(x.to(cuda) for x in part) for part in _nan_actor([33, 64, 64, 3], layer))
    ret, acts, dems = tek.sample_policy_streams_debug_im(p, actor, 4, 300, 2, None, cuda)
    want, want_a, want_d = tek._im_policy_plain(p, actor, None, 4, 300, 2, cuda, True)
    assert torch.equal(dems, want_d) and int(acts[:, :, _nan_rows(layer, 3)].abs().max()) == 0
    assert _share(acts.permute(0, 2, 1, 3).reshape(-1, 600),
                  want_a.permute(0, 2, 1, 3).reshape(-1, 600)) >= 0.99
    assert _share(ret, want, 1e-5, 1e-3) >= 0.99
    params = net.default_params(num_periods=30)
    T = params.topology
    actor5 = tuple(tuple(x.to(cuda) for x in part)
                   for part in _nan_actor([T.obs_dim, 64, 64, T.n_reorder], layer))
    _, acts5, dems5 = tns.sample_policy_streams_debug_net(params, actor5, 4, 300, 2, None, cuda)
    _, want_a5, want_d5 = tns._policy_returns_plain(params, actor5, None, 4, 300, 2, cuda, True)
    assert torch.equal(dems5, want_d5)
    assert torch.equal(torch.isnan(acts5), torch.isnan(want_a5))
    assert torch.isnan(acts5[:, :, _nan_rows(layer, T.n_reorder)]).all()
