"""The cluster design of the off-policy trajectory kernels K27 and K28
(csrc/cluster_mlp.cuh, launched from csrc/im_policy.cu and
csrc/nv_policy.cu): the launch plan and the packed actor that
ops/episode_kernels.py ``_cluster_plan``, ``_cluster_choice`` and
``_pack_cluster_actor`` compute, and the ctypes mirror of ``struct
ClusterMlp``.

The kernels cannot run here, so what surrounds them is checked on the CPU:
- the plan against hand counts at K27's and K28's defaults (SB3's (256,
  256) actor, C = 4 CTAs over N = 64 lanes), at the other tiles the sweep
  times, a width padded and three hidden layers; the route: the default
  tile, the smaller one where K28's demand rows need it, the wide route
  (csrc/wide_mlp.cuh) for an actor whose slice fits no CTA; "uniform" on
  one CTA;
- the persistent grid's clusters for a given max-active count;
- the ctypes mirror against ``struct ClusterMlp`` parsed from csrc/;
- the packed slices read back, rank by rank, equal to the actor's W^T and
  b, zero-padded; and ``_pack_wide_actor``'s cached gather equal to the
  layout it had;
- a NumPy emulation of the sliced forward pass (each rank's rows of each
  hidden layer from its slice, concatenated, the output layer whole)
  against the plain ``mlp_forward``, within 1e-5 of it (f32 sums in
  another order);
- a NaN weight in each layer lands in the packed slice at its place, and
  the plain version, the kernels' oracle, gives NaN outputs.
The cuda-marked cases hold K27/K28 against their plain versions on the card
on a ragged batch (1,000 lanes, no multiple of a tile) and with a NaN
weight.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
from test_torch_net_k2_plan import CSRC, _ctypes_fields

from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import newsvendor as nv
from or_gym_inventory_torch.ops import episode_kernels as tek

CPU = torch.device("cpu")
K27_DIMS = (33, 256, 256, 3)   # InvManagement backlog's obs_dim, SB3's actor, m1
K28_DIMS = (10, 256, 256, 1)   # Newsvendor lead time 5


def _actor(dims, seed=0):
    g = torch.Generator().manual_seed(seed)
    Ws = tuple(torch.randn(a, b, generator=g) / a ** 0.5 for a, b in zip(dims, dims[1:]))
    bs = tuple(torch.randn(b, generator=g) * 0.1 for b in dims[1:])
    return Ws, bs


# (dims, act, std, T, state words, anchors, cluster, lanes) -> kin, rows,
# ws, w, b, std, block, (xo, x0, x1, xl, red, h, dem, z, q, state), floats;
# by hand: a hidden layer's width padded to 16 C, R = width / C rows a CTA,
# its W slice [kin][R + 8] then R of bias; the output layer
# [kin][pad8(out)] then pad8(out); the std (act floats); every region
# rounded up to 4 floats. Then the obs kin[0] x (N + 8); the outputs of the
# hidden layers but the last, whole, (N + 8) a row, one buffer for one such
# layer, two for more; the last hidden layer's for the CTA's N / C lanes;
# the partial sums 32 groups x 8 x N / C; the outputs pad8(out) x N / C;
# the demand N / C x T; the noise N / C x T x act; K28's anchors 4 x N / C;
# the state N / C x words.
CASES = {
    # K27 det, C = 8 over 64: 40 x 40 + 32; 256 x 40 + 32; 256 x 8 + 8; 3
    # -> 4: block 13,964; xo 40 x 72 = 2,880; x0 256 x 72 = 18,432; no x1;
    # xl 256 x 8; red 2,048; h 64; dem 240; z 720; state 8 x 33 = 264
    "k27_det": (K27_DIMS, 3, True, 30, 33, False, 8, 64,
                (40, 256, 256), (32, 32, 8), (40, 40, 8), (0, 1632, 11904),
                (1600, 11872, 13952), 13960, 13964,
                (13964, 16844, 35276, 35276, 37324, 39372, 39436, 39676, 40396, 40396), 40660),
    # K27 sac: 6 outputs (still pad8 = 8), no std: block 13,960
    "k27_sac": ((33, 256, 256, 6), 3, False, 30, 33, False, 8, 64,
                (40, 256, 256), (32, 32, 8), (40, 40, 8), (0, 1632, 11904),
                (1600, 11872, 13952), -1, 13960,
                (13960, 16840, 35272, 35272, 37320, 39368, 39432, 39672, 40392, 40392), 40656),
    # K28 det: obs 10 -> 16 rows; dem and z 8 x 50; anchors 32; state 8 x 11
    "k28_det": (K28_DIMS, 1, True, 50, 11, True, 8, 64,
                (16, 256, 256), (32, 32, 8), (40, 40, 8), (0, 672, 10944),
                (640, 10912, 12992), 13000, 13004,
                (13004, 14156, 32588, 32588, 34636, 36684, 36748, 37148, 37548, 37580), 37668),
    # 32 lanes: stride 40; 4 lanes a CTA: xl 1,024, red 1,024, h 32
    "k27_c8_n32": (K27_DIMS, 3, True, 30, 33, False, 8, 32,
                   (40, 256, 256), (32, 32, 8), (40, 40, 8), (0, 1632, 11904),
                   (1600, 11872, 13952), 13960, 13964,
                   (13964, 15564, 25804, 25804, 26828, 27852, 27884, 28004, 28364, 28364),
                   28496),
    # 4 CTAs: R = 64 rows, stride 72: 40 x 72 + 64; 256 x 72 + 64
    "k27_c4_n32": (K27_DIMS, 3, True, 30, 33, False, 4, 32,
                   (40, 256, 256), (64, 64, 8), (72, 72, 8), (0, 2944, 21440),
                   (2880, 21376, 23488), 23496, 23500,
                   (23500, 25100, 35340, 35340, 37388, 39436, 39500, 39740, 40460, 40460),
                   40724),
    # the entry points' tile: 4 CTAs over 64 lanes, 16 a CTA
    "k27_c4_n64": (K27_DIMS, 3, True, 30, 33, False, 4, 64,
                   (40, 256, 256), (64, 64, 8), (72, 72, 8), (0, 2944, 21440),
                   (2880, 21376, 23488), 23496, 23500,
                   (23500, 26380, 44812, 44812, 48908, 53004, 53132, 53612, 55052, 55052),
                   55580),
    # a width of 300 pads to 384 at C = 8 (48 rows a CTA, stride 56)
    "k27_width300": ((33, 300, 300, 3), 3, True, 30, 33, False, 8, 64,
                     (40, 384, 384), (48, 48, 8), (56, 56, 8), (0, 2288, 23840),
                     (2240, 23792, 26912), 26920, 26924,
                     (26924, 29804, 57452, 57452, 60524, 62572, 62636, 62876, 63596, 63596),
                     63860),
    # three hidden layers, each padded to 128 (16 rows a CTA, stride 24):
    # two whole buffers of 128 rows, xl 128 x 4
    "k27_three_hidden": ((33, 64, 96, 64, 3), 3, True, 30, 33, False, 8, 32,
                         (40, 128, 128, 128), (16, 16, 16, 8), (24, 24, 24, 8),
                         (0, 976, 4064, 7152), (960, 4048, 7136, 8176), 8184, 8188,
                         (8188, 9788, 14908, 20028, 20540, 21564, 21596, 21716, 22076, 22076),
                         22208),
}
REGIONS = ("xo", "x0", "x1", "xl", "red", "h", "dem", "z", "q", "state")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_a_hand_count(name):
    (dims, act, std, T, words, anchors, C, N, kin, rows, ws, w, b, std_at, block, offs,
     floats) = CASES[name]
    plan = tek._cluster_plan(dims, act, std, T, words, anchors, C, N)
    assert (plan.cluster, plan.lanes, plan.lanes_cta, plan.stride) == (C, N, N // C, N + 8)
    assert (plan.kin, plan.rows, plan.ws, plan.w, plan.b) == (kin, rows, ws, w, b)
    assert (plan.std, plan.block, plan.state_words) == (std_at, block, words)
    assert tuple(plan.offsets[k] for k in REGIONS) == offs
    assert plan.floats == floats
    assert all(v % 4 == 0 for v in list(plan.offsets.values()) + list(w) + list(b)
               + [plan.block])


# (cluster, lanes) -> bytes a CTA of K27's det plan: the four that the
# sweep can launch fit the 232,448 B of an H100 block, the rest do not
TILE_BYTES = {(8, 32): 113_984, (8, 64): 162_640, (8, 128): 259_952,
              (4, 32): 162_896, (4, 64): 222_320, (4, 128): 341_168}


@pytest.mark.parametrize("tile", sorted(TILE_BYTES))
def test_the_sweeps_tiles_and_their_bytes(tile):
    plan = tek._cluster_plan(K27_DIMS, 3, True, 30, 33, False, *tile)
    assert plan.floats * 4 == TILE_BYTES[tile]
    assert (plan.floats * 4 <= tek.SMEM_OPTIN_BYTES) == (tile[1] < 128)


def test_the_entry_points_route():
    """The defaults on C = 4 over N = 64; K28's demand and noise rows of a
    1,000-period horizon (16,000 floats each a CTA of 16 lanes) do not fit
    that tile (327,664 B), but C = 4 over 32 (211,728 B); a (512, 512)
    actor fits no CTA (its second slice alone is 512 x 136 floats at C = 4,
    512 x 72 at C = 8) and takes the wide route, which holds it (2 x 512
    rows x 32 lanes); "uniform" runs on one CTA of 64 lanes, or none where
    its rows do not fit."""
    choice = tek._cluster_choice
    for plan in (choice(K27_DIMS, 3, True, 30, 33, False),
                 choice(K28_DIMS, 1, True, 50, 11, True)):
        assert (plan.cluster, plan.lanes) == (4, 64)
    assert tek._cluster_plan(K28_DIMS, 1, True, 1000, 11, True, 4, 64).floats * 4 == 327_664
    plan = choice(K28_DIMS, 1, True, 1000, 11, True)
    assert (plan.cluster, plan.lanes, plan.floats * 4) == (4, 32, 211_728)
    assert choice((33, 512, 512, 3), 3, True, 30, 33, False) is None
    st, _ = tek._pack_wide_actor(_actor((33, 512, 512, 3)), torch.ones(3), 33, 3, "det",
                                 [1.0] * 3, CPU)
    assert st.rows == 512
    assert tek._pack_cluster_actor(_actor((33, 512, 512, 3)), torch.ones(3), 33, 3, "det",
                                   [1.0] * 3, 30, 33, False, CPU) is None
    uni = choice(K27_DIMS, 3, False, 30, 33, False, actor=False)
    assert (uni.cluster, uni.lanes, uni.lanes_cta, uni.block) == (1, 64, 64, 0)
    assert uni.floats == 64 * 30 + 64 * 30 * 3 + 64 * 33
    uni = choice(K28_DIMS, 1, False, 50, 11, True, actor=False)
    assert (uni.lanes, uni.floats) == (64, 64 * 50 * 2 + 4 * 64 + 64 * 11)
    assert choice(K28_DIMS, 1, False, 20_000, 11, True, actor=False) is None
    # past ClusterMlp's 8 layers the wrappers take the wide route, whose
    # general class (WideMlpG) holds any depth
    deep = _actor((33,) + (8,) * 9 + (3,))
    assert tek._pack_cluster_actor(deep, None, 33, 3, "uniform", [1.0] * 3, 30, 33, False,
                                   CPU) is None
    st, _ = tek._pack_wide_actor(deep, None, 33, 3, "uniform", [1.0] * 3, CPU)
    assert isinstance(st, tek._WideMlpG) and st.n_layers == 10 and st.ws_floats == 0


@pytest.mark.parametrize("cluster, lanes", [(8, 16), (8, 48), (16, 64), (3, 64), (1, 1024)])
def test_a_tile_the_kernels_do_not_take_raises(cluster, lanes):
    with pytest.raises(ValueError, match="no cluster tile"):
        tek._cluster_plan(K27_DIMS, 3, True, 30, 33, False, cluster, lanes)


@pytest.mark.parametrize("batch, max_active, want", [
    (1_024, 16, 16),      # the learners: 16 tiles of 64, one a cluster
    (1_024, 14, 14),      # fewer clusters than tiles: they walk 2 tiles at most
    (65_536, 16, 16),     # 1,024 tiles over the card's clusters
    (1_000, 16, 16),      # ragged: 16 tiles, the last 40 lanes live
    (64, 16, 1),
    (1, 132, 1),
])
def test_the_grid_holds_what_the_card_does(batch, max_active, want):
    assert tek._cluster_grid(-(-batch // 64), max_active) == want


def test_a_card_that_holds_no_cluster_raises():
    with pytest.raises(RuntimeError, match="no cluster"):
        tek._cluster_grid(16, 0)


def test_the_constants_are_the_headers():
    text = (CSRC / "cluster_mlp.cuh").read_text()
    assert int(re.search(r"#define CLUSTER_MAX_SIZE (\d+)", text).group(1)) == \
        tek.CLUSTER_MAX_SIZE
    assert int(re.search(r"constexpr int kClusterThreads = (\d+);", text).group(1)) == \
        tek._CLUSTER_THREADS


def test_the_wide_lanes_are_the_headers():
    """The wide route's lanes a block, which its shared-memory check counts,
    are csrc/wide_mlp.cuh's kWideLanes, fixed there (no build knob)."""
    text = (CSRC / "wide_mlp.cuh").read_text()
    assert re.findall(r"constexpr int kWideLanes = (\d+);", text) == [str(tek._WIDE_LANES)]
    assert "WIDE_LANES" not in text


def _cluster_fields():
    """[(name, element type, length)] of struct ClusterMlp in
    csrc/cluster_mlp.cuh, its array lengths from csrc/wide_mlp.cuh's maxima."""
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)",
                                                (CSRC / "wide_mlp.cuh").read_text())}
    text = (CSRC / "cluster_mlp.cuh").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct ClusterMlp \{(.*?)\n\};", text,
                                             re.S).group(1))
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, rest = decl.split(None, 1)
        for item in rest.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\w+)(?: \+ (\d+))?\])?", item.strip())
            length = defines[m.group(2)] + int(m.group(3) or 0) if m.group(2) else 1
            fields.append((m.group(1), ctype, length))
    return fields


def test_cluster_mirror_has_the_c_fields():
    fields = _cluster_fields()
    assert ("dims", "int", tek.WIDE_MAX_LAYERS + 1) in fields
    assert ("half_hi", "float", tek.WIDE_MAX_ACT) in fields
    assert _ctypes_fields(tek._ClusterMlp) == fields
    assert ctypes.sizeof(tek._ClusterMlp) == 4 * sum(n for _, _, n in fields)


def _pack_at(actor, std, dims, act, policy, half_hi, tile):
    """The struct and packed buffer at another tile than the entry points':
    its plan, struct and gather, as tools/wide_cluster_sweep.py builds them."""
    with_std = std is not None
    plan = tek._cluster_plan(dims, act, with_std, 30, dims[0], False, *tile)
    st = tek._cluster_struct(dims, act, policy, half_hi, plan)
    index = torch.from_numpy(tek._cluster_index(dims, act, with_std, plan))
    return st, tek._gather(actor, std, index, torch.zeros(1), CPU)


def _pack(dims, policy="det", act=None, tile=None, actor=None):
    act = dims[-1] if act is None else act
    actor = _actor(dims) if actor is None else actor
    std = torch.full((act,), 0.25) if policy in ("ppo", "det") else None
    half_hi = [float(i + 1) for i in range(act)]
    if tile is not None:
        return actor, std, _pack_at(actor, std, dims, act, policy, half_hi, tile)
    return actor, std, tek._pack_cluster_actor(actor, std, dims[0], act, policy, half_hi, 30,
                                               dims[0], False, CPU)


@pytest.mark.parametrize("dims, policy", [(K27_DIMS, "det"), ((33, 256, 256, 6), "sac"),
                                          ((33, 200, 300, 3), "ppo")])
def test_the_entry_points_pack_is_their_plans(dims, policy):
    """``_pack_cluster_actor`` (cached per shape) gives the struct and
    buffer that ``_cluster_choice``'s plan gives through ``_cluster_struct``,
    ``_cluster_index`` and the gather: the composition the sweep times at its
    other tiles."""
    actor, std, (st, flat) = _pack(dims, policy, 3)
    plan = tek._cluster_choice(dims, 3, std is not None, 30, dims[0], False)
    st2, flat2 = _pack_at(actor, std, dims, 3, policy, [1.0, 2.0, 3.0],
                          (plan.cluster, plan.lanes))
    assert bytes(st) == bytes(st2)
    assert torch.equal(flat, flat2)


def _slices(st, flat, layer):
    """Layer ``layer``'s W^T (kin, C R) and b (C R) read back from the C
    blocks, rank by rank (the output layer's from rank 0, whole)."""
    R, RS, K = st.rows[layer], st.ws[layer], st.kin[layer]
    hidden = layer < st.n_layers - 1
    blocks = flat.reshape(st.cluster, st.block)
    ranks = range(st.cluster) if hidden else range(1)
    W = torch.cat([blocks[r, st.w[layer]:st.w[layer] + K * RS].reshape(K, RS)[:, :R]
                   for r in ranks], 1)
    b = torch.cat([blocks[r, st.b[layer]:st.b[layer] + R] for r in ranks])
    return W, b


@pytest.mark.parametrize("dims, policy, act, tile", [
    (K27_DIMS, "det", 3, None), ((33, 256, 256, 6), "sac", 3, None),
    (K28_DIMS, "det", 1, None), ((33, 200, 300, 3), "ppo", 3, (8, 32)),
    ((33, 256, 256, 3), "det", 3, (4, 32)), ((12, 40, 3), "det", 3, (8, 32)),
])
def test_the_packed_slices_hold_the_actor(dims, policy, act, tile):
    (Ws, bs), std, (st, flat) = _pack(dims, policy, act, tile)
    assert flat.numel() == st.cluster * st.block
    assert list(st.dims[:len(dims)]) == list(dims) and st.n_layers == len(dims) - 1
    assert st.head == tek.HEADS[policy] and list(st.half_hi[:act]) == [1.0, 2.0, 3.0][:act]
    for layer, (W, b) in enumerate(zip(Ws, bs)):
        Wp, bp = _slices(st, flat, layer)
        n_in, n_out = W.shape
        assert torch.equal(Wp[:n_in, :n_out], W) and not Wp[n_in:].any() \
            and not Wp[:, n_out:].any()
        assert torch.equal(bp[:n_out], b) and not bp[n_out:].any()
    blocks = flat.reshape(st.cluster, st.block)
    if std is None:
        assert st.std == -1
    else:
        for r in range(st.cluster):
            assert torch.equal(blocks[r, st.std:st.std + act], std)


def test_uniform_packs_no_actor():
    _, _, (st, flat) = _pack(K27_DIMS, "uniform")
    assert (st.cluster, st.lanes, st.block, st.std) == (1, 64, 0, -1)
    assert flat.numel() == 1


def test_pack_wide_actor_is_one_cached_gather():
    """The wide route's buffer as the first design packed it: each layer W^T
    (in, out8) then b (out8), then the std; the gather's plan built once."""
    tek._wide_pack_plan.cache_clear()
    for seed in (0, 1):
        (Ws, bs) = actor = _actor((33, 20, 12, 3), seed)
        st, flat = tek._pack_wide_actor(actor, torch.full((3,), 0.5), 33, 3, "det",
                                        [1.0] * 3, CPU)
        parts = []
        for W, b in zip(Ws, bs):
            n8 = -(-W.shape[1] // 8) * 8
            parts += [torch.nn.functional.pad(W, (0, n8 - W.shape[1])).reshape(-1),
                      torch.nn.functional.pad(b, (0, n8 - b.shape[0]))]
        assert torch.equal(flat, torch.cat(parts + [torch.full((3,), 0.5)]))
    assert tek._wide_pack_plan.cache_info().misses == 1


def _emulated_forward(st, flat, X):
    """The cluster's forward pass in NumPy float32 from the packed blocks:
    each rank's R rows of a hidden layer from its own slice (relu), the
    ranks' rows concatenated into the next layer's input, the output layer
    from rank 0's whole copy. X is (obs_dim, B); returns (outputs, B)."""
    blocks = flat.numpy().reshape(st.cluster, st.block)
    H = np.zeros((st.kin[0], X.shape[1]), np.float32)
    H[:X.shape[0]] = X
    for layer in range(st.n_layers):
        R, RS, K = st.rows[layer], st.ws[layer], st.kin[layer]
        hidden = layer < st.n_layers - 1
        outs = []
        for r in range(st.cluster if hidden else 1):
            W = blocks[r, st.w[layer]:st.w[layer] + K * RS].reshape(K, RS)[:, :R]
            b = blocks[r, st.b[layer]:st.b[layer] + R]
            z = W.T @ H + b[:, None]
            outs.append(np.maximum(z, np.float32(0)) if hidden else z)
        H = np.concatenate(outs).astype(np.float32)
    return H[:st.dims[st.n_layers]]


@pytest.mark.parametrize("dims, tile", [(K27_DIMS, None), (K28_DIMS, None),
                                         ((33, 200, 300, 3), (8, 32)),
                                         ((33, 256, 256, 3), (4, 32)),
                                         ((33, 64, 96, 64, 3), (8, 32))])
def test_the_sliced_forward_is_the_plain_one(dims, tile):
    actor, _, (st, flat) = _pack(dims, tile=tile)
    rng = np.random.default_rng(3)
    X = rng.normal(0.0, 2.0, (dims[0], 257)).astype(np.float32)
    got = _emulated_forward(st, flat, X)
    want = tek.mlp_forward(tek.kernel_layers(actor, CPU), "relu", list(torch.from_numpy(X)))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_a_nan_weight_lands_in_its_slice(layer):
    """W[layer][5, 40] = NaN (output 40: rank 0's row 40 at the defaults'
    R = 64 for a hidden layer; the output layer's column 0 of row 5
    otherwise, in every rank's copy): the pack holds it there and nowhere
    else; the plain version gives NaN outputs."""
    Ws, bs = _actor(K27_DIMS)
    Ws = list(Ws)
    Ws[layer] = Ws[layer].clone()
    o = 40 if layer < 2 else 0
    Ws[layer][5, o] = float("nan")
    actor = (tuple(Ws), bs)
    _, _, (st, flat) = _pack(K27_DIMS, actor=actor)
    nan = torch.isnan(flat)
    R = st.rows[layer]
    rank, col = (o // R, o % R) if layer < 2 else (None, o)
    blocks = nan.reshape(st.cluster, st.block)
    at = st.w[layer] + 5 * st.ws[layer] + col
    if rank is None:
        assert blocks[:, at].all() and int(nan.sum()) == st.cluster
    else:
        assert blocks[rank, at] and int(nan.sum()) == 1
    X = [torch.full((64,), 10.0) for _ in range(33)]
    H = tek.mlp_forward(tek.kernel_layers(actor, CPU), "relu", X)
    assert torch.isnan(H).all() if layer < 2 else torch.isnan(H[0]).all()


# --------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _folded(dims, dev, seed=5):
    """A relu actor whose first layer normalises obs of mean ~40, std ~15."""
    Ws, bs = _actor(dims, seed)
    mean = torch.full((dims[0],), 40.0)
    W0 = Ws[0] / 15.0
    b0 = bs[0] - mean @ W0
    return (tuple(W.to(dev) for W in (W0,) + Ws[1:]), tuple(b.to(dev) for b in (b0,) + bs[1:]))


def _share(got, want, rtol=1e-4, atol=1e-2):
    ok = ((got.double() - want.double()).abs() <= atol + rtol * want.double().abs())
    return float(ok.reshape(-1, got.shape[-1]).all(0).double().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "sac", "uniform"])
def test_k27_ragged_batch_on_cuda(cuda, mode):
    p = im.default_params(backlog=True)
    act = 2 * p.m1 if mode == "sac" else p.m1
    actor = _folded((p.pipeline_length, 256, 256, act), cuda)
    log_std = torch.full((p.m1,), -2.3, device=cuda)
    got = tek.rollout_traj_im_offpolicy(p, actor, log_std, 9, 1_000, mode, "relu", cuda)
    std = tek.clipped_std(log_std) if mode == "det" else None
    want = tek._rollout_traj_im_plain(p, actor, std, 9, 1_000, cuda, mode, "relu")
    assert torch.equal(got["demand"], want["demand"])
    for k in ("raw", "actions", "inv", "reward"):
        assert _share(got[k], want[k]) >= 0.99, k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "uniform"])
def test_k28_ragged_batch_on_cuda(cuda, mode):
    p = nv.default_params()
    actor = _folded((p.obs_dim, 256, 256, 1), cuda)
    log_std = torch.full((1,), -2.3, device=cuda)
    got = tek.rollout_traj_nv_offpolicy(p, actor, log_std, 9, 1_000, mode, "relu", cuda)
    std = tek.clipped_std(log_std) if mode == "det" else None
    want = tek._rollout_traj_nv_plain(p, actor, std, 9, 1_000, cuda, mode, "relu")
    assert torch.equal(got["econ"], want["econ"])
    assert float((got["demand"] == want["demand"]).double().mean()) >= 0.9999
    for k in ("raw", "orders", "reward"):
        assert _share(got[k], want[k]) >= (0.99 if mode == "uniform" else 0.5), k


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 1, 2])
def test_a_nan_weight_gives_nan_actions_on_cuda(cuda, layer):
    p = im.default_params(backlog=True)
    Ws, bs = _folded((p.pipeline_length, 256, 256, p.m1), cuda)
    Ws = list(Ws)
    Ws[layer] = Ws[layer].clone()
    Ws[layer][5, 40 if layer < 2 else 0] = float("nan")
    actor = (tuple(Ws), bs)
    got = tek.rollout_traj_im_offpolicy(p, actor, torch.full((p.m1,), -2.3, device=cuda), 9,
                                        1_000, "det", "relu", cuda)
    raw = got["raw"][0]
    assert torch.isnan(raw).all() if layer < 2 else torch.isnan(raw[0]).all()
