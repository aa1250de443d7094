"""The two heads of NetInvMgmt's trajectory kernel (csrc/net_policy.cu):
K29 on the thread-block cluster (``k_rollout_traj_cluster`` on
csrc/cluster_mlp.cuh) and K4 on K5's tensor-core tile
(``k_policy_returns<1, 0, 1>`` on csrc/mlp_tile.cuh), as far as the CPU
reaches them.

- K29's plan (``episode_kernels._cluster_plan`` on
  ``net_step._net_cluster_layout``) at the default graph against a hand
  count, for the det, sac and uniform heads; the route: the first tile that
  fits (4 CTAs over 64 lanes, which K27's layout refuses), the wide route
  for a (512, 512) actor, and the batch route (``net_step._net_route``) by
  the rounds of the card's clusters; the demand rows of a graph with two
  retail links;
- K27/K28's plans byte for byte as they were (the hand counts of
  tests/test_torch_wide_cluster_plan.py, through the explicit layout);
- K29's packed slices read back rank by rank, a NumPy emulation of the
  sliced forward against the plain ``mlp_forward``, and a NaN weight in
  its slice;
- a plain-Python replica of the kernel's ``lane_obs`` (the obs row k of a
  lane from its [word][lane] state) against ``net_step._net_obs_rows``;
- K4's tile plan: its transient rows hold the demand, the normals and the
  step's scratch, and it fits a block at obs 68 and act 11.
The cuda-marked cases hold K4 and K29 against their plain versions on the
card on a ragged batch of 1,000 lanes, and K29's wide and deep-batch
routes.
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_wide_cluster_plan import (CASES, REGIONS, _actor, _emulated_forward, _folded,
                                          _share, _slices)

from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns

CPU = torch.device("cpu")
PARAMS = tnet.default_params(num_periods=30)
TOPO = PARAMS.topology
LAYOUT = tns._net_cluster_layout(TOPO)
WORDS = tns._shared_layout(TOPO)[0].words   # 108: X, scratch, Y, slot, U, rings
DET = (68, 256, 256, 11)
SAC = (68, 256, 256, 22)

# K29's plan at 4 CTAs over 64 lanes (16 a CTA), no padding: layer 0
# [72][64] + 64; layer 1 [256][64] + 64; the output layer [256][16] + 16
# (sac [256][24] + 24); the std, 11 -> 12 (det). Then xo 72 x 64; x0 256 x
# 64; xl 256 x 16; the partial sums (32 x 8 x 16) and the outputs inside
# x0; the demand 16 x 30 x 1; a period's noise 16 x 11 -> 176; the state
# 16 x 108.
PLANS = {
    "det": (DET, True, (4, 64), (72, 256, 256), (64, 64, 16), (64, 64, 16),
            (0, 4672, 21120), (4608, 21056, 25216), 25232, 25244,
            {"xo": 25244, "x0": 29852, "x1": 46236, "xl": 46236, "red": 29852,
             "h": 33948, "dem": 50332, "z": 50812, "q": 50988, "state": 50988}, 52716),
    "sac": (SAC, False, (4, 64), (72, 256, 256), (64, 64, 24), (64, 64, 24),
            (0, 4672, 21120), (4608, 21056, 27264), -1, 27288,
            {"xo": 27288, "x0": 31896, "x1": 48280, "xl": 48280, "red": 31896,
             "h": 35992, "dem": 48280 + 4096, "z": 52856, "q": 53032, "state": 53032}, 54760),
}


@pytest.mark.parametrize("head", sorted(PLANS))
def test_k29_plan_matches_a_hand_count(head):
    dims, std, tile, kin, rows, ws, w, b, std_at, block, offs, floats = PLANS[head]
    plan = tek._cluster_choice(dims, 11, std, 30, WORDS, False, True, LAYOUT)
    assert (plan.cluster, plan.lanes, plan.lanes_cta, plan.stride) == tile + (16, 64)
    assert (plan.kin, plan.rows, plan.ws, plan.w, plan.b) == (kin, rows, ws, w, b)
    assert (plan.std, plan.block, plan.state_words) == (std_at, block, WORDS)
    assert plan.offsets == offs and plan.floats == floats
    assert plan.floats * 4 <= tek.SMEM_OPTIN_BYTES
    # red and h lie in x0, apart, and x0 holds both
    assert offs["red"] + 32 * 8 * 16 == offs["h"]
    assert offs["h"] + 16 * rows[-1] <= offs["x0"] + 256 * 64


def test_k29_uniform_plan_is_one_cta_of_64_lanes():
    """No actor: one CTA over 64 lanes, the episode's demand, its head's
    uniforms (its noise stays the episode's) and the state."""
    plan = tek._cluster_choice(DET, 11, False, 30, WORDS, False, False, LAYOUT)
    assert (plan.cluster, plan.lanes, plan.lanes_cta, plan.block) == (1, 64, 64, 0)
    assert (plan.offsets["dem"], plan.offsets["z"], plan.offsets["state"]) == \
        (0, 64 * 30, 64 * 30 + 64 * 30 * 11)
    assert plan.floats == 64 * 30 + 64 * 30 * 11 + 64 * WORDS
    assert plan.floats * 4 == 119_808


@pytest.mark.parametrize("dims, std, want", [
    (DET, True, {(4, 64): 269_680, (4, 32): 195_824}),
    (SAC, False, {(4, 64): 278_368, (4, 32): 204_256}),
])
def test_k27s_layout_refuses_4_over_64_and_takes_4_over_32(dims, std, want):
    """Under K27's layout with K29's demand and state (each period's noise
    kept, rows padded by 8, the output layer's sums beside x0) a CTA over 16
    lanes does not fit; 4 over 32 does. K29's layout fits 4 over 64."""
    k27 = dataclasses.replace(tek._K27_LAYOUT, dem_rows=TOPO.n_retail)
    for tile, nbytes in want.items():
        assert tek._cluster_plan(dims, 11, std, 30, WORDS, False, *tile, True, k27).floats \
            * 4 == nbytes
    plan = tek._cluster_choice(dims, 11, std, 30, WORDS, False, True, k27)
    assert (plan.cluster, plan.lanes) == (4, 32)
    plan = tek._cluster_choice(dims, 11, std, 30, WORDS, False, True, LAYOUT)
    assert (plan.cluster, plan.lanes) == (4, 64)


@pytest.mark.parametrize("head, upfront", [("det", 231_280), ("sac", 239_456)])
def test_the_episodes_noise_fits_4_over_64_for_det_alone(head, upfront):
    """tools/net_traj_sweep.py's ``k29_upfront`` plan: the episode's noise
    (16 x 30 x 11 floats) in place of a period's; det still fits 4 over 64,
    sac does not and takes 4 over 32."""
    dims, std = (DET, True) if head == "det" else (SAC, False)
    lay = dataclasses.replace(LAYOUT, noise_per_period=False)
    assert tek._cluster_plan(dims, 11, std, 30, WORDS, False, 4, 64, True, lay).floats * 4 \
        == upfront
    plan = tek._cluster_choice(dims, 11, std, 30, WORDS, False, True, lay)
    assert (plan.cluster, plan.lanes) == ((4, 64) if head == "det" else (4, 32))


def test_the_output_sums_leave_x0_without_a_second_hidden_layer():
    """One hidden layer: no x0, so the partial sums and outputs take their
    own regions."""
    plan = tek._cluster_plan((68, 256, 11), 11, True, 30, WORDS, False, 4, 64, True, LAYOUT)
    assert plan.offsets["x0"] == plan.offsets["xl"]   # no whole buffer
    assert plan.offsets["h"] == plan.offsets["red"] + 32 * 8 * 16
    assert plan.offsets["dem"] == plan.offsets["h"] + 16 * 16


def test_k29_wide_route_for_a_512_wide_actor():
    dims = (68, 512, 512, 11)
    assert tek._cluster_choice(dims, 11, True, 30, WORDS, False, True, LAYOUT) is None
    actor = _actor(dims)
    assert tek._pack_cluster_actor(actor, torch.ones(11), 68, 11, "det", [1.0] * 11, 30, WORDS,
                                   False, CPU, LAYOUT) is None
    st, _ = tek._pack_wide_actor(actor, torch.ones(11), 68, 11, "det", [1.0] * 11, CPU)
    assert st.rows == 512


@pytest.mark.parametrize("batch, lanes, held, want", [
    (1_024, 64, 30, "cluster"),     # the learners: 16 tiles, one round
    (1_000, 64, 30, "cluster"),     # ragged
    (15_360, 64, 30, "cluster"),    # 240 tiles: 8 rounds, the last the cluster leads
    (15_361, 64, 30, "wide"),       # 9 rounds
    (65_536, 64, 30, "wide"),       # 35 rounds
    (65_536, 64, 132, "cluster"),   # "uniform": 132 clusters of one CTA, 8 rounds
    (65_536, 64, 0, "wide"),
])
def test_k29_batch_route_by_rounds(batch, lanes, held, want):
    assert tns._NET_CLUSTER_MAX_ROUNDS == 8
    assert tns._net_route(batch, lanes, held) == want


def test_k29_demand_rows_on_two_retail_links():
    """Two retail links: two demands a (lane, period), and the state of
    that graph (_shared_layout with the scratch)."""
    params = tnet.default_params(topology=ttopo.two_retail_topology(30), num_periods=30)
    T = params.topology
    layout = tns._net_cluster_layout(T)
    words = tns._shared_layout(T)[0].words
    assert layout.dem_rows == T.n_retail == 2
    assert words == 4 * T.n_main + 2 * T.n_reorder + T.n_retail + sum(T.ro_L)
    dims = (T.obs_dim, 256, 256, T.n_reorder)
    plan = tek._cluster_choice(dims, T.n_reorder, True, 30, words, False, True, layout)
    lc = plan.lanes_cta
    assert plan.offsets["z"] - plan.offsets["dem"] == -(-lc * 30 * 2 // 4) * 4
    assert plan.offsets["q"] - plan.offsets["z"] == -(-lc * T.n_reorder // 4) * 4
    assert plan.floats - plan.offsets["state"] == -(-lc * words // 4) * 4


@pytest.mark.parametrize("name", sorted(CASES))
def test_k27_k28_plans_are_byte_for_byte_as_they_were(name):
    """K27's layout, given explicitly, is the default, and every hand count
    of K27/K28's plans still holds through it."""
    (dims, act, std, T, words, anchors, C, N, kin, rows, ws, w, b, std_at, block, offs,
     floats) = CASES[name]
    plan = tek._cluster_plan(dims, act, std, T, words, anchors, C, N, True, tek._K27_LAYOUT)
    assert plan == tek._cluster_plan(dims, act, std, T, words, anchors, C, N)
    assert tek._K27_LAYOUT == tek.ClusterLayout(1, 8, False, False)
    assert (plan.stride, plan.kin, plan.rows, plan.ws, plan.w, plan.b) == \
        (N + 8, kin, rows, ws, w, b)
    assert (plan.std, plan.block) == (std_at, block)
    assert tuple(plan.offsets[k] for k in REGIONS) == offs and plan.floats == floats


def _k29_pack(dims, policy, actor=None):
    act = 11
    actor = _actor(dims) if actor is None else actor
    std = torch.full((act,), 0.25) if policy == "det" else None
    st, flat = tek._pack_cluster_actor(actor, std, dims[0], act, policy,
                                       [float(i + 1) for i in range(act)], 30, WORDS, False,
                                       CPU, LAYOUT)
    return actor, std, st, flat


@pytest.mark.parametrize("dims, policy", [(DET, "det"), (SAC, "sac")])
def test_k29_packed_slices_hold_the_actor(dims, policy):
    (Ws, bs), std, st, flat = _k29_pack(dims, policy)
    assert (st.cluster, st.lanes, st.stride, st.head) == (4, 64, 64, tek.HEADS[policy])
    assert flat.numel() == st.cluster * st.block
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
            assert torch.equal(blocks[r, st.std:st.std + 11], std)


@pytest.mark.parametrize("dims, policy", [(DET, "det"), (SAC, "sac")])
def test_k29_sliced_forward_is_the_plain_one(dims, policy):
    actor, _, st, flat = _k29_pack(dims, policy)
    X = np.random.default_rng(4).normal(0.0, 2.0, (dims[0], 129)).astype(np.float32)
    got = _emulated_forward(st, flat, X)
    want = tek.mlp_forward(tek.kernel_layers(actor, CPU), "relu", list(torch.from_numpy(X)))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_k29_nan_weight_lands_in_its_slice(layer):
    """W[layer][5, 40] = NaN (hidden: rank 0's row 40 of R = 64; the output
    layer: row 5, column 0 of every rank's copy) at its place, nowhere else."""
    Ws, bs = _actor(DET)
    Ws = list(Ws)
    Ws[layer] = Ws[layer].clone()
    o = 40 if layer < 2 else 0
    Ws[layer][5, o] = float("nan")
    _, _, st, flat = _k29_pack(DET, "det", (tuple(Ws), bs))
    nan = torch.isnan(flat)
    blocks = nan.reshape(st.cluster, st.block)
    at = st.w[layer] + 5 * st.ws[layer] + o % st.rows[layer]
    if layer < 2:
        assert blocks[o // st.rows[layer], at] and int(nan.sum()) == 1
    else:
        assert blocks[:, at].all() and int(nan.sum()) == st.cluster


def _lane_obs(topo, off, col, k):
    """csrc/net_policy.cu ``lane_obs`` on one lane's words ``col`` (the
    [word] column of its state at net_step._shared_layout's offsets)."""
    if k < topo.n_retail:
        return col[off["u"] + k]
    k -= topo.n_retail
    if k < topo.n_main:
        return col[off["x"] + k]
    k -= topo.n_main
    ring = np.cumsum([0] + list(topo.ro_L))
    i = 0
    while i < topo.n_reorder and k >= ring[i] + topo.ro_L[i]:
        i += 1
    if i == topo.n_reorder:
        return 0.0
    q = int(col[off["slot"] + i]) + k - ring[i]
    if q >= topo.ro_L[i]:
        q -= topo.ro_L[i]
    return col[off["ring"] + ring[i] + q]


@pytest.mark.parametrize("topology, t", [("default", 0), ("default", 7), ("default", 29),
                                         ("two_retail", 3), ("two_retail", 12)])
def test_lane_obs_is_net_obs_rows(topology, t):
    """The kernel's obs row k, read from a lane's ring at slot t % L_i
    (slot (t + j) % L_i holds r[t - L_i + j]), equals ``_net_obs_rows`` of
    the same state, zero rows to pad8 included."""
    topo = TOPO if topology == "default" else ttopo.two_retail_topology(30)
    off = tns._shared_layout(topo)[0].offsets
    n_ro, lt = topo.n_reorder, max(topo.lt_max, 1)
    rng = np.random.default_rng(t)
    X = rng.integers(0, 90, topo.n_main).astype(np.float32)
    U = rng.integers(0, 90, topo.n_retail).astype(np.float32)
    RH = rng.integers(0, 90, lt * n_ro).astype(np.float32)   # newest first: RH[k] = r[t-1-k]
    col = np.zeros(tns._shared_layout(topo)[0].words, np.float32)
    col[off["x"]:off["x"] + topo.n_main] = X
    col[off["u"]:off["u"] + topo.n_retail] = U
    ring = np.cumsum([0] + list(topo.ro_L))
    for i, L in enumerate(topo.ro_L):
        if L == 0:
            continue
        col[off["slot"] + i] = t % L
        for j in range(L):
            col[off["ring"] + ring[i] + (t % L + j) % L] = RH[(L - 1 - j) * n_ro + i]
    want = [float(v) for v in tns._net_obs_rows(topo, list(X), list(U), list(RH))]
    pad = -(-topo.obs_dim // 8) * 8
    got = [float(_lane_obs(topo, off, col, k)) for k in range(pad)]
    assert got == want + [0.0] * (pad - topo.obs_dim)


def test_k4_tile_plan_holds_its_transient_rows():
    """K4 packs as K5 (``_pack_net_tile_actor``): at obs 68 and act 11 the
    tile takes 64 lanes (stride 72), one buffer in place of 72 rows, whose
    rows from pad16(11) = 16 hold the demand (1 row), the normals (11) and
    the step's scratch (3 x 6), 46 rows in all; then the state that lasts
    the episode, 90 words a lane: 43,776 B a block, five blocks an SM."""
    g = torch.Generator().manual_seed(0)
    dims = (68, 64, 64, 11)
    actor = (tuple(torch.randn(a, b, generator=g) for a, b in zip(dims, dims[1:])),
             tuple(torch.randn(b, generator=g) for b in dims[1:]))
    st, flat = tns._pack_net_tile_actor(TOPO, actor, torch.ones(11), CPU)
    S = 72
    assert (st.lanes, st.stride, st.s_x0, st.s_x1) == (64, S, 0, 0)
    assert (st.s_dem, st.s_z, st.s_scratch) == (16 * S, 17 * S, 28 * S)
    assert st.s_scratch + 3 * TOPO.n_main * S <= 72 * S   # 46 rows of the buffer's 72
    words = tns._shared_layout(TOPO, False)[0].words
    assert words == 90 and st.s_state == 72 * S
    assert st.s_total == 72 * S + words * 64 and st.s_total * 4 == 43_776
    assert st.s_total * 4 <= tek.SMEM_OPTIN_BYTES
    blocks = tek.SMEM_PER_SM // (st.s_total * 4 + tek.SMEM_PER_BLOCK_RESERVED)
    assert blocks == 5
    assert st.std >= 0 and torch.equal(flat[st.std:st.std + 11], torch.ones(11))


# --------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tanh_actor(dev, kind):
    """K4's 68-64-64-11 tanh actor: "ppo_init", PPO's initial actor-critic
    (agents.networks) with obs statistics of mean ~50 and std ~20 folded
    into its first layer, as chip_smoke.py phase 7 seeds it; "gaussian",
    Gaussian weights whose first layer normalises obs of mean ~40, std ~15,
    whose actions land anywhere in their range."""
    if kind == "gaussian":
        return _folded((68, 64, 64, 11), dev, 3)
    from or_gym_inventory_torch.agents import networks, ppo
    g = torch.Generator().manual_seed(3)
    model = networks.MLPActorCritic(68, 11, generator=g)
    rms = ppo.RunningMeanStd(mean=50.0 + 5.0 * torch.randn(68, generator=g),
                             var=(20.0 + 5.0 * torch.rand(68, generator=g)) ** 2,
                             count=torch.tensor(1e3))
    Ws, bs = tek.fold_actor_params(ppo.PPOConfig(), model, rms)
    return tuple(W.to(dev) for W in Ws), tuple(b.to(dev) for b in bs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ppo_init", "gaussian"])
def test_k4_ragged_batch_on_cuda(cuda, kind):
    """K4 on 1,000 lanes against its plain version: the demand bit for bit;
    every raw within 1e-4 of the folded actor's mean on K4's own obs plus
    the plain normals of its words (the sums in another order), and K4's
    own actions and demand through the plain step give its x, u, r and
    rewards (rtol=1e-5, atol=1e-3), for either actor. Free-running, a lane
    whose action lands on a rint tie may take the other integer and
    diverge (ROADMAP.md Queue C): PPO's initial actor, whose actions
    saturate, agrees on >= 99% of lanes, as in chip_smoke.py phase 7; the
    Gaussian one's are not held by share."""
    from or_gym_inventory_torch.ops import rng
    actor = _tanh_actor(cuda, kind)
    log_std = torch.full((11,), -0.5, device=cuda)
    std = tek.clipped_std(log_std)
    B, T = 1_000, PARAMS.num_periods
    got = tns.rollout_traj_net(PARAMS, actor, log_std, 9, B, device=cuda)
    want = tns._rollout_traj_plain(PARAMS, actor, std, 9, B, cuda)
    assert torch.equal(got["demand"], want["demand"])
    obs = tnet.assemble_obs_from_streams(PARAMS, got["x"], got["u"], got["r"])
    lanes = torch.arange(B, device=cuda)
    n_rt, n_ro = TOPO.n_retail, TOPO.n_reorder
    for t in range(T):
        w = rng.period_words(9, lanes, 0, t, n_rt + 2 * n_ro, key1=rng.POLICY_KEY)
        z = rng.normal01(torch.stack(w[n_rt:n_rt + n_ro]), torch.stack(w[n_rt + n_ro:]))
        torch.testing.assert_close(got["raw"][t],
                                   tek.folded_actor_mean(actor, obs[t]).T + std * z,
                                   rtol=0.0, atol=1e-4)
    acts = (torch.tanh(got["raw"]) + 1.0) * tns._half_hi(TOPO)
    X, Y, U, RH = tns.init_transposed(PARAMS, B, cuda)
    for t in range(T):
        X, Y, U, RH, rew = tns._batched_step_plain(PARAMS, X, Y, U, RH, acts[t],
                                                   got["demand"][t], t)
        for k, w_k in (("x", X), ("u", U), ("r", RH[:n_ro]), ("reward", rew)):
            torch.testing.assert_close(got[k][t + (k in "xu")], w_k, rtol=1e-5, atol=1e-3)
    if kind == "ppo_init":
        for k in got:
            assert _share(got[k], want[k]) >= 0.99, k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["det", "sac", "uniform"])
def test_k29_ragged_batch_on_cuda(cuda, mode):
    actor = _folded(SAC if mode == "sac" else DET, cuda)
    log_std = torch.full((11,), -2.3, device=cuda)
    got = tns.rollout_traj_net_offpolicy(PARAMS, actor, log_std, 9, 1_000, mode, "relu", cuda)
    assert tns.rollout_traj_net_offpolicy.route == "cluster"
    std = tek.clipped_std(log_std) if mode == "det" else None
    want = tns._rollout_traj_plain(PARAMS, actor, std, 9, 1_000, cuda, mode, "relu")
    assert torch.equal(got["demand"], want["demand"])
    assert float(got["raw"].abs().max()) <= 1.0
    for k in ("raw", "x", "r", "reward"):
        assert _share(got[k], want[k]) >= (0.99 if mode == "uniform" else 0.5), k


@pytest.mark.cuda
@pytest.mark.parametrize("arch, batch", [((512, 512), 1_000), ((256, 256), 65_536)])
def test_k29_wide_routes_on_cuda(cuda, arch, batch):
    """A (512, 512) actor (no CTA holds its slice) and a batch of 35 rounds
    take the first design; its demand is the plain version's."""
    actor = _folded((68,) + arch + (11,), cuda)
    log_std = torch.full((11,), -2.3, device=cuda)
    got = tns.rollout_traj_net_offpolicy(PARAMS, actor, log_std, 9, batch, "det", "relu", cuda)
    assert tns.rollout_traj_net_offpolicy.route == "wide"
    want = tns._rollout_traj_plain(PARAMS, actor, tek.clipped_std(log_std), 9, batch, cuda,
                                   "det", "relu")
    assert torch.equal(got["demand"], want["demand"])
    assert _share(got["raw"], want["raw"]) >= 0.5
