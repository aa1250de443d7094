"""K1 (``episode_returns``) and K25 (``batched_step``) on shared-memory
state (csrc/net_episode.cu ``k_episode_returns``, ``k_batched_step``), as
far as the CPU reaches them.

- K1's staged plan (``net_step._k1_plan``): K2's state, then two staging
  buffers of ``K1_CHUNK`` periods of n_ro + n_rt words, by hand-counted
  words, bytes and blocks an SM at 32, 64 and 128 threads a block on the
  default, maxima, custom and two-retail graphs (all of the small size
  class, so no record takes shared memory); the block size the plan takes
  is the first of ``K1_THREADS`` that fits an H100's 227 KB;
- K25's layout (``net_step._k25_plan``, ``_arriving_words``,
  ``_k25_launch``): one ring word for each link with L > 0, the packed
  link record's ``ring`` naming it, none for an L = 0 link;
- a plain-torch replica of K25's indexing on that layout (the lane's words
  copied in, the mask t >= L_i, step_view's one pass in its load order, the
  fulfilled orders straight to RH', RH's rows shifted down) against the JAX
  package's ``batched_step`` in interpret mode over 30 chained periods of
  the custom and two-retail graphs (periods t < L included), state
  ``rtol=1e-5, atol=1e-3`` and reward ``rtol=1e-5, atol=1e-2`` (f32 sums
  in another order);
- the ctypes mirror of ``struct NetStage`` and the two changed C entry
  points' parameter lists; the discount ctypes rounds to f32 as NumPy does.

The cuda-marked cases hold K1 on a ragged 1,000 lanes of all four graphs
against plain, K1 against K2 on K3's streams bit for bit, and K25 on 1,000
lanes with a NaN action lane against plain. JAX is imported by the replica
test's fixture alone, so that those cases run where JAX is not installed.
"""

import ctypes
import dataclasses
import types

import numpy as np
import pytest
import torch
from test_torch_net_k2_plan import _c_struct_fields, _ctypes_fields
from test_torch_ppo_traj_plan import _c_entry_points

from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.utils import interop

PERIODS = 30


@pytest.fixture
def ref():
    """The JAX package, the reference of the replica test: imported here, not
    at the top, so that the cuda-marked cases run on a machine without JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from or_gym_inventory_tpu.envs import net_inv_management as jnet
    from or_gym_inventory_tpu.envs import topology as jtopo
    from or_gym_inventory_tpu.ops import pallas_net_step as pns
    return types.SimpleNamespace(jax=jax, jnp=jnp, jnet=jnet, jtopo=jtopo, pns=pns)

# two_retail_topology's nodes and edges (the port's envs/topology.py; the
# JAX package has no such graph, so both sides compile these)
TWO_RETAIL_NODES = {0: {}, 1: dict(I0=100, h=0.03), 2: dict(I0=90, h=0.025),
                    3: dict(I0=200, h=0.02), 4: dict(I0=300, C=70, o=0.01, v=0.9, h=0.012),
                    5: {}}
TWO_RETAIL_EDGES = [(1, 0, dict(p=2.0, b=0.1, dist_param=dict(lam=20))),
                    (2, 0, dict(p=2.2, b=0.12, dist_param=dict(lam=15))),
                    (3, 1, dict(L=2, p=1.5, g=0.01)), (3, 2, dict(L=0, p=1.4, g=0.02)),
                    (4, 3, dict(L=4, p=1.0, g=0.008)), (4, 2, dict(L=3, p=1.1, g=0.009)),
                    (5, 4, dict(L=0, p=0.15, g=0.0))]


def _maxima_topology(num_periods=PERIODS):
    """A graph at the first design's struct maxima: 16 retailers, each
    selling to the market and buying from two raw-material nodes at lead
    time 8, so 16 main nodes, 32 reorder links, 16 retail links and lead
    times summing to 256."""
    nodes = {0: {}, 17: {}, 18: {}}
    edges = []
    for r in range(1, 17):
        nodes[r] = dict(I0=50 + r, h=0.02)
        edges.append((r, 0, dict(p=2.0, b=0.1, dist_param=dict(lam=10 + r))))
        edges += [(17, r, dict(L=8, p=1.0, g=0.01)), (18, r, dict(L=8, p=1.2, g=0.01))]
    return ttopo.compile_graph(nodes, edges, num_periods)


GRAPHS = {"default": ttopo.default_topology, "maxima": _maxima_topology,
          "custom": ttopo.custom_topology, "two_retail": ttopo.two_retail_topology}

# (n_main, n_ro, n_rt, sum of L); the state's words (K2's plan); the staging
# words, 2 buffers x K1_CHUNK (4) periods x (n_ro + n_rt); then per block size
# (words a thread, bytes a block, blocks an SM), None where no block holds it
K1_CASES = {
    # 108 + 2*4*12 = 204 words: 26,112 / 52,224 / 104,448 bytes
    "default": ((6, 11, 1, 61), 108, 96,
                {32: (204, 26_112, 8), 64: (204, 52_224, 4), 128: (204, 104_448, 2)}),
    # 400 + 2*4*48 = 784 words: 401,408 bytes at 128 threads, past 232,448
    "maxima": ((16, 32, 16, 256), 400, 384,
               {32: (784, 100_352, 2), 64: (784, 200_704, 1), 128: None}),
    # 37 + 2*4*8 = 101 words
    "custom": ((5, 5, 3, 4), 37, 64,
               {32: (101, 12_928, 16), 64: (101, 25_856, 8), 128: (101, 51_712, 4)}),
    # 37 + 2*4*7 = 93 words
    "two_retail": ((4, 5, 2, 9), 37, 56,
                   {32: (93, 11_904, 18), 64: (93, 23_808, 9), 128: (93, 47_616, 4)}),
}


@pytest.mark.parametrize("graph", list(K1_CASES))
@pytest.mark.parametrize("threads", [32, 64, 128])
def test_k1_plan_matches_a_hand_count(graph, threads):
    counts, state_words, stage_words, by_threads = K1_CASES[graph]
    T = GRAPHS[graph](PERIODS)
    assert (T.n_main, T.n_reorder, T.n_retail, sum(T.ro_L)) == counts
    assert tns.K1_CHUNK == 4 and stage_words == 2 * 4 * (counts[1] + counts[2])
    want = by_threads[threads]
    if want is None:
        with pytest.raises(ValueError, match="fits no block"):
            tns._k1_plan(*counts, threads=threads)
        return
    plan = tns._k1_plan(*counts, threads=threads)
    assert (plan.words, plan.bytes, plan.blocks_per_sm) == want
    assert plan.state == tns._shared_state_plan(*counts)
    assert plan.state.words == state_words and plan.stage == state_words
    assert plan.words == state_words + stage_words and plan.chunk == tns.K1_CHUNK
    assert plan.bytes <= tns.SMEM_PER_BLOCK
    assert plan.blocks_per_sm * (plan.bytes + tns.SMEM_PER_BLOCK_RESERVED) <= tns.SMEM_PER_SM


@pytest.mark.parametrize("graph, threads", [("default", 128), ("maxima", 64), ("custom", 128),
                                            ("two_retail", 128)])
def test_k1_takes_the_first_block_size_that_fits(graph, threads):
    T = GRAPHS[graph](PERIODS)
    counts = (T.n_main, T.n_reorder, T.n_retail, sum(T.ro_L))
    plan, lay, st = tns._k1_layout(*counts)
    assert plan.threads == threads == st.threads
    assert (st.words, st.stage, st.chunk) == (plan.words, plan.stage, plan.chunk)
    assert {f: getattr(lay, f) for f in plan.state.offsets} == plan.state.offsets
    assert lay.words == plan.state.words


def test_k1_refuses_a_staging_no_block_holds():
    with pytest.raises(ValueError, match="fits no block"):
        tns._k1_plan(16, 32, 16, 256, chunk=16)
    # eight default regions under one market: 864 + 2*4*96 words at 32
    # threads; a ring of 1,200 words too many beside the staging, and the
    # refusal names the words
    plan = tns._k1_plan(48, 88, 8, 488)
    assert (plan.chunk, plan.threads, plan.words) == (4, 32, 864 + 2 * 4 * 96)
    with pytest.raises(ValueError, match="K1's state and staging needs 2344 words"):
        tns._k1_plan(48, 88, 8, 1_200)
    with pytest.raises(ValueError, match="at least one period"):
        tns._k1_plan(6, 11, 1, 61, chunk=0)


# ------------------------------------------------------------- K25's layout

# (graph, each link's ring word, words of state: 4 n_main + 2 n_ro + n_rt +
# links with L > 0, the staging words n_ro + n_rt)
K25_CASES = {
    # lead times (5, 3, 8, 10, 9, 11, 12, 0, 1, 2, 0): 9 links with L > 0
    "default": ((0, 1, 2, 3, 4, 5, 6, -1, 7, 8, -1), 24 + 22 + 1 + 9, 12),
    # (1, 1, 1, 1, 0)
    "custom": ((0, 1, 2, 3, -1), 20 + 10 + 3 + 4, 8),
    # (2, 0, 3, 4, 0)
    "two_retail": ((0, -1, 1, 2, -1), 16 + 10 + 2 + 3, 7),
}


@pytest.mark.parametrize("graph", list(K25_CASES))
def test_k25_keeps_one_ring_word_per_link_with_a_lead_time(graph):
    words, state_words, stage_words = K25_CASES[graph]
    params = tnet.default_params(topology=GRAPHS[graph](PERIODS), num_periods=PERIODS)
    T = params.topology
    assert tns._arriving_words(T.ro_L) == words
    assert all((k < 0) == (L == 0) for k, L in zip(words, T.ro_L))
    tp, lay, st, lt, out_rows = tns._k25_launch(params, "cpu")
    assert _records(tp).ro_ring == words
    plan = tns._k25_plan(T.n_main, T.n_reorder, T.n_retail, sum(k >= 0 for k in words))
    assert plan.state.words == state_words == lay.words == st.stage
    assert plan.words == state_words + stage_words == st.words
    assert plan.state.offsets["ring"] + sum(k >= 0 for k in words) == state_words
    assert (st.threads, st.chunk) == (tns.THREADS, 1)
    assert lt == max(T.lt_max, 1)
    assert out_rows == (T.n_main, T.n_reorder, T.n_retail, lt * T.n_reorder, 1)
    # the rest of the records are _pack_topology's
    full = tns._pack_topology(params).records().reshape(-1, tns.RECORD_FLOATS)
    full[:T.n_reorder, 3] = words
    assert np.array_equal(full.reshape(-1), tp.records.numpy())
    assert (tp.n_main, tp.n_ro, tp.n_rt, tp.backlog) == (T.n_main, T.n_reorder, T.n_retail,
                                                         int(params.backlog))


def _records(tp):
    """The records of the header ``tp`` (``net_step._topology_on``) read back
    through their ctypes mirrors, as per-field tuples named as the first
    design's struct named them (ro_sup, ..., is_factory, ..., rt_ret, ...)."""
    raw = tp.records.cpu().numpy().tobytes()
    links = (tns._NetLink * tp.n_ro).from_buffer_copy(raw, 0)
    nodes = (tns._NetNode * tp.n_main).from_buffer_copy(raw, ctypes.sizeof(links))
    retail = (tns._NetRetail * tp.n_rt).from_buffer_copy(
        raw, ctypes.sizeof(links) + ctypes.sizeof(nodes))
    out = dict(n_main=tp.n_main, n_ro=tp.n_ro, n_rt=tp.n_rt, backlog=tp.backlog)
    for prefix, recs in (("ro_", links), ("", nodes), ("rt_", retail)):
        for name, _ in recs._type_._fields_:
            out[prefix + name] = tuple(getattr(r, name) for r in recs)
    return types.SimpleNamespace(**out)


def test_net_stage_mirrors_the_c_struct():
    fields = _c_struct_fields("net_episode.cu", "NetStage")
    assert _ctypes_fields(tns._NetStage) == fields == [
        ("words", "int", 1), ("stage", "int", 1), ("chunk", "int", 1), ("threads", "int", 1)]


def test_k1_and_k25_take_their_layouts():
    """K1: topo, the small class's struct, state layout, staging, acts,
    dems, disc, out, B, T, stream; K25: topo, the small struct, state
    layout, staging, the six inputs, the five outputs, disc, t, lt, B,
    stream."""
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    c = _c_entry_points("net_episode")
    assert c["net_episode_returns"][0] == (P,) * 8 + (LL, I, P)
    assert c["net_batched_step"][0] == (P,) * 15 + (F, I, I, LL, P)


@pytest.mark.parametrize("alpha", [0.97, 0.99, 0.5, 1.0 / 3.0])
def test_ctypes_rounds_the_discount_as_numpy(alpha):
    """batched_step hands the double alpha^t to a c_float argument; the plain
    version and the first wrapper took float(np.float32(alpha ** t))."""
    for t in range(200):
        x = float(alpha ** t)
        assert ctypes.c_float(x).value == float(np.float32(x))


# ------------------------------------------ K25's indexing, replayed in torch

def _k25_replica(params, X, Y, U, RH, action, demand, t):
    """K25 on (rows, B) float32 tensors as the kernel indexes its words: each
    lane's column of ``plan.words`` words, X, Y, U, the actions and demand
    and each L > 0 link's arriving order (RH row L - 1) copied in, the ring
    words of links with t < L times 0, the slots 0; then step_view's pass
    (ring word ``tp.ro_ring[i]``), the fulfilled orders into RH' rows
    0..n_ro-1, RH's rows [0, (lt - 1) n_ro) into RH' rows n_ro.., and the
    reward f32(alpha^t) * profit."""
    tp, _, st, lt, _ = tns._k25_launch(params, "cpu")
    tp = _records(tp)
    plan = tns._k25_plan(tp.n_main, tp.n_ro, tp.n_rt,
                         sum(k >= 0 for k in tns._arriving_words(params.topology.ro_L)))
    off, n_ro, n_rt, n_main = plan.state.offsets, tp.n_ro, tp.n_rt, tp.n_main
    W = torch.full((plan.words, X.shape[1]), float("nan"))   # a word never written shows
    W[off["x"]:off["x"] + n_main] = X
    W[off["y"]:off["y"] + n_ro] = Y
    W[off["u"]:off["u"] + n_rt] = U
    W[st.stage:st.stage + n_ro] = action
    W[st.stage + n_ro:st.stage + n_ro + n_rt] = demand
    for i in range(n_ro):
        L = tp.ro_L[i]
        if L > 0:
            W[off["ring"] + tp.ro_ring[i]] = RH[(L - 1) * n_ro + i]
    for i in range(n_ro):
        W[off["slot"] + i] = 0.0
        if tp.ro_L[i] > t:
            W[off["ring"] + tp.ro_ring[i]] *= 0.0
    r = [None] * n_ro
    profit = _step_view(tp, W, off, lambda i: W[st.stage + i],
                        lambda j: W[st.stage + n_ro + j], r)
    RHo = torch.cat([torch.stack(r), RH[:(lt - 1) * n_ro]])
    disc = ctypes.c_float(float(params.alpha ** t)).value
    return (W[off["x"]:off["x"] + n_main].clone(), W[off["y"]:off["y"] + n_ro].clone(),
            W[off["u"]:off["u"] + n_rt].clone(), RHo, disc * profit)


def _step_view(tp, W, off, act, dem, r):
    """net_step.cuh step_view on the word columns W (one per lane), in its
    order: a link's loads, then its stores."""
    zero = torch.zeros(W.shape[1])   # the struct's floats are f32 values already

    def at(field, k):
        return off[field] + k
    for n in range(tp.n_main):
        W[at("consumed", n)] = W[at("arrivals", n)] = W[at("sold", n)] = 0.0
    total = torch.zeros(W.shape[1])
    for i in range(tp.n_ro):
        sup, pur, L = tp.ro_sup[i], tp.ro_pur[i], tp.ro_L[i]
        req = torch.maximum(zero, torch.round(act(i)))
        y_in, arr_in = W[at("y", i)].clone(), W[at("arrivals", pur)].clone()
        if sup >= 0:
            x_sup, used, sold = (W[at(f, sup)].clone() for f in ("x", "consumed", "sold"))
        slot = 0   # K25's slots, all 0 after the copy-in
        if L > 0:
            a = W[off["ring"] + tp.ro_ring[i] + slot].clone()
        f = req
        if sup >= 0:
            avail = torch.maximum(zero, x_sup - used)
            if tp.is_factory[sup]:
                avail = torch.minimum(avail, torch.minimum(torch.full_like(avail, tp.C[sup]),
                                                           tp.v[sup] * avail))
            f = torch.minimum(req, avail)
            W[at("consumed", sup)] = used + f / tp.v[sup]
            W[at("sold", sup)] = sold + f
        else:
            total = total - tp.ro_price[i] * f
        r[i] = f
        if L > 0:
            W[off["ring"] + tp.ro_ring[i] + slot] = f
            W[at("slot", i)] = 0.0 if slot + 1 == L else slot + 1.0
        else:
            a = f
        y = y_in - a + f
        W[at("y", i)] = y
        W[at("arrivals", pur)] = arr_in + a
        total = total - tp.ro_g[i] * torch.maximum(zero, y)
    for n in range(tp.n_main):
        W[at("x", n)] = W[at("x", n)] + W[at("arrivals", n)] - W[at("consumed", n)]
    for j in range(tp.n_rt):
        ret = tp.rt_ret[j]
        to_fill = torch.maximum(zero, torch.round(dem(j))) + W[at("u", j)]
        sl = torch.minimum(to_fill, torch.maximum(zero, W[at("x", ret)]))
        W[at("x", ret)] = W[at("x", ret)] - sl
        W[at("sold", ret)] = W[at("sold", ret)] + sl
        u = to_fill - sl if tp.backlog else torch.zeros_like(sl)
        W[at("u", j)] = u
        total = total + (tp.rt_price[j] * sl - tp.rt_b[j] * u)
    for n in range(tp.n_main):
        HC = tp.h[n] * torch.maximum(zero, W[at("x", n)])
        OC = tp.o[n] * W[at("sold", n)] / tp.v[n] if tp.is_factory[n] else zero
        total = total - (HC + OC)
    return total


def _jax_topology(jtopo, graph):
    if graph == "custom":
        return jtopo.custom_topology(PERIODS)
    T = jtopo.compile_graph(TWO_RETAIL_NODES, TWO_RETAIL_EDGES, PERIODS)
    assert ttopo.compile_graph(TWO_RETAIL_NODES, TWO_RETAIL_EDGES, PERIODS) == \
        ttopo.two_retail_topology(PERIODS)
    return T


@pytest.mark.parametrize("graph", ["custom", "two_retail"])
@pytest.mark.parametrize("backlog", [True, False], ids=["backlog", "lost"])
def test_k25_replica_matches_jax_batched_step(ref, graph, backlog):
    """30 chained periods at 8 lanes, each side on its own outputs, random
    actions on [0, 2 * order cap) and Poisson demand from a NumPy seed; the
    lead times (custom 1, 1, 1, 1, 0; two-retail 2, 0, 3, 4, 0) put the
    first periods at t < L."""
    B = 8
    jnp, pns = ref.jnp, ref.pns
    jp = ref.jnet.NetInvParams(topology=_jax_topology(ref.jtopo, graph), num_periods=PERIODS,
                               backlog=backlog, alpha=0.97)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), PERIODS, backlog, 0.97)
    T = tp.topology
    assert tns._arriving_words(T.ro_L) == K25_CASES[graph][0]
    hi = float(T.order_cap_heuristic * 2)
    rng = np.random.default_rng(7)
    jX, jY, jU, jRH = pns.init_transposed(jp, B)
    mine = tuple(torch.from_numpy(np.array(x, np.float32)) for x in (jX, jY, jU, jRH))
    step = ref.jax.jit(lambda *a: pns.batched_step(jp, *a, block=B, interpret=True))
    for t in range(PERIODS):
        action = rng.uniform(0.0, hi, (T.n_reorder, B)).astype(np.float32)
        demand = rng.poisson(18.0, (T.n_retail, B)).astype(np.float32)
        got = _k25_replica(tp, *mine, torch.from_numpy(action), torch.from_numpy(demand), t)
        jX, jY, jU, jRH, rew = step(jX, jY, jU, jRH, jnp.asarray(action), jnp.asarray(demand),
                                    jnp.asarray(t, jnp.int32))
        for name, a, b in zip(("X", "Y", "U", "RH"), got, (jX, jY, jU, jRH)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3,
                                       err_msg=f"{graph} {name} t={t}")
        np.testing.assert_allclose(got[4].numpy(), np.asarray(rew)[0], rtol=1e-5, atol=1e-2,
                                   err_msg=f"{graph} reward t={t}")
        mine = got[:4]


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_k1_ragged_batch_on_cuda(cuda, graph):
    """K1 on 1,000 lanes (not a multiple of a block or a warp) of each graph,
    the maxima's at 64 threads a block, against plain K1."""
    params = tnet.default_params(topology=GRAPHS[graph](PERIODS), num_periods=PERIODS,
                                 alpha=0.97)
    T = params.topology
    hi = float(T.order_cap_heuristic * 2)
    acts, dems = tns.sample_streams_debug(params, 11, hi, 1_000, device=cuda)
    got = tns.episode_returns(params, acts, dems)
    torch.testing.assert_close(got, tns._episode_returns_plain(params, acts, dems),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["default", "two_retail"])
def test_k1_is_k2_on_k3s_streams_on_cuda(cuda, graph):
    """One episode body (shared_episode over step_view): K1 on the streams K3
    dumps gives K2's returns bit for bit."""
    params = tnet.default_params(topology=GRAPHS[graph](PERIODS), num_periods=PERIODS)
    hi = float(params.topology.order_cap_heuristic * 2)
    acts, dems = tns.sample_streams_debug(params, 5, hi, 1_000, device=cuda)
    k2 = tns.episode_returns_fully_fused(params, 5, hi, 1_000, device=cuda)
    assert torch.equal(tns.episode_returns(params, acts, dems), k2)


@pytest.mark.cuda
def test_k25_with_a_nan_action_lane_on_cuda(cuda):
    """K25 on 1,000 lanes over 12 chained periods, lane 17's actions NaN,
    against plain K25 (NaN where plain has NaN); each output a contiguous
    (rows, B) view."""
    params = tnet.default_params(num_periods=12, alpha=0.97)
    T = params.topology
    B = 1_000
    g = torch.Generator(device=cuda).manual_seed(4)
    X, Y, U, RH = (x.contiguous() for x in tns.init_transposed(params, B, cuda))
    for t in range(12):
        action = torch.rand((T.n_reorder, B), generator=g, device=cuda) * 150.0
        action[:, 17] = float("nan")
        demand = tnet.sample_demand(params, g, t, B, device=cuda).T.contiguous()
        got = tns.batched_step(params, X, Y, U, RH, action, demand, t)
        want = tns._batched_step_plain(params, X, Y, U, RH, action, demand, t)
        for a, b in zip(got, want):
            assert a.is_contiguous() and a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3, equal_nan=True)
        assert torch.isnan(got[4][17]) and not torch.isnan(got[4][:17]).any()
        X, Y, U, RH = got[:4]
