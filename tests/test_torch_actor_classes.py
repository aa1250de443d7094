"""The MLP actor at any width, depth and action count: the general actor
classes of the tensor-core tile (csrc/mlp_tile.cuh ``MlpTileG``: K4-K6,
K10-K12, K18-K20) and of the off-policy wide route (csrc/wide_mlp.cuh
``WideMlpG``: K27-K29), against hand counts and, through the plain
versions, against the JAX package on the CPU.

- Every actor within the fixed structs' arrays whose layout fits a block
  packs exactly as before the classes were split: ``MlpTile`` at the first
  of ``_MLP_TILES`` whose ``_mlp_tile_plan`` fits, ``WideMlp``, the cluster.
- The lifted shapes plan with no ValueError, at the bytes reckoned by hand:
  NetInvMgmt ``default_regions(3)`` (33 actions) and ``default_regions(8)``
  (obs 544, 88 actions) on K4-K6 and K29's wide route, a (400, 300) actor
  on K10-K12 and K18-K20, a (1024, 1024) one on the workspace route, a
  10-layer one on the tile and on K27's wide route; past the state bound or
  the workspace the plans raise, naming the bytes needed and held.
- The general classes' ctypes mirrors against the C structs, their packed
  buffers (the fixed class's layers and std, then the layer table and
  half_hi), the persistent grid and workspace a launch sets, and the C
  entry points ``*_any``.
- The plain versions at the lifted shapes against the JAX package: plain K4
  on default_regions(3) replayed through JAX's step chain and folded actor
  (raws within atol=1e-4, rewards rtol=1e-5 atol=1e-2), plain K6 on
  default_regions(8) against JAX's ``apply_folded_actor`` on JAX's chain
  (actions atol=1e-3), plain K6 under a 10-layer actor likewise, plain K12
  and K20 under (400, 300) and (1024, 1024) actors against JAX's folded
  actor on JAX's chains (>= 99% of integer actions equal; orders within
  rtol=1e-4 atol=1e-2 on >= 99%), and plain K29 on default_regions(8) under
  the (256, 256) relu actor through JAX's chain (rewards within rtol=1e-3
  atol=2 on > 99%, the observations equal).
"""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernel_rollout import _replay_chain
from test_torch_net_k2_plan import CSRC, _ctypes_fields
from test_torch_nv_policy import _jax_chain as _nv_jax_chain

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import off_policy as top
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import _build
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.envs import topology as jtopo
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
B = 8
SMEM = tek.SMEM_OPTIN_BYTES


def _zeros(dims):
    return (tuple(torch.zeros(a, b) for a, b in zip(dims, dims[1:])),
            tuple(torch.zeros(b) for b in dims[1:]))


def _regions(copies, steps=30):
    return ttopo.default_regions(copies, steps)


# ------------------------------------------------------------- the plans

# within the fixed arrays: (widths, demand rows, scratch rows, state words)
FIXED = {"k5_default": ([68, 64, 64, 11], 1, 18, 90),
         "k11_default": ([33, 64, 64, 3], 0, 0, 0),
         "k19_default": ([10, 64, 64, 1], 0, 0, 0),
         "wide_128": ([68, 128, 128, 11], 1, 18, 90),
         "maxima": ([256] * 8 + [32], 16, 48, 352),
         "two_tiles": ([33, 32, 3], 0, 0, 0)}


@pytest.mark.parametrize("name", list(FIXED))
def test_an_actor_within_the_arrays_keeps_the_fixed_plan(name):
    """MlpTile, at the first of ``_MLP_TILES`` whose ``_mlp_tile_plan``
    fits a block, the layers' offsets as the fixed class packed them."""
    dims, dem, scratch, words = FIXED[name]
    st, flat = tek._pack_tile_actor(_zeros(dims), torch.ones(dims[-1]), dims[0], dims[-1],
                                    [1.0] * dims[-1], CPU, dem, scratch, words)
    plan = next(pl for pl in (tek._mlp_tile_plan(dims, dem, scratch, words, n)
                              for n in tek._MLP_TILES) if 4 * pl.floats <= SMEM)
    assert type(st) is tek._MlpTile
    assert (st.lanes, st.stride, st.s_total) == (plan.lanes, plan.stride, plan.floats)
    assert {k: getattr(st, f"s_{k}") for k in plan.offsets} == plan.offsets
    at = 0
    for layer, (i, o) in enumerate(zip(dims, dims[1:])):
        assert (st.w[layer], st.b[layer]) == (at, at + tek._pad16(o) * tek._pad8(i))
        at += tek._pad16(o) * tek._pad8(i) + tek._pad16(o)
    assert st.std == at and flat.numel() == at + dims[-1]
    assert list(st.dims)[:len(dims)] == dims and st.n_layers == len(dims) - 1


def test_the_off_policy_routes_keep_the_fixed_classes():
    """The (256, 256) actor takes the cluster, a (512, 512) one WideMlp (two
    buffers of 512 rows), on InvManagement and on NetInvMgmt's default
    graph beside its state."""
    im_dims = (33, 256, 256, 3)
    plan = tek._pack_cluster_actor(_zeros(im_dims), torch.ones(3), 33, 3, "det", [1.0] * 3, 30,
                                   33, False, CPU)
    assert plan is not None and type(plan[0]) is tek._ClusterMlp
    st, _ = tek._pack_wide_actor(_zeros((33, 512, 512, 3)), torch.ones(3), 33, 3, "det",
                                 [1.0] * 3, CPU)
    assert type(st) is tek._WideMlp and st.rows == 512
    T = tnet.default_params(num_periods=30).topology
    st, _ = tek._pack_wide_actor(_zeros((T.obs_dim, 512, 512, T.n_reorder)),
                                 torch.ones(T.n_reorder), T.obs_dim, T.n_reorder, "det",
                                 [1.0] * T.n_reorder, CPU, tns._net_wide_extra(T), True)
    assert type(st) is tek._WideMlp and st.rows == 512


def _net_tile(copies, arch):
    T = _regions(copies)
    return tns._pack_net_tile_actor(T, _zeros([T.obs_dim, *arch, T.n_reorder]),
                                    torch.ones(T.n_reorder), CPU)[0]


def _wide29(copies, mode):
    T = _regions(copies)
    out = 2 * T.n_reorder if mode == "sac" else T.n_reorder
    return tek._pack_wide_actor(_zeros([T.obs_dim, 256, 256, out]),
                                torch.ones(T.n_reorder) if mode == "det" else None, T.obs_dim,
                                T.n_reorder, mode, [1.0] * T.n_reorder, CPU,
                                tns._net_wide_extra(T), True)[0]


def _im_tile(arch):
    p = tim.default_params()
    obs = tim.observation_space(p).shape[0]
    return tek._im_tile_actor(p, _zeros([obs, *arch, p.m1]), torch.ones(p.m1, 1), CPU)[0]


def _nv_tile(arch):
    p = tnv.default_params(lead_time=5, step_limit=50)
    st, _ = tek._nv_tile_actor(p, _zeros([p.obs_dim, *arch, 1]), torch.ones(1, 1), CPU)
    return tek._nv_tile_launch(st, tek._nv_plan(p, CPU)["struct"], p.step_limit)[0]


def _k27_deep():
    return tek._pack_wide_actor(_zeros([33] + [64] * 9 + [3]), torch.ones(3), 33, 3, "det",
                                [1.0] * 3, CPU)[0]


# hand counts, (shared memory bytes, workspace bytes a block, lanes); the
# rows are [row][lane] at lanes + 8 in shared memory, lanes in the workspace
LIFTED = {
    # obs 204 and 33 actions: buffer 0 the obs (208 rows) and layer 1's 64,
    # buffer 1 layers 0 and 2 (64, 48); the 3 + 33 + 54 transient rows in
    # buffer 0, dead after the actor: (208 + 64) x 72 floats, then 270
    # words of state (18 + 33 + 33 + 3 + 183) x 64 lanes and the graph's
    # 432 floats of records
    "k4_regions3": (lambda: _net_tile(3, (64, 64)),
                    4 * ((208 + 64) * 72 + 270 * 64 + 432), 0, 64),
    # obs 544, 88 actions: (544 + 96) rows x 40, 720 words x 32 lanes, 1,152
    # floats of records: one block of 32 lanes
    "k4_regions8": (lambda: _net_tile(8, (64, 64)), 199_168, 0, 32),
    "k4_regions8_256": (lambda: _net_tile(8, (256, 256)),
                        4 * ((544 + 256) * 40 + 720 * 32 + 1_152), 0, 32),
    # K29's wide route: buffers of 544 and 256 rows, 88 noise rows, 872
    # words of state and demand and the records: 229,888 B; "uniform" runs
    # no actor
    "k29_det": (lambda: _wide29(8, "det"), 4 * ((544 + 256 + 88) * 32 + 872 * 32 + 1_152), 0,
                32),
    "k29_sac": (lambda: _wide29(8, "sac"), 4 * ((544 + 256 + 88) * 32 + 872 * 32 + 1_152), 0,
                32),
    "k29_uniform": (lambda: _wide29(8, "uniform"), 4 * ((88 + 872) * 32 + 1_152), 0, 32),
    # (400, 300) on InvManagement: buffers of 304 and 400 rows at 64 lanes
    "k11_400_300": (lambda: _im_tile((400, 300)), 202_752, 0, 64),
    # (1024, 1024): two buffers of 1,024 rows x 64 lanes in the workspace
    "k11_1024": (lambda: _im_tile((1024, 1024)), 0, 4 * 2048 * 64, 64),
    "k11_10_layers": (lambda: _im_tile((64,) * 9), 4 * 64 * 72, 0, 64),
    # Newsvendor at ENV_CONFIG_EVAL: 25 demand rows, then (304 + 400) x 72
    # activation floats and the pipeline's 5 rows (the table's 177 rows fit
    # inside)
    "k19_400_300": (lambda: _nv_tile((400, 300)), 4 * (25 * 64 + 704 * 72 + 5 * 64), 0, 64),
    "k19_1024": (lambda: _nv_tile((1024, 1024)), 4 * (25 * 64 + 177 * 64), 4 * 2048 * 64, 64),
    "k27_10_layers": (_k27_deep, 4 * 2 * 64 * 32, 0, 32),
}


@pytest.mark.parametrize("name", list(LIFTED))
def test_the_lifted_shapes_plan_by_bytes(name):
    make, smem, ws, lanes = LIFTED[name]
    st = make()
    assert type(st) in (tek._MlpTileG, tek._WideMlpG)
    assert 4 * st.ws_floats == ws
    if isinstance(st, tek._MlpTileG):
        assert (4 * st.s_total, st.lanes) == (smem, lanes)
        assert st.stride == (lanes if ws else lanes + 8)
    else:
        acts = 0 if st.ws_floats else st.rows0 + st.rows1
        extra = smem // 4 - acts * 32
        assert extra >= 0 and 4 * (acts * 32 + extra) == smem <= SMEM


def test_the_parity_layout_by_hand():
    """Layer l writes buffer (l + 1) & 1: default_regions(8)'s (64, 64)
    actor holds buffer 0 at the obs's 544 rows and buffer 1 at the output's
    96; its 240 transient rows lie in buffer 0 from row 0 (dead after the
    actor: 640 rows, against 880 after H). A 2-layer actor's H is in
    buffer 0, its transient rows in buffer 1; an in-place actor keeps one
    buffer with them after H, as the fixed class does."""
    plan = tek._mlp_tile_plan_any([544, 64, 64, 88], 8, 144, 720, 32, 1_152)
    assert (plan.rows, plan.transient, plan.in_place) == ((544, 96), "dead", False)
    assert plan.offsets == {"x0": 0, "x1": 544 * 40, "dem": 0, "z": 8 * 40,
                            "scratch": 96 * 40, "state": 640 * 40}
    plan = tek._mlp_tile_plan_any([33, 400, 3], 0, 0, 0, 64)
    assert (plan.rows, plan.transient, plan.offsets["z"]) == ((40, 400), "dead", 40 * 72)
    plan = tek._mlp_tile_plan_any([8, 16, 11], 1, 18, 90, 64)
    assert (plan.rows, plan.in_place, plan.offsets["dem"]) == ((46, 0), True, 16 * 72)
    ws = tek._mlp_tile_plan_any([33, 1024, 1024, 3], 0, 0, 0, 64, workspace=True)
    assert (ws.stride, ws.act_floats, ws.floats, ws.offsets["x1"]) == (64, 2048 * 64, 0, 65536)


def test_past_the_state_bound_or_the_workspace_the_plans_raise():
    # 2,000 words x 32 lanes of state fit no block, even with the activations
    # in the workspace (the least: 32 lanes, 8,192 bytes of workspace)
    with pytest.raises(ValueError, match=r"needs 256000 bytes of shared memory beside 8192 "
                                         r"bytes of workspace a block; a block holds 232448 "
                                         r"and the workspace 4294967296"):
        tek._tile_choice_any((33, 64, 3), 0, 0, 2_000, 0)
    with pytest.raises(ValueError, match="workspace a block; a block holds"):
        tek._tile_choice_any((33, 1 << 26, 3), 0, 0, 0, 0)   # 8.6 GB a block
    with pytest.raises(ValueError, match=r"the wide route needs 240000 bytes of shared memory"):
        tek._wide_pack_plan_any((33, 64, 3), 3, "det", (1.0,) * 3, CPU, 60_000)
    T = dataclasses.replace(_regions(1), ro_L=(170,) * 11)
    with pytest.raises(ValueError, match="too large"):   # the state itself fits no block
        tns._pack_net_tile_actor(T, _zeros([T.obs_dim, 11]), None, CPU)


# --------------------------------------------- mirrors, buffers, launches

def _struct_fields(header, name):
    """[(name, type, 1)] of a struct of scalar fields and pointers in
    csrc/``header`` ("ptr" for a pointer)."""
    text = (CSRC / header).read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S)
                  .group(1))
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, rest = decl.split(None, 1)
        kind = "ptr" if ctype.endswith("*") or rest.startswith("*") else ctype
        for item in rest.replace("*", "").split(","):
            fields.append((item.strip(), kind, 1))
    return fields


@pytest.mark.parametrize("header, name, cls", [("mlp_tile.cuh", "MlpTileG", "_MlpTileG"),
                                               ("wide_mlp.cuh", "WideMlpG", "_WideMlpG")])
def test_general_mirrors_have_the_c_fields(header, name, cls):
    fields = _struct_fields(header, name)
    assert fields[0] == ("ws", "ptr", 1)
    assert _ctypes_fields(getattr(tek, cls)) == fields
    assert ctypes.sizeof(getattr(tek, cls)) == -(-(8 + 4 * (len(fields) - 1)) // 8) * 8


def test_the_general_tile_buffer_is_the_fixed_one_then_its_table():
    """Forced to the general class, an actor within the arrays packs the
    fixed class's fragments, biases and std, zero words to 16 bytes, then an
    int4 {in, out, w, b} a layer at the fixed class's offsets, then
    half_hi."""
    dims = [33, 64, 64, 3]
    actor = _zeros(dims)
    actor = (tuple(torch.randn(W.shape) for W in actor[0]), actor[1])
    std = torch.full((3,), 0.5)
    fixed, flat = tek._pack_tile_actor(actor, std, 33, 3, [1.0, 2.0, 3.0], CPU)
    gen, gflat = tek._pack_tile_actor(actor, std, 33, 3, [1.0, 2.0, 3.0], CPU, general=True)
    assert gen.actor_dims == tuple(dims) and gen.std == fixed.std
    assert torch.equal(gflat[:flat.numel()], flat) and gen.table == tek._pad4(flat.numel())
    table = gflat[gen.table:gen.half_hi].view(torch.int32).reshape(-1, 4).tolist()
    assert table == [[i, o, fixed.w[k], fixed.b[k]] for k, (i, o) in enumerate(zip(dims, dims[1:]))]
    assert gflat[gen.half_hi:].tolist() == [1.0, 2.0, 3.0]


def test_the_general_wide_buffer_is_the_fixed_one_then_its_widths():
    """Forced to the general class, an actor the wide route's fixed class
    takes packs the fixed class's layers and std, then its widths as ints
    and half_hi; its buffers by layer parity fit a block."""
    dims = [33, 512, 512, 3]
    actor = _zeros(dims)
    actor = (tuple(torch.randn(W.shape) for W in actor[0]), actor[1])
    std = torch.full((3,), 0.5)
    fixed, flat = tek._pack_wide_actor(actor, std, 33, 3, "det", [1.0, 2.0, 3.0], CPU)
    gen, gflat = tek._pack_wide_actor(actor, std, 33, 3, "det", [1.0, 2.0, 3.0], CPU,
                                      general=True)
    assert type(fixed) is tek._WideMlp and type(gen) is tek._WideMlpG
    assert gen.std == fixed.std and torch.equal(gflat[:flat.numel()], flat)
    assert gflat[gen.dims:gen.half_hi].view(torch.int32).tolist() == dims
    assert gflat[gen.half_hi:].tolist() == [1.0, 2.0, 3.0]
    assert (gen.rows0, gen.rows1, gen.ws_floats) == (512, 512, 0)


def test_a_launch_sets_the_persistent_grid_and_the_workspace(monkeypatch):
    """In shared memory a block a tile; on the workspace route at most the
    SMs x the blocks an SM holds, each launch given a workspace of its own,
    a slice a block, that its struct keeps alive."""
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    st = _im_tile((400, 300))
    assert tek._tile_launch(st, 1_000 * 3, torch.device("cpu")) == "_any"
    assert st.grid == -(-3_000 // 64) and not st.ws
    st = _im_tile((1024, 1024))
    tek._tile_launch(st, 65_536 * 16, torch.device("cpu"))
    per_sm = tek._blocks_per_sm(0, 64, tek._TILE_REGS)
    assert st.grid == 132 * per_sm and st.ws == st.workspace.data_ptr()
    assert st.workspace.numel() == st.grid * st.ws_floats
    st2 = _im_tile((1024, 1024))
    tek._tile_launch(st2, 64, torch.device("cpu"))
    assert st2.grid == 1 and st2.workspace.numel() == st2.ws_floats
    assert st2.ws != st.ws   # a workspace a launch, not one shared by every launch
    wst = tek._pack_wide_actor(_zeros([33, 1024, 1024, 3]), torch.ones(3), 33, 3, "det",
                               [1.0] * 3, CPU)[0]
    assert tek._wide_launch(wst, 65_536, torch.device("cpu")) == "_any"
    assert wst.ws_floats == 2048 * 32 and wst.grid == 132 * tek._blocks_per_sm(
        0, tek._WIDE_THREADS, tek._WIDE_REGS)
    assert wst.workspace.numel() == wst.grid * wst.ws_floats
    fixed = _im_tile((64, 64))
    assert type(fixed) is tek._MlpTile and tek._tile_launch(fixed, 10, None) == ""


# InvManagement's K27 (the wide route's *_any) is a source of its own beside
# its tile kernels
_FAMILY_SOURCES = {"im_policy": ("im_policy", "im_offpolicy")}


@pytest.mark.parametrize("stem", ["net_policy", "im_policy", "nv_policy"])
def test_each_general_entry_point_takes_its_fixed_twins_arguments(stem):
    sigs = {fn: sig for src in _FAMILY_SOURCES.get(stem, (stem,))
            for fn, sig in _build.SIGNATURES[src].items()}
    anys = [fn for fn in sigs if fn.endswith("_any")]
    assert len(anys) == 3 and all(sigs[fn] == sigs[fn[:-4]] for fn in anys)


# ---------------------------------------- the plain versions against JAX

def _graph(copies, steps):
    """(JAX params, the port's params) of default_regions(copies), each
    compiled by its own package."""
    nodes, edges = ttopo.repeated_regions(ttopo.DEFAULT_GRAPH, copies)
    jp = jnet.NetInvParams(topology=jtopo.compile_graph(nodes, edges, steps), num_periods=steps)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), steps, jp.backlog,
                                       jp.alpha)
    return jp, tp


def _folded(obs_dim, act_dim, arch, scale, seed=4):
    """A folded tanh actor of ``arch`` with obs statistics of mean ~50 and
    std ~20, its mean head scaled by ``scale``; and its JAX copy."""
    g = torch.Generator().manual_seed(seed)
    model = tnetworks.MLPActorCritic(obs_dim, act_dim, pi_arch=arch, generator=g)
    with torch.no_grad():
        model.mean.weight.mul_(scale)
    r = np.random.default_rng(seed)
    rms = interop.rms_from_numpy(50.0 + r.normal(0, 5, obs_dim),
                                 (20.0 + r.uniform(0, 5, obs_dim)) ** 2, 1e3, device=CPU)
    actor = tek.fold_actor_params(tppo.PPOConfig(), model, rms)
    return actor, (tuple(jnp.asarray(W.numpy()) for W in actor[0]),
                   tuple(jnp.asarray(b.numpy()) for b in actor[1]))


def _net_chain(jp, acts, dems):
    """JAX's step chain over (T, rows, B) streams: (obs (T, obs, B), rewards
    (T, B))."""
    @jax.jit
    def run(actions, demands):
        def one_env(a, d):
            state, _ = jnet.reset(jp)

            def body(state, ad):
                obs = jnet._obs(jp, state)
                state, ts = jnet.step_with_demand(jp, state, ad[0], ad[1])
                return state, (obs, ts.reward)

            return jax.lax.scan(body, state, (a, d))[1]

        return jax.vmap(one_env, in_axes=(2, 2), out_axes=-1)(actions, demands)

    return (np.asarray(x) for x in run(jnp.asarray(acts), jnp.asarray(dems)))


def test_plain_k4_on_default_regions_3_replays_through_jax():
    """33 actions, past the fixed class's 32: plain K4's actions and demand
    through JAX's chain give its rewards, and JAX's folded actor on the obs
    assembled from its streams plus the plain normals its raws."""
    steps = 8
    jp, tp = _graph(3, steps)
    T = tp.topology
    actor, jactor = _folded(T.obs_dim, T.n_reorder, (64, 64), 30.0)
    k4 = tns.rollout_traj_net(tp, actor, torch.full((T.n_reorder,), -0.5), 2024, B, device=CPU)
    acts = ((torch.tanh(k4["raw"]) + 1.0) * tns._half_hi(T)).numpy()
    _, rew = _net_chain(jp, acts, k4["demand"].numpy())
    np.testing.assert_allclose(k4["reward"].numpy(), rew, rtol=1e-5, atol=1e-2)
    obs = jnet.assemble_obs_from_streams(jp, *(jnp.asarray(k4[k].numpy())
                                               for k in ("x", "u", "r")))
    mean = np.asarray(jek.folded_actor_mean(jactor, obs))[:steps]
    lanes = torch.arange(B)
    z = []
    for t in range(steps):
        w = rng.period_words(2024, lanes, 0, t, T.n_retail + 2 * T.n_reorder,
                             key1=rng.POLICY_KEY)[T.n_retail:]
        z.append(rng.normal01(torch.stack(w[:T.n_reorder]), torch.stack(w[T.n_reorder:])))
    want = mean.transpose(0, 2, 1) + np.exp(-0.5) * torch.stack(z).numpy()
    np.testing.assert_allclose(k4["raw"].numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("copies, arch", [(8, (64, 64)), (1, (64,) * 9)],
                         ids=["regions8", "10_layers"])
def test_plain_k6_matches_jax_folded_actor_on_the_chain(copies, arch):
    """Plain K6 on default_regions(8) (obs 544, 88 actions) and under a
    10-layer actor on the default graph: its actions are JAX's
    ``apply_folded_actor`` on JAX's chain driven by them (atol=1e-3), its
    returns plain K5's and JAX's chain's reward sums (rtol=1e-5 atol=1e-2)."""
    steps = 6
    jp, tp = _graph(copies, steps)
    T = tp.topology
    actor, jactor = _folded(T.obs_dim, T.n_reorder, arch, 30.0)
    ret, acts, dems = tns.sample_policy_streams_debug_net(tp, actor, 7, B, device=CPU)
    assert torch.equal(ret, tns.episode_returns_net_policy(tp, actor, 7, B, device=CPU))
    a, d = acts[:, 0].numpy(), dems[:, 0].numpy()
    obs, rew = _net_chain(jp, a, d)
    space = jnet.action_space(jp)
    for t in range(steps):
        want = jek.apply_folded_actor(jactor, jnp.asarray(obs[t].T), jnp.asarray(space.low),
                                      jnp.asarray(space.high), False)
        np.testing.assert_allclose(a[t], np.asarray(want).T, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ret.numpy(), rew.sum(0), rtol=1e-5, atol=1e-2)
    assert a.std() > 0   # the actor moves the orders


@pytest.mark.parametrize("arch", [(400, 300), (1024, 1024)])
def test_plain_k12_and_k20_match_jax_folded_actor_on_the_chain(arch):
    """Plain K12's integer actions (InvManagement backlog, 12 periods) and
    plain K20's orders (Newsvendor ENV_CONFIG_EVAL's lead time, 10 periods)
    under an ``arch`` actor are JAX's folded actor on JAX's chains driven by
    them: >= 99% of actions equal (a truncation boundary moves one), orders
    within rtol=1e-4 atol=1e-2 on >= 99%."""
    jp = jim.default_params(periods=12)
    tp = interop.im_params_from_numpy(dataclasses.asdict(jp))
    D = tim.observation_space(tp).shape[0]
    actor, jactor = _folded(D, tp.m1, arch, 30.0)
    _, acts, dems = tek.sample_policy_streams_debug_im(tp, actor, 99, 64, device=CPU)
    acts, dems = acts[:, 0].numpy(), dems[:, 0].numpy()
    obs_all, _, _ = _replay_chain(jp, acts, dems)
    want = np.stack([np.asarray(jek.apply_folded_actor(
        jactor, jnp.asarray(np.asarray(obs_all)[t]), jnp.zeros(tp.m1),
        jnp.asarray(tp.c, jnp.float32), True)) for t in range(12)])
    assert (want.transpose(0, 2, 1) == acts).mean() >= 0.99
    assert len(np.unique(acts)) > 10
    jp = jnv.default_params(lead_time=5, step_limit=10)
    tp = tnv.NewsvendorParams(**dataclasses.asdict(jp))
    actor, jactor = _folded(tp.obs_dim, 1, arch, 3.0)
    _, econ, acts, dems = tek.sample_policy_streams_debug_nv(tp, actor, 99, 64, device=CPU)
    econ, acts, dems = econ[0].numpy(), acts[:, 0].numpy(), dems[:, 0].numpy()
    obs, _ = _nv_jax_chain(jp, econ, acts, dems)
    want = np.stack([np.asarray(jek.apply_folded_actor(
        jactor, jnp.asarray(obs[t]), jnp.zeros(1), jnp.full(1, tp.max_order_quantity),
        False))[:, 0] for t in range(10)])
    assert np.isclose(acts, want, rtol=1e-4, atol=1e-2).mean() >= 0.99
    assert float(acts.std()) > 1.0


def test_plain_k29_on_default_regions_8_replays_through_jax():
    """Plain K29 under the (256, 256) relu actor and the det head on
    default_regions(8): its a_norm rescaled to orders and its demand through
    JAX's chain give its rewards (rtol=1e-3 atol=2 on > 99%), both packages
    rebuild the same observations, and JAX's relu trunk on them gives its
    pre-noise means (atol=1e-4)."""
    steps = 6
    jp, tp = _graph(8, steps)
    T = tp.topology
    g = torch.Generator().manual_seed(5)
    net = top._Actor(T.obs_dim, T.n_reorder, (256, 256), False, g)
    actor = tek.fold_offpolicy_actor((256, 256), net)
    tr = tns.rollout_traj_net(tp, actor, torch.full((T.n_reorder,), np.log(0.1)), 53, B, "det",
                              "relu", CPU)
    a_norm = tr["raw"].numpy()
    assert a_norm.min() >= -1.0 and a_norm.max() <= 1.0
    acts = (a_norm + np.float32(1.0)) * np.float32(tns._half_hi(T))
    _, rew = _net_chain(jp, acts, tr["demand"].numpy())
    assert np.isclose(tr["reward"].numpy(), rew, rtol=1e-3, atol=2.0).mean() > 0.99
    t_obs = tnet.assemble_obs_from_streams(tp, tr["x"], tr["u"], tr["r"])
    j_obs = jnet.assemble_obs_from_streams(jp, *(jnp.asarray(tr[k].numpy())
                                                 for k in ("x", "u", "r")))
    np.testing.assert_array_equal(t_obs.numpy(), np.asarray(j_obs))
    H = np.asarray(jek.mlp_forward([jnp.asarray(W.numpy().T) for W in actor[0]],
                                   [jnp.asarray(b.numpy().reshape(-1, 1)) for b in actor[1]],
                                   "relu", None, list(jnp.asarray(j_obs[0].T))))
    got = tek.mlp_forward(tek.kernel_layers(actor, CPU), "relu", list(t_obs[0].T))
    np.testing.assert_allclose(got.numpy(), H, rtol=1e-5, atol=1e-4)
