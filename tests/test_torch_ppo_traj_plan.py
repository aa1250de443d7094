"""The PPO trajectory kernels of InvManagement and Newsvendor on the
tensor-core tile: K10 (``rollout_traj_im``) as K11's kernel
``k_im_policy_returns<1, 0, 1, BACKLOG>`` and K18 (``rollout_traj_nv``) as
K19's kernel ``k_nv_policy_returns<1, 0, 1, LAYOUT>`` (csrc/im_policy.cu,
csrc/nv_policy.cu on csrc/mlp_tile.cuh), each the one-episode stochastic
instance with its training streams written, as far as the CPU reaches them.

- K10 packs the MlpTile and layout K11 packs (``_im_tile_actor``) at the
  InvManagementBacklogEnv defaults (obs 33, act 3), in lost sales, and on a
  chain of 8 stocked stages; at IM_MAX_M1 x IM_MAX_LT (obs 264) both refuse
  the actor alike;
- K18 takes K19's plan (``_nv_tile_launch``): "upfront" at
  benchmark_newsvendor.py's ENV_CONFIG_EVAL (obs 10, act 1), "linear" at
  mu_max 30,000;
- every actor the first designs took (``_pack_actor``, their shared-memory
  cap) packs for K10 and K18, and so do the actors they refused;
- ``_build.SIGNATURES`` against the C entry points' parameter lists parsed
  from csrc/*.cu, every entry point of every source (K10's and K18's
  among them);
- the first designs left the package (csrc/ defines no
  ``k_im_rollout_traj`` or ``k_nv_rollout_traj``; their copies live in
  tools/);
- a NumPy emulation of the tile's 3xTF32 forward pass on PPO's initial
  actors with a RunningMeanStd of the obs folded in, over the obs of plain
  K10 and K18 rollouts: the share of (lane, period) whose K10 action or
  K18 raw departs from the FP32 forward pass is held under 1%.
The cuda-marked cases hold K10 and K18 against their plain versions on a
ragged batch of 1,000 lanes (backlog and lost sales; both Newsvendor demand
layouts), the stochastic K11's and K19's episode 0 against K10 and K18 bit
for bit, and a NaN std.
"""

import ctypes
import dataclasses
import inspect
import pathlib
import re

import pytest
import torch
from test_torch_mlp_mma_plan import _emulated_forward, _folded, _share

from or_gym_inventory_torch.agents import networks, ppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import _build
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import rng

CPU = torch.device("cpu")
TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
# benchmark_newsvendor.py's ENV_CONFIG_EVAL, and the mu_max past which no
# Poisson table fits a block (chip_smoke.py NV_LINEAR_MU_MAX)
NV_EVAL = {"lead_time": 5, "step_limit": 50, "p_max": 100.0, "h_max": 5.0, "k_max": 10.0,
           "mu_max": 200.0}
NV_LINEAR_MU_MAX = 30_000.0


def _actor(dims, seed=0):
    g = torch.Generator().manual_seed(seed)
    Ws = tuple(torch.randn(a, b, generator=g) / a ** 0.5 for a, b in zip(dims, dims[1:]))
    bs = tuple(torch.randn(b, generator=g) * 0.1 for b in dims[1:])
    return Ws, bs


def _chain(m1, lt, backlog=True):
    """An InvManagement chain of ``m1`` stocked stages, the default's
    inventories, costs and capacities taken in turn, the lead times
    (lt, 1, 1, ...): obs m1 (lt + 1)."""
    d = tim.default_params()

    def cycle(xs, n):
        return tuple(xs[i % len(xs)] for i in range(n))
    return tim.default_params(backlog=backlog, I0=cycle(d.I0, m1), r=cycle(d.r, m1 + 1),
                              k=cycle(d.k, m1 + 1), h=cycle(d.h, m1), c=cycle(d.c, m1),
                              L=(lt,) + (1,) * (m1 - 1))


def _nv(mu_max=200.0, lead_time=5):
    return tnv.default_params(dict(NV_EVAL, mu_max=mu_max, lead_time=lead_time))


def _fields(st):
    return {name: (list(v) if hasattr(v, "__len__") else v)
            for name, v in ((n, getattr(st, n)) for n, _ in st._fields_)}


# ------------------------------------------------ K10: K11's tile and layout

IM_CASES = {
    "backlog": (lambda: tim.default_params(backlog=True), 33, 3),
    "lost_sales": (lambda: tim.default_params(backlog=False), 33, 3),
    # 8 stages, lead time 31: obs 256, the widest the tile takes
    "m1_8_lt_31": (lambda: _chain(8, 31), 256, 8),
}


@pytest.mark.parametrize("case", sorted(IM_CASES))
def test_k10_packs_k11s_tile(case):
    """The struct K10's entry point launches is the stochastic K11's, field
    for field (both through ``_im_tile_actor``), and the deterministic
    K11's but for the std; at the defaults the hand count of
    tests/test_torch_mlp_mma_plan.py's "k11_default": 64 lanes, stride 72,
    one buffer of 64 rows in place, 4,608 floats."""
    make, obs, m1 = IM_CASES[case]
    params = make()
    assert (tim.observation_space(params).shape[0], params.m1) == (obs, m1)
    actor = _actor([obs, 64, 64, m1])
    std = tek.clipped_std(torch.full((m1,), -0.5))
    k10, flat10 = tek._im_tile_actor(params, actor, std, CPU)
    k11s, flat11s = tek._pack_tile_actor(actor, std, obs, m1, tek._half_c(params), CPU)
    k11d, flat11d = tek._pack_tile_actor(actor, None, obs, m1, tek._half_c(params), CPU)
    assert bytes(k10) == bytes(k11s) and torch.equal(flat10, flat11s)
    want = _fields(k11d)
    got = _fields(k10)
    assert (got.pop("std"), want.pop("std")) == (flat11d.numel(), -1)
    assert got == want
    assert torch.equal(flat10[:flat11d.numel()], flat11d)
    assert torch.equal(flat10[flat11d.numel():], std.reshape(-1))
    if obs == 33:
        assert (k10.lanes, k10.stride, k10.s_x0, k10.s_x1, k10.s_total) == (64, 72, 0, 0, 4608)
        assert k10.s_z == 16 * 72   # the normals from row pad16(act)


def test_k10_and_k11_refuse_the_struct_maxima_alike():
    """At IM_MAX_M1 stages and lead time IM_MAX_LT the obs is 8 x 33 = 264
    wide, past the MLP's 256: K10 and K11 raise the same error."""
    params = _chain(tek.IM_MAX_M1, tek.IM_MAX_LT)
    obs = tim.observation_space(params).shape[0]
    assert obs == 264
    actor = _actor([obs, 64, 64, tek.IM_MAX_M1])
    std = torch.ones(tek.IM_MAX_M1, 1)
    errors = []
    for s in (std, None):
        with pytest.raises(ValueError, match="width <= 256") as info:
            tek._im_tile_actor(params, actor, s, CPU)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_both_im_entry_points_pack_through_one_helper():
    """K10's and K11's wrappers pack the actor with the same call, so they
    launch the same tile; neither packs for the first design."""
    for fn in (tek.rollout_traj_im, tek._im_policy_call):
        src = inspect.getsource(fn)
        assert "_im_tile_actor(params, actor, std, dev)" in src
        assert "_pack_actor(" not in src and "_pack_tile_actor(" not in src


# ------------------------------------------------ K18: K19's tile and layout

@pytest.mark.parametrize("mu_max, layout, lanes", [(200.0, "upfront", 64),
                                                   (NV_LINEAR_MU_MAX, "linear", 64)])
def test_k18_takes_k19s_plan(mu_max, layout, lanes):
    """K18 and K19 pack through ``_nv_tile_actor`` (in ``_nv_policy_args``)
    and lay the tile out through ``_nv_tile_launch``: the up-front demand at
    ENV_CONFIG_EVAL, the linear count at mu_max 30,000, where no table fits
    a block; K18's struct is the stochastic K19's, and the deterministic
    K19's but for the std."""
    params = _nv(mu_max)
    actor = _actor([params.obs_dim, 64, 64, 1])
    nv_st = tek._nv_plan(params, "cpu")["struct"]
    T = params.step_limit
    got = {}
    for name, std in (("k18", tek.clipped_std(torch.tensor([-0.5]))),
                      ("k19s", tek.clipped_std(torch.tensor([-0.5]))), ("k19d", None)):
        st, flat = tek._nv_tile_actor(params, actor, std, CPU)
        tile, nt = tek._nv_tile_launch(st, nv_st, T)
        got[name] = (_fields(tile), _fields(nt), flat)
    k18, k19s, k19d = got["k18"], got["k19s"], got["k19d"]
    assert k18[0] == k19s[0] and k18[1] == k19s[1] and torch.equal(k18[2], k19s[2])
    assert {k: v for k, v in k18[0].items() if k != "std"} == \
        {k: v for k, v in k19d[0].items() if k != "std"}
    plan = tek._nv_tile_choice((params.obs_dim, 64, 64, 1), nv_st.L, nv_st.K, T, nv_st.kc_max)
    assert (plan.layout, plan.lanes) == (layout, lanes)
    assert k18[1]["layout"] == tek.NV_TILE_LAYOUTS[layout]
    assert k18[0]["s_total"] == plan.floats and plan.bytes <= tek.SMEM_OPTIN_BYTES
    for fn in (tek.rollout_traj_nv, tek._nv_policy_call):
        src = inspect.getsource(fn)
        assert "_nv_policy_args(params, actor, log_std, batch, " in src
        assert "_nv_tile_launch(st, " in src and "_pack_actor(" not in src
    assert "_nv_tile_actor(params, actor, std, dev)" in inspect.getsource(tek._nv_policy_args)


# ------------------------------------------ the first designs' cap is gone

# hidden widths; the first design's shared memory (weights + two buffers of
# 128 threads) took the first four and refused the rest
ARCHS = [(64, 64), (128, 128), (64, 64, 64, 64), (96, 96, 96), (256, 256), (256,) * 7,
         (128, 256, 128)]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_actor_the_first_designs_took_packs_on_the_tile(arch):
    im_p, nv_p = tim.default_params(), _nv()
    im_dims = [33, *arch, 3]
    nv_dims = [nv_p.obs_dim, *arch, 1]
    took = []
    for dims, half in ((im_dims, tek._half_c(im_p)), (nv_dims, tek._nv_half_hi(nv_p))):
        try:
            tek._pack_actor(_actor(dims), torch.ones(dims[-1], 1), dims[0], dims[-1], half, CPU)
            took.append(True)
        except ValueError as e:
            assert "shared memory" in str(e)
            took.append(False)
    assert took[0] == took[1] == (ARCHS.index(arch) < 4)
    st, _ = tek._im_tile_actor(im_p, _actor(im_dims), torch.ones(3, 1), CPU)
    assert st.s_total * 4 <= tek.SMEM_OPTIN_BYTES
    nv_st = tek._nv_plan(nv_p, "cpu")["struct"]
    st, _ = tek._nv_tile_actor(nv_p, _actor(nv_dims), torch.ones(1, 1), CPU)
    tile, _ = tek._nv_tile_launch(st, nv_st, nv_p.step_limit)
    assert tile.s_total * 4 <= tek.SMEM_OPTIN_BYTES


# ----------------------------------------- the bindings are the sources'

_C_TYPES = {"unsigned": ctypes.c_uint32, "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float, "cudaStream_t": ctypes.c_void_p}


def _c_entry_points(stem):
    """{name: (argtypes, restype)} of the functions defined in the extern
    "C" block of csrc/<stem>.cu, from their parameter lists."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / f"{stem}.cu").read_text())
    block = text[text.index('extern "C" {'):]
    out = {}
    for ret, name, params in re.findall(r"\n(int|void) (\w+)\(([^)]*)\)\s*\{", block):
        types = []
        for param in (p.strip() for p in params.split(",")):
            decl = re.sub(r"\bconst\b", "", param)
            if "*" in decl:
                types.append(ctypes.c_void_p)
            else:
                types.append(_C_TYPES[" ".join(decl.split()[:-1])])
        out[name] = (tuple(types), ctypes.c_int if ret == "int" else None)
    return out


ENTRY_POINTS = [(stem, name) for stem, fns in _build.SIGNATURES.items() for name in fns]


@pytest.mark.parametrize("stem, name", ENTRY_POINTS)
def test_bound_argtypes_are_the_c_parameter_lists(stem, name):
    argtypes, restype = _build.SIGNATURES[stem][name]
    want_args, want_ret = _c_entry_points(stem)[name]
    assert tuple(argtypes) == want_args and restype is want_ret


@pytest.mark.parametrize("stem", sorted(_build.SIGNATURES))
def test_every_c_entry_point_is_bound(stem):
    assert set(_c_entry_points(stem)) == set(_build.SIGNATURES[stem])


def test_k10_and_k18_take_the_tile_arguments():
    """K10: params, tile, actor, table, user_d, disc, the five streams,
    seed, backlog, B, T, stream; K18: params, tile, NvTile, actor, lgamma,
    the five streams, seed, B, T, stream; no actor length (the first
    designs' n_params) among them."""
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    assert _c_entry_points("im_policy")["im_rollout_traj"][0] == (P,) * 11 + (U, I, LL, I, P)
    assert _c_entry_points("nv_policy")["nv_rollout_traj"][0] == (P,) * 10 + (U, LL, I, P)


def test_the_first_designs_left_the_package():
    """csrc/ no longer defines K10's and K18's first kernels nor the per-thread
    policy period they alone ran; the copies under tools/ do, for the
    sweep."""
    package = "\n".join(p.read_text() for p in _build.CSRC.glob("*.cu*"))
    for gone in ("k_im_rollout_traj(", "k_nv_rollout_traj(", "policy_period("):
        assert gone not in package
    assert "k_im_rollout_traj(" in (TOOLS / "im_traj_parent.cu").read_text()
    assert "k_nv_rollout_traj(" in (TOOLS / "nv_traj_parent.cu").read_text()
    im = (_build.CSRC / "im_policy.cu").read_text()
    nv = (_build.CSRC / "nv_policy.cu").read_text()
    assert "launch_policy_kernel<true, false, true, true>" in im
    assert "launch_policy_kernel<true, false, true, false>" in im
    assert "launch_policy_returns<true, false, true>" in nv


# ------------------------------------------- the 3xTF32 forward, emulated

# the emulated actors: PPO's initial actor-critic with the RunningMeanStd of
# a rollout's obs folded in, as PPO hands the kernels its actor;
# chip_smoke.py's seeded actor (phases 12 and 21: the same initialisation
# from its seed, obs statistics of mean ~50 and std ~20 folded in); and
# Gaussian layers with the rollout's statistics folded in, whose raws
# spread over the squash's range rather than near 0
ACTOR_KINDS = ("ppo_rms", "seeded", "gaussian")


def _ppo_actor(kind, obs_dim, act_dim, obs):
    """The folded actor of ``kind`` (``ACTOR_KINDS``) for obs rows ``obs``
    (..., obs_dim), and PPO's initial log_std."""
    if kind == "seeded":
        return _folded(obs_dim, act_dim, (64, 64), CPU, seed=2024), torch.zeros(act_dim)
    g = torch.Generator().manual_seed(7)
    model = networks.MLPActorCritic(obs_dim, act_dim, generator=g)
    if kind == "gaussian":
        for layer in list(model.pi) + [model.mean]:
            torch.nn.init.normal_(layer.weight, std=layer.weight.shape[1] ** -0.5, generator=g)
    rms = ppo.RunningMeanStd.create(obs_dim).update(obs.to(torch.float32))
    return tek.fold_actor_params(ppo.PPOConfig(), model, rms), model.log_std.detach()


def _emulated_means(actor, obs_rows):
    """The tile's H (act, B) over each period's obs (T, obs, B), emulated
    (3xTF32 products, csrc/mma_tf32.cuh), and the FP32 plain forward pass's."""
    obs_dim, act = actor[0][0].shape[0], actor[0][-1].shape[1]
    st, flat = tek._pack_tile_actor(actor, None, obs_dim, act, [1.0] * act, CPU)
    layers = tek.kernel_layers(actor, CPU)
    emu, fp32 = [], []
    for X in obs_rows:
        emu.append(torch.from_numpy(_emulated_forward(st, flat, actor, X.numpy())[1]))
        fp32.append(tek.mlp_forward(layers, "tanh", list(X)))
    return torch.stack(emu), torch.stack(fp32)


@pytest.mark.parametrize("kind", ACTOR_KINDS)
def test_k10_actions_keep_fp32_on_folded_actors(kind):
    """Over 256 lanes x 30 periods of a plain K10 rollout with a folded
    actor (obs statistics from a first rollout), the actions the emulated
    tile's raws give equal the FP32 forward pass's on >= 99% of (lane,
    period) pairs (an action truncates, so a raw a rounding away from a
    boundary takes the other integer)."""
    params = tim.default_params()
    B, T, m1 = 256, params.periods, params.m1
    probe = _folded(33, m1, (64, 64), CPU)
    first = tek._rollout_traj_im_plain(params, probe, tek.clipped_std(torch.zeros(m1)), 3, B, CPU)
    actor, log_std = _ppo_actor(kind, 33, m1,
                                tim.assemble_obs_from_streams(params, first["inv"],
                                                              first["actions"]))
    std = tek.clipped_std(log_std)
    tr = tek._rollout_traj_im_plain(params, actor, std, 5, B, CPU)
    obs = tim.assemble_obs_from_streams(params, tr["inv"], tr["actions"])[:T]
    H_e, H_p = _emulated_means(actor, obs.transpose(1, 2).to(torch.float32))
    lanes = torch.arange(B)
    half = torch.tensor(tek._half_c(params)).reshape(m1, 1)
    departs = torch.zeros(T, B, dtype=torch.bool)
    for t in range(T):
        w = rng.period_words(5, lanes, 0, t, 1 + 2 * m1, key1=rng.POLICY_KEY)
        z = rng.normal01(torch.stack(w[1:1 + m1]), torch.stack(w[1 + m1:]))
        acts = [tim.trunc_i32((torch.tanh(H[t] + std * z) + 1.0) * half) for H in (H_e, H_p)]
        departs[t] = (acts[0] != acts[1]).any(0)
        torch.testing.assert_close(H_p[t] + std * z, tr["raw"][t], rtol=0.0, atol=0.0)
    share = float(departs.double().mean())
    assert share < 0.01, f"{share:.4%} of (lane, period) pairs take another action"


@pytest.mark.parametrize("kind", ACTOR_KINDS)
def test_k18_raws_keep_fp32_on_folded_actors(kind):
    """Over 256 lanes x 50 periods of a plain K18 rollout at ENV_CONFIG_EVAL
    with a folded actor, the emulated tile's raws lie within 1e-4 (the
    teacher-forced tolerance of chip_smoke.py phase 21) of the FP32 forward
    pass's on >= 99% of (lane, period) pairs."""
    params = _nv()
    B, T = 256, params.step_limit
    probe = _folded(params.obs_dim, 1, (64, 64), CPU)
    first = tek._rollout_traj_nv_plain(params, probe, tek.clipped_std(torch.zeros(1)), 3, B, CPU)
    actor, log_std = _ppo_actor(kind, params.obs_dim, 1,
                                tnv.assemble_obs_from_streams(params, first["econ"],
                                                              first["orders"]))
    std = tek.clipped_std(log_std)
    tr = tek._rollout_traj_nv_plain(params, actor, std, 5, B, CPU)
    obs = tnv.assemble_obs_from_streams(params, tr["econ"], tr["orders"])[:T]
    H_e, H_p = _emulated_means(actor, obs.transpose(1, 2).to(torch.float32))
    lanes = torch.arange(B)
    departs = torch.zeros(T, B, dtype=torch.bool)
    for t in range(T):
        w = rng.period_words(5, lanes, 0, t, 3, key1=rng.POLICY_KEY)
        z = rng.normal01(w[1], w[2])
        raw_e, raw_p = (H[t, 0] + std[0, 0] * z for H in (H_e, H_p))
        torch.testing.assert_close(raw_p, tr["raw"][t, 0], rtol=0.0, atol=0.0)
        departs[t] = (raw_e - raw_p).abs() > 1e-4
    share = float(departs.double().mean())
    assert share < 0.01, f"{share:.4%} of (lane, period) pairs depart"


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _im_setup(dev, backlog):
    params = tim.default_params(backlog=backlog)
    actor = _folded(33, params.m1, (64, 64), dev)
    return params, actor, torch.full((params.m1,), -0.5, device=dev)


def _nv_setup(dev, mu_max):
    params = _nv(mu_max)
    actor = _folded(params.obs_dim, 1, (64, 64), dev)
    return params, actor, torch.tensor([-0.5], device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("backlog", [True, False])
def test_k10_ragged_batch_on_cuda(cuda, backlog):
    """K10 on 1,000 lanes (not a multiple of the tile nor of a warp)
    against plain K10: demand bit for bit, the other streams on >= 99% of
    lanes; the env step chain on its actions and demand gives its on-hand
    exactly."""
    params, actor, log_std = _im_setup(cuda, backlog)
    B = 1_000
    got = tek.rollout_traj_im(params, actor, log_std, 9, B, device=cuda)
    want = tek._rollout_traj_im_plain(params, actor, tek.clipped_std(log_std), 9, B, cuda)
    assert torch.equal(got["demand"], want["demand"])
    for k in ("inv", "actions", "raw", "reward"):
        assert _share(got[k], want[k]) >= 0.99, k
    state, _ = tim.reset(params, batch=B, device=cuda)
    for t in range(params.periods):
        assert torch.equal(state.inv.T, got["inv"][t])
        state, _ = tim.step_with_demand(params, state, got["actions"][t].T, got["demand"][t])
    assert torch.equal(state.inv.T, got["inv"][-1])


@pytest.mark.cuda
@pytest.mark.parametrize("mu_max", [200.0, NV_LINEAR_MU_MAX])
def test_k18_ragged_batch_on_cuda(cuda, mu_max):
    """K18 on 1,000 lanes on both demand layouts: econ and demand bit for
    bit against plain K18 (the table's search and the linear count give
    the plain inversion's counts), orders, raws and rewards on >= 99% of
    lanes."""
    params, actor, log_std = _nv_setup(cuda, mu_max)
    B = 1_000
    got = tek.rollout_traj_nv(params, actor, log_std, 9, B, device=cuda)
    want = tek._rollout_traj_nv_plain(params, actor, tek.clipped_std(log_std), 9, B, cuda)
    assert torch.equal(got["econ"], want["econ"]) and torch.equal(got["demand"], want["demand"])
    for k in ("orders", "raw", "reward"):
        assert _share(got[k], want[k]) >= 0.99, k


def _sum_in_order(rows, disc):
    """sum_t disc[t] * rows[t] in float32, t in order, each product and sum
    rounded alone: what the kernels' returns add up."""
    acc = torch.zeros_like(rows[0])
    for t, d in enumerate(disc):
        acc = acc + d * rows[t]
    return acc


def _capped_orders(params, orders):
    """K20's orders (T, B), written before the pipeline's cap, through the
    plain step's cap (``_nv_step_math``, nv_step_ring's arithmetic), as K18
    writes them: the pipeline the capped orders of the last L periods."""
    zero = torch.zeros_like(orders[0])
    P, q = [zero] * params.lead_time, []
    for order in orders:
        P, _, qty = tek._nv_step_math(params, P, zero, zero, zero, zero, order, zero)
        q.append(qty)
    return torch.stack(q)


@pytest.mark.cuda
@pytest.mark.parametrize("backlog", [True, False])
def test_k11_episode_0_is_k10_on_cuda(cuda, backlog):
    """The stochastic K11/K12 at E = 3 draws K10's words in episode 0 and
    runs them on the same tile: its actions, demand and return equal K10's
    actions, demand and reward sum bit for bit."""
    params, actor, log_std = _im_setup(cuda, backlog)
    B, T = 1_000, params.periods
    tr = tek.rollout_traj_im(params, actor, log_std, 9, B, device=cuda)
    ret, acts, dems = tek.sample_policy_streams_debug_im(params, actor, 9, B, 3, log_std, cuda)
    k11 = tek.episode_returns_im_policy(params, actor, 9, B, 3, log_std, cuda)
    assert torch.equal(acts[:, 0], tr["actions"]) and torch.equal(dems[:, 0], tr["demand"])
    assert torch.equal(k11, ret)
    assert torch.equal(k11[0], _sum_in_order(tr["reward"], [1.0] * T))


@pytest.mark.cuda
@pytest.mark.parametrize("mu_max", [200.0, NV_LINEAR_MU_MAX])
def test_k19_episode_0_is_k18_on_cuda(cuda, mu_max):
    """The stochastic K19/K20 at E = 3, episode 0, against K18 bit for bit:
    econ, demand, its orders through the pipeline's cap (K20 writes them
    before it, K18 after) and its return, the gamma^t sum of K18's
    rewards."""
    params, actor, log_std = _nv_setup(cuda, mu_max)
    params = dataclasses.replace(params, gamma=0.99)
    B, T = 1_000, params.step_limit
    tr = tek.rollout_traj_nv(params, actor, log_std, 9, B, device=cuda)
    ret, econ, acts, dems = tek.sample_policy_streams_debug_nv(params, actor, 9, B, 3, log_std,
                                                               cuda)
    assert torch.equal(econ[0], tr["econ"]) and torch.equal(dems[:, 0], tr["demand"])
    assert torch.equal(_capped_orders(params, acts[:, 0]), tr["orders"])
    assert torch.equal(ret[0], _sum_in_order(tr["reward"], tek._discounts(params.gamma, T)))


@pytest.mark.cuda
def test_a_nan_std_on_cuda(cuda):
    """A NaN std: K10's raws NaN and its actions 0 (the cast takes NaN to
    0), as plain K10's; K18's raws, orders and rewards NaN, its econ and
    demand those of a finite std's run."""
    params, actor, log_std = _im_setup(cuda, True)
    nan = torch.full_like(log_std, float("nan"))
    got = tek.rollout_traj_im(params, actor, nan, 9, 300, device=cuda)
    plain = tek._rollout_traj_im_plain(params, actor, tek.clipped_std(nan), 9, 300, cuda)
    assert torch.isnan(got["raw"]).all() and int(got["actions"].abs().max()) == 0
    assert torch.equal(got["actions"], plain["actions"])
    assert torch.equal(got["demand"], plain["demand"])
    params, actor, log_std = _nv_setup(cuda, 200.0)
    fine = tek.rollout_traj_nv(params, actor, log_std, 9, 300, device=cuda)
    got = tek.rollout_traj_nv(params, actor, torch.full_like(log_std, float("nan")), 9, 300,
                              device=cuda)
    for k in ("raw", "orders", "reward"):
        assert torch.isnan(got[k]).all(), k
    assert torch.equal(got["econ"], fine["econ"]) and torch.equal(got["demand"], fine["demand"])
