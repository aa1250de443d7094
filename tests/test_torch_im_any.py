"""InvManagement at any stage count and lead time: the chain route of the
InvManagement kernels (csrc/im_step.cuh ``ImParamsG``, the C entry points
``*_chain``: K7-K12, K22-K24 and K27 past IM_MAX_M1 stocked stages or
IM_MAX_LT periods of lead time), as far as the CPU reaches it, against hand
counts and, through the plain versions, against the JAX package.

Three configurations: ``IM-chain12-lt40`` (the reference's
InvManagementBacklogEnv widened to 12 stocked stages, lead times
(3, 5, 10, 40) x 3, 60 periods), ``IM-chain9`` (nine stocked stages, 30
periods) and ``IM-lt33`` (the defaults with a lead time of 33, 36 periods),
each past one cap or both.

- The plans by hand: the route, the records (8 m1 + 2 words) and a lane's
  column (``_im_lane_words``), K8's and K7's layouts, the tile's (MlpTileG,
  its state region and records), K27's cluster or wide route and the LSTM
  tile; past a block of 32 lanes' state ``_im_plan`` and every IM wrapper's
  CUDA branch raise ValueError naming the words needed and held.
- ``_ImParamsG`` against ``struct ImParamsG`` parsed from csrc/im_step.cuh,
  the records against ``im_stage_records``' order; params within the maxima
  still pack the parent's ``struct ImParams`` (parsed from
  tools/im_caps_parent/im_step.cuh) byte for byte.
- A NumPy replica of ``im_step_any`` (one pass over the stages) against the
  plain step ``_im_step_math`` over whole episodes: on-hand, backlog,
  requested orders and the f32 profit bit for bit.
- The slice on IM-chain12-lt40 through ``random_episode_returns``,
  ``policy_episode_returns`` and ``lstm_policy_episode_returns`` (the plain
  versions on the CPU), and on IM-chain9 and IM-lt33, their streams dumped
  and replayed through JAX's ``_replay_chain`` and (but at IM-chain12-lt40,
  whose interpret-mode trace takes minutes) ``episode_returns_im`` in
  interpret mode: returns within ``rtol=1e-5, atol=1e-3``
  (test_torch_im_caps.py's), on-hand exactly, rewards ``rtol=1e-5,
  atol=1e-2``.
- One PPO ``rollout="kernel"`` update, one recurrent update and one TD3
  ``collect="kernel"`` iteration on IM-chain12-lt40 on the CPU, each
  trajectory its learner consumed replayed through JAX's chain exactly.

The cuda-marked cases are phase 55's checks of chip_smoke.py at a small
size: every chain-route kernel against its plain version by its family's
gates on the three configurations; they skip without a card.
"""

import ctypes
import dataclasses
import re
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernel_rollout import _replay_chain
from test_torch_net_k2_plan import CSRC, _c_struct_fields, _ctypes_fields

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import off_policy as top
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.agents import recurrent_ppo as trppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.ops import _build
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
B = 64
PARENT = CSRC.parents[1] / "tools" / "im_caps_parent"
CONFIGS = {
    # 12 stocked stages, lead times to 40 (sea freight), 60 periods so that
    # the 40-period orders arrive inside the episode
    "IM-chain12-lt40": dict(
        backlog=True, periods=60, I0=(100, 100, 200) * 4, c=(100, 90, 80) * 4,
        h=(0.15, 0.10, 0.05) * 4, L=(3, 5, 10, 40) * 3,
        r=tuple(float(x) for x in np.linspace(1.5, 0.5, 13, dtype=np.float32)),
        k=tuple(float(x) for x in np.linspace(0.10, 0.025, 13, dtype=np.float32))),
    # test_torch_im_caps.py's m1=9 case at 30 periods
    "IM-chain9": dict(periods=30, I0=(80,) * 9, r=tuple(16.0 - i for i in range(10)),
                      k=(0.1,) * 10, h=(0.1,) * 9, c=(60,) * 9, L=(1, 2, 3) * 3),
    # the defaults with a lead time of 33
    "IM-lt33": dict(periods=36, L=(3, 5, 33)),
}


def _params(name, **kw):
    jp = jim.default_params(**{**CONFIGS[name], **kw})
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


def _actor(dims, scale=0.05, seed=0):
    g = torch.Generator().manual_seed(seed)
    Ws = tuple(torch.randn(i, o, generator=g) * scale for i, o in zip(dims, dims[1:]))
    return Ws, tuple(torch.zeros(o) for o in dims[1:])


def _mlp_actor(tp, arch=(16,)):
    D = tim.observation_space(tp).shape[0]
    model = tnetworks.MLPActorCritic(D, tp.m1, pi_arch=arch, vf_arch=arch,
                                     generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.mean.weight.mul_(30.0)
    rms = interop.rms_from_numpy(np.full(D, 40.0), np.full(D, 900.0), 1e3, device=CPU)
    return tek.fold_actor_params(tppo.PPOConfig(), model, rms)


def _lstm_actor(tp):
    D = tim.observation_space(tp).shape[0]
    model = tnetworks.LSTMActorCritic(D, tp.m1, hidden=8, encoder=(8,),
                                      generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        model.mean.weight.mul_(30.0)
    return tek.fold_lstm_actor(trppo.RecurrentPPOConfig(), model, None)


def _jax_k7(jp, acts, dems):
    return np.asarray(jek.episode_returns_im(jp, jnp.asarray(acts.numpy()),
                                             jnp.asarray(dems.numpy()), block=acts.shape[-1],
                                             interpret=True))


# ------------------------------------------------------------- the plans

@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_plans_by_hand(name):
    """The chain route's struct, K8's and K7's columns and the records a
    block stages: K8 [on-hand, backlog, ring, actions] = 3 m1 + 1 + lt m1
    words, K7's ring place [on-hand, backlog, ring] = 2 m1 + 1 + lt m1, the
    policy kernels' lanes 4 m1 + 1 + 2 lt m1 (with the ring of requested
    orders and a float an action)."""
    _, tp = _params(name)
    m1, lt = tp.m1, tp.lt_max
    plan = tek._im_plan(tp, CPU)
    g = plan["struct"]
    assert plan["chain"] and isinstance(g, tek._ImParamsG)
    assert (g.m1, g.lt, g.rec_words) == (m1, lt, 8 * m1 + 2)
    assert g.state_words == 4 * m1 + 1 + 2 * lt * m1 and g.rec == plan["rec"].data_ptr()
    assert not g.ws and not g.ws_stride
    fused = tek._im_fused_plan(m1, lt, True)
    assert (plan["fused"].threads, plan["fused"].words) == (fused.threads, fused.words)
    assert fused.words == 3 * m1 + 1 + lt * m1
    assert fused.bytes == 4 * (fused.words * fused.threads + g.rec_words) <= tek.SMEM_OPTIN_BYTES
    k7 = plan["k7"]
    assert k7.stage == 2 * m1 + 1 + lt * m1 and k7.words == k7.stage + 2 * k7.chunk * (m1 + 1)
    assert 4 * (k7.words * k7.threads + g.rec_words) <= tek.SMEM_OPTIN_BYTES
    assert (plan["table"].numel(), plan["disc"].numel()) == (plan["tab_len"], tp.periods)


def test_chain12_lt40_by_hand():
    """IM-chain12-lt40 (obs 12 x 41 = 492): records 98 words, a policy lane
    1,009 words. K8: 32 threads of 517 words (66,568 B, 3 blocks an SM);
    K7: 32 threads, its ring place 505 words. The tile (a (64, 64) actor):
    MlpTileG at 32 lanes, the activations in place (496 rows x stride 40),
    then 1,009 x 32 words of columns and the records: 208,904 B. K27 under
    SB3's (256, 256) relu actor: no cluster tile holds it (obs rows 496 x
    stride 72 beside the slices); the wide route's WideMlpG keeps its
    buffers (492 + 256 rows x 32) in shared memory beside 32 columns and the
    records (129,544 B); "uniform" one CTA of 32 lanes. The LSTM (encoder
    64, hidden 128, 12 actions) at 32 lanes: 854 rows x 40 floats and the
    records, 137,032 B (64 lanes would take 246,344)."""
    _, tp = _params("IM-chain12-lt40")
    obs = tim.observation_space(tp).shape[0]
    assert (tp.m1, tp.lt_max, obs) == (12, 40, 492)
    plan = tek._im_plan(tp, CPU)
    assert (plan["struct"].rec_words, plan["struct"].state_words) == (98, 1009)
    assert tek._im_fused_plan(12, 40, True) == tek.ImFusedPlan(32, 517, 66_568, 3)
    assert (plan["k7"].threads, plan["k7"].stage) == (32, 505)

    st, _ = tek._im_tile_actor(tp, _actor([obs, 64, 64, 12]), torch.ones(12), CPU)
    assert isinstance(st, tek._MlpTileG) and (st.lanes, st.stride, st.ws_floats) == (32, 40, 0)
    assert st.s_state == 496 * 40 and st.s_total == 496 * 40 + 1009 * 32 + 98
    assert st.s_total * 4 == 208_904

    words, layout, extra = tek._k27_state(tp)
    assert words == 1009 and layout.topo_floats == 98 and extra == 32 * 1009 + 98
    big = _actor([obs, 256, 256, 12])
    assert tek._pack_cluster_actor(big, torch.ones(12), obs, 12, "det", tek._half_c(tp), 60,
                                   words, False, CPU, layout) is None
    wst, _ = tek._pack_wide_actor(big, torch.ones(12), obs, 12, "det", tek._half_c(tp), CPU,
                                  extra, general=True)
    assert (wst.rows0, wst.rows1, wst.ws_floats) == (492, 256, 0) and 4 * extra == 129_544
    assert 4 * ((492 + 256) * 32 + extra) <= tek.SMEM_OPTIN_BYTES
    ust, _ = tek._pack_cluster_actor(big, None, obs, 12, "uniform", tek._half_c(tp), 60, words,
                                     False, CPU, layout)
    assert (ust.cluster, ust.lanes, ust.state_words) == (1, 32, 1009)
    assert ust.floats == ust.s_state + tek._pad4(32 * 1009) + 98

    lstm = {"enc": [(torch.zeros(64, obs), torch.zeros(64, 1))], "wx": torch.zeros(512, 64),
            "wh": torch.zeros(512, 128), "bh": torch.zeros(512, 1), "wm": torch.zeros(12, 128),
            "bm": torch.zeros(12, 1)}
    lst, _ = tek._pack_lstm_actor(lstm, None, obs, 12, tek._half_c(tp), CPU, 98)
    assert (lst.lanes, lst.stride, lst.s_total) == (32, 40, 854 * 40)
    assert (lst.s_total + 98) * 4 == 137_032
    # without records (the fixed ImParams route) 12 actions pass struct Lstm's
    # half_hi: the general class takes them, its half ranges in the buffer
    gst, flat = tek._pack_lstm_actor(lstm, None, obs, 12, tek._half_c(tp), CPU)
    assert isinstance(gst, tek._LstmG)
    assert flat[gst.half_hi:gst.half_hi + 12].tolist() == list(tek._half_c(tp))


def _wide(m1, lt):
    return tim.default_params(I0=(50,) * m1, r=(2.0,) * (m1 + 1), k=(0.1,) * (m1 + 1),
                              h=(0.1,) * m1, c=(40,) * m1, L=(lt,) * m1, periods=4)


def test_past_a_block_the_plans_and_every_wrapper_raise(monkeypatch):
    """m1 = 12 and lt = 80: a policy lane takes 4 x 12 + 1 + 2 x 80 x 12 =
    1,969 words; a block of 32 lanes holds (232,448 / 4 - 98) / 32 = 1,812
    words a lane beside the records. ``_im_plan`` raises naming both before
    it builds anything on the device, so every wrapper's CUDA branch does
    too (the device faked as "cuda:0"; nothing reaches the card); lt = 70
    (1,729 words) plans."""
    tek._im_plan(_wide(12, 70), CPU)
    tp = _wide(12, 80)
    with pytest.raises(ValueError, match="1969 words; a block of 32 lanes holds 1812 words"):
        tek._im_plan(tp, CPU)
    monkeypatch.setattr(tek, "resolve_device", lambda device=None: torch.device("cuda:0"))
    obs = tim.observation_space(tp).shape[0]
    actor, std = _actor([obs, 16, 12]), torch.zeros(12)
    sac = _actor([obs, 16, 24])
    lstm = _lstm_actor(tp)
    calls = [lambda: tek.episode_returns_im_fused(tp, 1, 8),
             lambda: tek.sample_streams_debug_im(tp, 1, 8),
             lambda: tek.rollout_traj_im(tp, actor, std, 1, 8),
             lambda: tek.episode_returns_im_policy(tp, actor, 1, 8),
             lambda: tek.sample_policy_streams_debug_im(tp, actor, 1, 8),
             lambda: tek.rollout_traj_im_offpolicy(tp, actor, std, 1, 8, "det"),
             lambda: tek.rollout_traj_im_offpolicy(tp, sac, None, 1, 8, "sac"),
             lambda: tek.rollout_traj_im_offpolicy(tp, actor, None, 1, 8, "uniform"),
             lambda: tek.episode_returns_im_lstm(tp, lstm, 1, 8),
             lambda: tek.sample_lstm_streams_debug_im(tp, lstm, 1, 8),
             lambda: tek.rollout_traj_im_lstm(tp, lstm, std, 1, 8)]
    for call in calls:
        with pytest.raises(ValueError, match="1969 words"):
            call()
    with pytest.raises(ValueError, match="1969 words"):   # K7's plan, which the tensors reach
        tek._im_plan(tp, "cuda:0", False)


def test_past_a_block_k8_and_k7_name_their_words():
    with pytest.raises(ValueError, match="K8's column of 3001 words"):
        tek._im_fused_plan(40, 72, True)
    with pytest.raises(ValueError, match="K7's ring of 2961 words"):
        tek._im_k7_plan(40, 72, chain=True)


# --------------------------------------------- mirrors and the parent's bits

def test_the_chain_params_mirror_their_c_struct():
    fields = _c_struct_fields("im_step.cuh", "ImParamsG")
    assert fields[:2] == [("rec", "ptr", 1), ("ws", "ptr", 1)]
    assert _ctypes_fields(tek._ImParamsG) == fields
    assert ctypes.sizeof(tek._ImParamsG) == 16 + 4 * (len(fields) - 2) == 48


def test_the_records_are_in_im_stage_records_order():
    """c, L, I0 as ints; gain and k (m1 + 1), h, act_span and half_c (m1)
    as the f32 bits, at the offsets ``im_stage_records`` reads them."""
    text = (CSRC / "im_step.cuh").read_text()
    assert ("words, words + m1, words + 2 * m1,\n          f + 3 * m1, f + 4 * m1 + 1, "
            "f + 5 * m1 + 2, f + 6 * m1 + 2, f + 7 * m1 + 2}") in text
    _, tp = _params("IM-chain9")
    m1 = tp.m1
    rec = tek._im_records(tp).numpy()
    f = rec.view(np.float32)
    assert rec[:m1].tolist() == list(tp.c) and rec[m1:2 * m1].tolist() == list(tp.L)
    assert rec[2 * m1:3 * m1].tolist() == list(tp.I0)
    gain = [np.float32(float(u) - float(c)) for u, c in zip(tp.unit_price, tp.unit_cost)]
    assert f[3 * m1:4 * m1 + 1].tolist() == gain
    assert f[4 * m1 + 1:5 * m1 + 2].tolist() == [np.float32(k) for k in tp.k]
    assert f[5 * m1 + 2:6 * m1 + 2].tolist() == [float(h) for h in tp.holding_cost_vec[:m1]]
    assert f[6 * m1 + 2:7 * m1 + 2].tolist() == [float(c + 1) for c in tp.c]
    assert f[7 * m1 + 2:].tolist() == tek._half_c(tp) and rec.size == 8 * m1 + 2


def _parent_bytes(params):
    """``struct ImParams`` packed by hand from the parent's header
    (tools/im_caps_parent/im_step.cuh): each field in order, arrays zero past
    the params' stages."""
    text = (PARENT / "im_step.cuh").read_text()
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", text)}
    body = re.sub(r"//[^\n]*", "", re.search(r"struct ImParams \{(.*?)\n\};", text, re.S)[1])
    m1 = params.m1
    up, uc = params.unit_price, params.unit_cost
    user = int(params.dist == tek.dist.USER)
    base, table = (0, ()) if user else tek._im_demand_spec(params)
    values = {"m1": [m1], "lt": [params.lt_max], "user": [user], "tab_len": [len(table)],
              "base": [int(base)], "c": params.c, "L": params.L, "I0": params.I0,
              "gain": [np.float32(float(u) - float(c)) for u, c in zip(up, uc)],
              "k": [np.float32(k) for k in params.k], "h": list(params.holding_cost_vec[:m1]),
              "act_span": [np.float32(c + 1) for c in params.c]}
    out = b""
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, rest = decl.split(None, 1)
        for item in rest.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\w+)(?: \+ (\d+))?\])?", item.strip())
            n = defines[m[2]] + int(m[3] or 0) if m[2] else 1
            vals = list(values[m[1]]) + [0] * (n - len(values[m[1]]))
            out += struct.pack(f"<{n}{'i' if ctype == 'int' else 'f'}", *vals)
    return out


@pytest.mark.parametrize("kw", [dict(), dict(backlog=False), dict(dist=5),
                                dict(I0=(100, 120), r=(1.5, 1.0, 0.75), k=(0.1, 0.075, 0.05),
                                     h=(0.15, 0.10), c=(100, 90), L=(3, 5)),
                                dict(I0=(9,) * 8, r=(2.0,) * 9, k=(0.1,) * 9, h=(0.1,) * 8,
                                     c=(20,) * 8, L=(32,) * 8)],
                         ids=["backlog", "lost_sales", "user", "two_stages", "the_maxima"])
def test_within_the_maxima_the_parents_struct_byte_for_byte(kw):
    """The defaults, a two-stage chain and the struct maxima (8 stages, lead
    time 32) take the fixed route: the parent's ImParams, field for field
    and byte for byte, and the parent's K8 and K7 layouts."""
    if kw.get("dist") == 5:   # USER mode: no table
        kw = dict(dist=5, user_D=tuple(range(30)))
    tp = tim.default_params(**kw)
    plan = tek._im_plan(tp, CPU)
    assert not plan["chain"] and isinstance(plan["struct"], tek._ImParams)
    assert bytes(plan["struct"]) == _parent_bytes(tp)
    fused = tek._im_fused_plan(tp.m1, tp.lt_max)
    assert (plan["fused"].threads, plan["fused"].words) == (fused.threads, tp.m1 * tp.lt_max)
    assert plan["k7"].stage == tp.m1 * tp.lt_max
    assert (CSRC / "im_step.cuh").read_text().count("struct ImParams {") == 1
    assert _c_struct_fields("im_step.cuh", "ImParams") == _ctypes_fields(tek._ImParams)


def test_the_chain_entry_points_take_their_twins_arguments():
    """Every InvManagement C entry point has a *_chain twin with its
    arguments (the params struct is ImParamsG there)."""
    for stem in ("im_episode", "im_policy", "im_offpolicy", "im_lstm"):
        sigs = _build.SIGNATURES[stem]
        chains = [fn for fn in sigs if fn.endswith("_chain")]
        fixed = [fn for fn in sigs if not fn.endswith(("_chain", "_any"))]
        assert sorted(fn[:-6] for fn in chains) == sorted(fixed)
        assert all(sigs[fn] == sigs[fn[:-6]] for fn in chains)
        assert all(f"{fn}(const ImParamsG* p," in (CSRC / f"{stem}.cu").read_text()
                   or fn.endswith("occupancy_chain") for fn in chains)


# --------------------------------------------- the one-pass step by hand

def _step_any(tp, t, s, act, d):
    """im_step_any of csrc/im_step.cuh in NumPy over (B,) lanes: one pass
    over the stages in its order; ``s`` holds inv (m1, B), bkl (m1 + 1, B),
    the ring of fulfilled orders (lt m1, B; period p in slot p % lt) and the
    slot. Returns (requested orders (m1, B), the f32 profit)."""
    m1, lt = tp.m1, tp.lt_max
    gain = [np.float32(float(u) - float(c)) for u, c in zip(tp.unit_price, tp.unit_cost)]
    k = [np.float32(x) for x in tp.k]
    h = [np.float32(x) for x in tp.holding_cost_vec]
    profit = np.zeros(d.shape, np.float32)
    link_req = link_ful = np.zeros(d.shape, np.int64)
    req = np.zeros((m1, d.size), np.int64)
    for i in range(m1 + 1):
        if i < m1:
            r = np.maximum(act[i], 0)
            req[i] = r
            order_req = r + s["bkl"][i + 1]
            sup = s["inv"][i + 1] if i + 1 < m1 else 1 << 30
            r_ful = np.minimum(np.minimum(order_req, tp.c[i]), sup)
            li = tp.L[i]
            due = r_ful if li == 0 else (s["ring"][((s["slot"] - li) % lt) * m1 + i]
                                         if t >= li else 0)
            inv = s["inv"][i] + due
            if i == 0:
                to_fill = np.maximum(d, 0) + s["bkl"][0]
                sold = np.minimum(inv, to_fill)
                unfilled = to_fill - sold
                inv = inv - sold
            else:
                inv = inv - r_ful
                sold, unfilled = link_ful, link_req - link_ful
            if lt > 0:
                s["ring"][s["slot"] * m1 + i] = r_ful
            link_req, link_ful = order_req, r_ful
        else:
            sold, unfilled = link_ful, link_req - link_ful
        profit = profit + gain[i] * sold.astype(np.float32)
        profit = profit - k[i] * unfilled.astype(np.float32)
        if i < m1:
            profit = profit - h[i] * np.maximum(inv, 0).astype(np.float32)
            s["inv"][i] = inv
        s["bkl"][i] = unfilled if tp.backlog else 0
    if lt > 0:
        s["slot"] = (s["slot"] + 1) % lt
    return req, profit


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("backlog", [True, False], ids=["backlog", "lost_sales"])
def test_the_one_pass_step_gives_the_plain_steps_bits(name, backlog):
    _, tp = _params(name, backlog=backlog)
    m1, lt, n = tp.m1, tp.lt_max, 256
    rng = np.random.default_rng(7)
    inv, bkl, RH = tek._im_reset_rows(tp, n, CPU)
    s = {"inv": np.array([x.numpy() for x in inv], np.int64),
         "bkl": np.zeros((m1 + 1, n), np.int64), "ring": np.zeros((lt * m1, n), np.int64),
         "slot": 0}
    for t in range(tp.periods):
        act = rng.integers(-5, max(tp.c) + 10, (m1, n))
        d = rng.integers(-3, 60, n)
        inv, bkl, RH, r_req, profit = tek._im_step_math(
            tp, t, inv, bkl, RH, [torch.from_numpy(a.astype(np.int32)) for a in act],
            torch.from_numpy(d.astype(np.int32)))
        req, mine = _step_any(tp, t, s, act, d)
        np.testing.assert_array_equal(s["inv"], np.array([x.numpy() for x in inv]))
        np.testing.assert_array_equal(s["bkl"], np.array([x.numpy() for x in bkl]))
        np.testing.assert_array_equal(req, np.array([x.numpy() for x in r_req]))
        assert mine.view(np.int32).tolist() == profit.numpy().view(np.int32).tolist()


# ------------------------------------------- the slice against the JAX package

def _check_returns(name, jp, ret, acts, dems):
    """Returns against JAX: the discounted reward sum of ``_replay_chain``
    (XLA) on the streams, and JAX's Pallas ``episode_returns_im`` in
    interpret mode, which traces a program that grows with m1 x lt_max x
    periods (minutes at IM-chain12-lt40's 480-row ring over 60 periods), so
    it runs on IM-chain9 and IM-lt33."""
    _, rew, _ = _replay_chain(jp, acts.numpy(), dems.numpy())
    np.testing.assert_allclose(ret.numpy(), np.asarray(rew, np.float64).sum(0), rtol=1e-5,
                               atol=1e-3)
    if name != "IM-chain12-lt40":
        np.testing.assert_allclose(ret.numpy(), _jax_k7(jp, acts, dems), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_random_episode_returns_replays_through_jax(name):
    jp, tp = _params(name)
    gen = torch.Generator().manual_seed(5)
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    out = tfe.random_episode_returns(tp, gen, B, device=CPU)
    acts, dems = tek.sample_streams_debug_im(tp, tfe.kernel_seed(replay), B, device=CPU)
    _check_returns(name, jp, out, acts, dems)
    assert len(np.unique(acts)) > 40


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_policy_episode_returns_replays_through_jax(name, deterministic):
    jp, tp = _params(name)
    actor = _mlp_actor(tp)
    log_std = None if deterministic else torch.full((tp.m1,), -0.7)
    gen = torch.Generator().manual_seed(6)
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    out = tfe.policy_episode_returns(tp, actor, gen, B, 1, deterministic, log_std, CPU)
    ret, acts, dems = tek.sample_policy_streams_debug_im(tp, actor, tfe.kernel_seed(replay), B,
                                                         1, log_std, CPU)
    assert torch.equal(out, ret)
    _check_returns(name, jp, out, acts[:, 0], dems[:, 0])
    assert len(np.unique(acts)) > 10


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lstm_policy_episode_returns_replays_through_jax(name):
    jp, tp = _params(name)
    actor = _lstm_actor(tp)
    gen = torch.Generator().manual_seed(8)
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    out = tfe.lstm_policy_episode_returns(tp, actor, gen, B, CPU)
    ret, acts, dems = tek.sample_lstm_streams_debug_im(tp, actor, tfe.kernel_seed(replay), B,
                                                       CPU)
    assert torch.equal(out, ret)
    _check_returns(name, jp, out, acts, dems)


def _replay(jp, tr):
    """A trajectory's on-hand (its T + 1 snapshots) exactly and its rewards
    within rtol=1e-5, atol=1e-2 against JAX's chain on its actions and
    demand."""
    obs_all, rew, final_inv = _replay_chain(jp, tr["actions"].numpy(), tr["demand"].numpy())
    T, m1 = tr["reward"].shape[0], tr["actions"].shape[1]
    np.testing.assert_array_equal(tr["inv"][:T].numpy(),
                                  np.asarray(obs_all)[:T, :, :m1].transpose(0, 2, 1))
    np.testing.assert_array_equal(tr["inv"][T].numpy(), np.asarray(final_inv))
    np.testing.assert_allclose(tr["reward"].numpy(), np.asarray(rew), rtol=1e-5, atol=1e-2)


def _capture(monkeypatch, name):
    """Record every trajectory ``tek.<name>`` returns."""
    seen, fn = [], getattr(tek, name)

    def wrapped(*a, **k):
        seen.append(fn(*a, **k))
        return seen[-1]
    monkeypatch.setattr(tek, name, wrapped)
    return seen


def test_ppo_kernel_update_past_the_caps(monkeypatch):
    jp, tp = _params("IM-chain12-lt40")
    seen = _capture(monkeypatch, "rollout_traj_im")
    cfg = tppo.PPOConfig(num_envs=32, rollout_steps=tp.periods, num_minibatches=4,
                         update_epochs=1, pi_arch=(16, 16), vf_arch=(16, 16), rollout="kernel")
    state, metrics = tppo.train(tim.ENV, tp, cfg, torch.Generator().manual_seed(0),
                                32 * tp.periods, device=CPU)
    assert len(seen) == 1 and seen[0]["raw"].shape == (60, 12, 32)
    assert all(np.isfinite(v).all() for v in metrics.values())
    _replay(jp, seen[0])


def test_recurrent_kernel_update_past_the_caps(monkeypatch):
    jp, tp = _params("IM-chain12-lt40")
    seen = _capture(monkeypatch, "rollout_traj_im_lstm")
    cfg = trppo.RecurrentPPOConfig(num_envs=16, rollout_steps=tp.periods, num_minibatches=2,
                                   update_epochs=1, hidden=8, encoder=(8,), rollout="kernel")
    _, _, metrics = trppo.train(tim.ENV, tp, cfg, torch.Generator().manual_seed(0),
                                16 * tp.periods, device=CPU)
    assert len(seen) == 1 and seen[0]["actions"].shape == (60, 12, 16)
    assert all(np.isfinite(v).all() for v in metrics.values())
    _replay(jp, seen[0])


def test_td3_kernel_iteration_past_the_caps(monkeypatch):
    jp, tp = _params("IM-chain12-lt40")
    seen = _capture(monkeypatch, "rollout_traj_im_offpolicy")
    cfg = top.OffPolicyConfig(algo="td3", collect="kernel", num_envs=16,
                              buffer_size=16 * tp.periods, batch_size=32, start_steps=0,
                              updates_per_iter=1, pi_arch=(16, 16), q_arch=(16, 16))
    _, _, metrics = top.train(tim.ENV, tp, cfg, torch.Generator().manual_seed(1),
                              16 * tp.periods, log_every=1, device=CPU)
    assert len(seen) == 1 and seen[0]["raw"].shape == (60, 12, 16)
    assert np.isfinite(metrics["mean_step_reward"]).all()
    _replay(jp, seen[0])


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chain route's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_k7_k8_k9_chain_exact_on_cuda(name, cuda):
    """K9's streams equal plain K9's, K8 equals plain K8 and K7 (streamed
    and _random) on K9's streams equals K8, bit for bit."""
    _, tp = _params(name)
    acts, dems = tek.sample_streams_debug_im(tp, 3, 4096, 2, cuda)
    want_a, want_d = tek.sample_streams_debug_im(tp, 3, 4096, 2, CPU)
    assert torch.equal(acts.cpu(), want_a) and torch.equal(dems.cpu(), want_d)
    k8 = tek.episode_returns_im_fused(tp, 3, 4096, 2, cuda)
    assert torch.equal(k8.cpu(), tek.episode_returns_im_fused(tp, 3, 4096, 2, CPU))
    assert torch.equal(tek.episode_returns_im(tp, acts[:, 0].contiguous(),
                                              dems[:, 0].contiguous()), k8[0])
    assert torch.equal(tek.episode_returns_im_random(tp, dems[:, 0].contiguous(), 3), k8[0])


def _share(got, want, rtol=1e-4, atol=1e-2):
    err = (got.double().cpu() - want.double()).abs()
    ok = (err <= atol + rtol * want.double().abs()).reshape(-1, got.shape[-1]).all(0)
    return float(ok.double().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_policy_kernels_chain_by_their_gates_on_cuda(name, cuda):
    """K10-K12 and K22-K24 against their plain versions on >= 99% of lanes
    (demand bit for bit); K27 det, sac and uniform: demand bit for bit, the
    env chain on its actions gives its on-hand exactly."""
    _, tp = _params(name)
    actor = _mlp_actor(tp, (64, 64))
    std = torch.full((tp.m1,), -0.7)
    tr = tek.rollout_traj_im(tp, actor, std, 3, 1024, device=cuda)
    want = tek._rollout_traj_im_plain(tp, actor, tek.clipped_std(std), 3, 1024, CPU)
    assert torch.equal(tr["demand"].cpu(), want["demand"])
    assert min(_share(tr[k], want[k]) for k in ("inv", "actions", "reward")) >= 0.99
    ret, acts, dems = tek.sample_policy_streams_debug_im(tp, actor, 3, 1024, 2, std, cuda)
    wret, wacts, wdems = tek._im_policy_plain(tp, actor, tek.clipped_std(std), 3, 1024, 2, CPU,
                                              True)
    assert torch.equal(dems.cpu(), wdems) and _share(ret, wret) >= 0.99
    lstm = _lstm_actor(tp)
    k23, a23, d23 = tek.sample_lstm_streams_debug_im(tp, lstm, 3, 1024, cuda)
    w23, _, wd23 = tek._im_lstm_plain(tp, lstm, 3, 1024, CPU, True)
    assert torch.equal(d23.cpu(), wd23) and _share(k23, w23) >= 0.99
    k24 = tek.rollout_traj_im_lstm(tp, lstm, std, 3, 1024, cuda)
    w24 = tek._rollout_traj_im_lstm_plain(tp, lstm, tek.clipped_std(std), 3, 1024, CPU)
    assert min(_share(k24[k], w24[k]) for k in ("inv", "actions", "reward")) >= 0.99
    obs = tim.observation_space(tp).shape[0]
    for mode, out in (("det", tp.m1), ("sac", 2 * tp.m1), ("uniform", tp.m1)):
        off = _actor([obs, 256, 256, out], 0.05, 9)
        tr = tek.rollout_traj_im_offpolicy(tp, off, torch.full((tp.m1,), -1.0), 3, 1024, mode,
                                           "relu", cuda)
        want = tek._rollout_traj_im_plain(tp, off, tek._offpolicy_std(mode, torch.full(
            (tp.m1,), -1.0)), 3, 1024, CPU, mode, "relu")
        assert torch.equal(tr["demand"].cpu(), want["demand"])
        state, _ = tim.reset(tp, batch=1024, device=cuda)
        for t in range(tp.periods):
            assert torch.equal(state.inv.T, tr["inv"][t])
            state, _ = tim.step_with_demand(tp, state, tr["actions"][t].T, tr["demand"][t])
