"""Newsvendor at any lead time: the column instances of the Newsvendor
kernels past NV_MAX_L (csrc/nv_episode.cu: K13's ``k_nv_returns<RANDOM,
kK13Column>``, K14/K16's ``k_nv_episodes_column``; csrc/nv_policy.cu:
K28's wide route with every lane's pipeline in shared memory), as far as the
CPU reaches them, against hand counts and, through the plain versions,
against the JAX package.

Three configurations, benchmark_newsvendor.py:35-38's ENV_CONFIG_EVAL with a
longer lead time: ``NV-lt60`` (60 periods of lead time, 120 periods; obs
65), ``NV-lt33`` (one past the register route, 50 periods) and ``NV-lt64``
(a lead time past the horizon of 50: no order ever arrives).

- The plans by hand: K13's column (two staging buffers of 8 periods of 2
  words and the pipeline's L) and its block, K14-K17's table and pipeline
  (K + L words a thread) and their block, K19's tile, K28's cluster and wide
  route; past a block of 32 threads' columns (the shared-memory constant
  patched small) ``_nv_plan`` and every Newsvendor wrapper's CUDA branch
  raise ValueError naming the words needed and held.
- ``_NvParams`` against ``struct NvParams`` parsed from csrc/nv_step.cuh;
  params at lead times up to NV_MAX_L pack the parent's struct (parsed from
  tools/nv_caps_parent/nv_step.cuh) byte for byte; the dispatch to the
  column instances in the source.
- Plain K13 against JAX's ``episode_returns_nv`` in interpret mode
  (``rtol=1e-5, atol=1e-2``, tests/test_torch_nv_kernels.py's; at NV-lt60,
  whose interpret-mode trace takes ~20 s, against JAX's XLA step chain);
  plain K16/K17 and K19/K20, their dumps replayed through JAX's
  ``step_with_demand`` chain (``_nv_reference_returns``) at the same
  tolerance; ``assemble_obs_from_streams`` at lead time 60 against JAX's bit
  for bit.
- One PPO ``rollout="kernel"`` update and one TD3 ``collect="kernel"``
  iteration on NV-lt60 on the CPU, each trajectory its learner consumed
  replayed through JAX's chain: its capped orders within ``rtol=1e-5,
  atol=1e-2``, its rewards within ``atol=1e-1`` (JAX's env sums the
  pipeline with jnp.sum: a binding cap moves by an ulp of the sum).

The cuda-marked cases are phase 56's checks of chip_smoke.py at a small
size; they skip without a card.
"""

import dataclasses
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_episode_kernels import _nv_reference_returns
from test_torch_net_k2_plan import CSRC, _c_struct_fields, _ctypes_fields

from or_gym_inventory_torch.agents import off_policy as top
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import nv_poisson
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
B = 64
PARENT = CSRC.parents[1] / "tools" / "nv_caps_parent"
EVAL = dict(p_max=100.0, h_max=5.0, k_max=10.0, mu_max=200.0)   # ENV_CONFIG_EVAL's economics
CONFIGS = {"NV-lt60": dict(lead_time=60, step_limit=120),
           "NV-lt33": dict(lead_time=33, step_limit=50),
           "NV-lt64": dict(lead_time=64, step_limit=50)}


def _params(name=None, **kw):
    jp = jnv.default_params(**{**EVAL, **(CONFIGS[name] if name else {}), **kw})
    return jp, tnv.NewsvendorParams(**dataclasses.asdict(jp))


def _actor(dims, scale=0.05, seed=0):
    g = torch.Generator().manual_seed(seed)
    Ws = tuple(torch.randn(i, o, generator=g) * scale for i, o in zip(dims, dims[1:]))
    return Ws, tuple(torch.zeros(o) for o in dims[1:])


def _mlp_actor(tp, arch=(16,)):
    """A folded actor whose orders spread over [0, max_order]: the obs
    scaled down, a wide output layer."""
    actor = _actor([tp.obs_dim, *arch, 1], 0.05, 3)
    return actor[0][:-1] + (actor[0][-1] * 30.0,), actor[1]


@pytest.fixture(autouse=True)
def _fresh_plans():
    """The plans are cached per params; a test that patches the shared
    memory of a block must not see another's."""
    for fn in (tek._nv_plan, tek._nv_k13_plan):
        fn.cache_clear()
    yield
    for fn in (tek._nv_plan, tek._nv_k13_plan):
        fn.cache_clear()


# ------------------------------------------------------------- the plans

# (words a thread, bytes a block, blocks an SM) by hand. K13: 4 x 8 + L words
# at 128 threads, blocks min(233,472 // (bytes + 1,024), 16, 32). K14-K17: K
# = 177 table words + L at the block that holds the most threads an SM
# (min(233,472 // (bytes + 1,024), 21 warps by 96 registers, 2,048 // threads,
# 32)): 32 threads, since 64 hold fewer (NV-lt60: 3 x 64 < 7 x 32).
PLANS = {"NV-lt60": ((92, 47_104, 4), (237, 30_336, 7)),
         "NV-lt33": ((65, 33_280, 6), (210, 26_880, 8)),
         "NV-lt64": ((96, 49_152, 4), (241, 30_848, 7))}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_column_plans_by_hand(name):
    _, tp = _params(name)
    (k13_words, k13_bytes, k13_blocks), (words, nbytes, blocks) = PLANS[name]
    L = tp.lead_time
    st = tek._nv_plan(tp, CPU)["struct"]
    assert (st.L, st.K, st.k13_threads, st.threads, st.table) == (L, 177, 128, 32, 1)
    k13 = tek._nv_k13_launch(L)
    assert (k13.words, k13.ring, k13.bytes, k13.blocks_per_sm) == (k13_words, L, k13_bytes,
                                                                   k13_blocks)
    assert k13.words == 4 * tek.NV_K13_CHUNK + L and k13.bytes == 4 * k13.words * 128
    assert tek._nv_table_plan(177, L) == tek.NvTablePlan(32, nbytes, blocks, True, L)
    assert words == 177 + L and nbytes == 4 * words * 32
    # the dumps step nothing: their table alone fits the same block
    assert 4 * 177 * 32 <= nbytes


def test_nv_lt60_policy_kernels_by_hand():
    """NV-lt60 (obs 65): K19's tile under a (64, 64) actor is MlpTile at 64
    lanes, up front: 60 rows of demand (two a word), then max(the table's
    177 rows, the activations' 72 rows at stride 72 in place and the
    pipeline's 60 rows) x 64 lanes: 3,840 + 11,328 floats, 60,672 B, the ring
    at 3,840 + 5,184. K28 under SB3's (256, 256) actor: 4 CTAs over 32 lanes
    (64 do not fit beside 120 periods of demand and noise), 66 state words a
    lane (econ, the pipeline, its head); under (512, 512) the wide route's
    WideMlp, two buffers of 512 x 32 and the 32 lanes' pipelines, 60 x 32
    floats: 138,752 B."""
    _, tp = _params("NV-lt60")
    st = tek._nv_plan(tp, CPU)["struct"]
    tst, _ = tek._nv_tile_actor(tp, _actor([65, 64, 64, 1]), None, CPU)
    tile, nt = tek._nv_tile_launch(tst, st, tp.step_limit)
    assert isinstance(tile, tek._MlpTile) and (tile.lanes, tile.stride) == (64, 72)
    assert (nt.layout, nt.s_dem, nt.s_table, nt.s_ring) == (1, 0, 3_840, 3_840 + 72 * 72)
    assert tile.s_total == 3_840 + 177 * 64 and tile.s_total * 4 == 60_672
    big = _actor([65, 256, 256, 1])
    cst, _ = tek._pack_cluster_actor(big, torch.ones(1), 65, 1, "det", tek._nv_half_hi(tp), 120,
                                     66, True, CPU)
    assert (cst.cluster, cst.lanes, cst.state_words) == (4, 32, 66)
    assert tek._cluster_plan((65, 256, 256, 1), 1, True, 120, 66, True, 4, 64).floats * 4 \
        > tek.SMEM_OPTIN_BYTES
    wide = _actor([65, 512, 512, 1])
    assert tek._pack_cluster_actor(wide, torch.ones(1), 65, 1, "det", tek._nv_half_hi(tp), 120,
                                   66, True, CPU) is None
    wst, _ = tek._pack_wide_actor(wide, torch.ones(1), 65, 1, "det", tek._nv_half_hi(tp), CPU,
                                  tek._nv_wide_extra(tp))
    assert isinstance(wst, tek._WideMlp) and wst.rows == 512
    assert 4 * (2 * 512 * 32 + tek._nv_wide_extra(tp)) == 138_752
    assert tek._nv_wide_extra(tp) == 32 * 60


def test_an_obs_past_the_fixed_tile_takes_the_general_class():
    """Lead time 300 (obs 305, past MlpTile's widths of 256): K19's tile
    takes MlpTileG for the (64, 64) actor, its 300 pipeline rows beside the
    table; lead time 60 keeps MlpTile."""
    _, tp = _params(lead_time=300, step_limit=8)
    st = tek._nv_plan(tp, CPU)["struct"]
    tst, _ = tek._nv_tile_actor(tp, _actor([305, 64, 64, 1]), None, CPU)
    tile, nt = tek._nv_tile_launch(tst, st, tp.step_limit)
    assert isinstance(tile, tek._MlpTileG) and nt.s_ring >= 0
    assert tile.s_total >= nt.s_ring + 300 * tile.lanes


def test_past_a_block_the_plans_and_every_wrapper_raise(monkeypatch):
    """With a block's shared memory patched to 12,800 bytes (100 words a
    thread of 32): lead time 60 plans K13 at 32 threads (92 words) and
    K14-K17's linear count (177 + 60 words do not fit; the ring's 60 do);
    lead time 80 needs 32 + 80 = 112 words of K13's column: ``_nv_plan``
    raises naming them, before it builds anything on the device, so every
    wrapper's CUDA branch does too (the device faked as "cuda:0"; nothing
    reaches the card). K14-K17's own refusal names its column."""
    monkeypatch.setattr(tek, "SMEM_OPTIN_BYTES", 12_800)
    _, tp60 = _params(lead_time=60, step_limit=8)
    st = tek._nv_plan(tp60, CPU)["struct"]
    assert (st.k13_threads, st.threads, st.table) == (32, 32, 0)
    # blocks: min(233,472 // 8,704, 65,536 // (32 x 104) warps by the column
    # instances' 98 registers rounded to 8, 64, 32)
    assert tek._nv_table_plan(177, 60) == tek.NvTablePlan(32, 7_680, 19, False, 60)
    with pytest.raises(ValueError, match="K14/K16's column of 120 words a thread .* holds 100"):
        tek._nv_table_plan(177, 120)
    _, tp = _params(lead_time=80, step_limit=8)
    msg = "lead_time=80: K13's column of 112 words a thread .* holds 100 words a thread"
    with pytest.raises(ValueError, match=msg):
        tek._nv_plan(tp, CPU)
    monkeypatch.setattr(tek, "resolve_device", lambda device=None: torch.device("cuda:0"))
    actor, std = _actor([tp.obs_dim, 16, 1]), torch.zeros(1)
    sac = _actor([tp.obs_dim, 16, 2])
    calls = [lambda: tek.episode_returns_nv_reset_fused(tp, 1, 8),
             lambda: tek.sample_streams_debug_nv_reset(tp, 1, 8),
             lambda: tek.rollout_traj_nv(tp, actor, std, 1, 8),
             lambda: tek.episode_returns_nv_policy(tp, actor, 1, 8),
             lambda: tek.sample_policy_streams_debug_nv(tp, actor, 1, 8),
             lambda: tek.rollout_traj_nv_offpolicy(tp, actor, std, 1, 8, "det"),
             lambda: tek.rollout_traj_nv_offpolicy(tp, sac, None, 1, 8, "sac"),
             lambda: tek.rollout_traj_nv_offpolicy(tp, actor, None, 1, 8, "uniform"),
             # K13-K15 take their device from their tensors: their plan
             lambda: tek._nv_plan(tp, "cuda:0")]
    for call in calls:
        with pytest.raises(ValueError, match=msg):
            call()


def test_the_card_bound_by_hand():
    """A block of 32 threads holds 232,448 / 128 = 1,816 words a thread: K13's
    column takes 32 + L, so lead time 1,784 plans and 1,785 does not; K14-K17
    keep their table while K + L <= 1,816 (lead time 1,639 at mu_max 200) and
    count linearly past it."""
    assert tek._nv_column_words() == 1_816
    _, tp = _params(lead_time=1_784, step_limit=4)
    st = tek._nv_plan(tp, CPU)["struct"]
    assert (st.k13_threads, st.table) == (32, 0)
    _, tp = _params(lead_time=1_639, step_limit=4)
    assert tek._nv_plan(tp, CPU)["struct"].table == 1
    _, tp = _params(lead_time=1_785, step_limit=4)
    with pytest.raises(ValueError, match="K13's column of 1817 words"):
        tek._nv_plan(tp, CPU)


# ---------------------------------------- the mirror, the parent's bits, the source

def test_the_params_mirror_their_c_struct():
    assert _c_struct_fields("nv_step.cuh", "NvParams") == _ctypes_fields(tek._NvParams)
    assert (CSRC / "nv_step.cuh").read_text().count("struct NvParams {") == 1


def _parent_bytes(params, threads, k13_threads):
    """``struct NvParams`` packed by hand from the parent's header
    (tools/nv_caps_parent/nv_step.cuh), each field in order."""
    text = (PARENT / "nv_step.cuh").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct NvParams \{(.*?)\n\};", text, re.S)[1])
    Wb, K, lgam = nv_poisson.window(params)
    values = {"L": params.lead_time, "K": K, "threads": threads, "table": 1,
              "kc_max": len(lgam) - 1, "wb": Wb, "max_inv": params.max_inventory,
              "max_order": params.max_order_quantity, "p_max": params.p_max,
              "h_max": params.h_max, "k_max": params.k_max, "mu_max": params.mu_max,
              "k13_threads": k13_threads}
    out = b""
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, rest = decl.split(None, 1)
        for item in rest.split(","):
            out += struct.pack("<i" if ctype == "int" else "<f", values[item.strip()])
    return out


@pytest.mark.parametrize("L", [0, 5, 32])
def test_within_nv_max_l_the_parents_struct_byte_for_byte(L):
    """At lead times up to NV_MAX_L the plan is the parent's: K14-K17 at 64
    threads a block (177 table words a thread at mu_max 200), K13 at 128,
    the struct the parent's field for field and byte for byte."""
    _, tp = _params(lead_time=L)
    st = tek._nv_plan(tp, CPU)["struct"]
    assert bytes(st) == _parent_bytes(tp, 64, 128)
    assert tek._nv_k13_launch(0) == tek._nv_k13_plan() and tek._nv_table_plan(177).ring == 0
    assert _c_struct_fields("nv_step.cuh", "NvParams") == _c_struct_fields(
        "../../tools/nv_caps_parent/nv_step.cuh", "NvParams")


def test_the_column_instances_in_the_source():
    """No kernel writes past a local ring: K14/K16 past NV_MAX_L run
    k_nv_episodes_column (the pipeline in shared memory), every other
    launch the parent's k_nv_episodes, whose dumps now reset no pipeline,
    so its one ``nv_reset`` of the local ring runs at a lead time within
    NV_MAX_L alone; K28's wide route keeps its pipelines after the
    activations and asks for them; no Newsvendor kernel of nv_policy.cu
    keeps a local ring."""
    episode = (CSRC / "nv_episode.cu").read_text()
    parent = (PARENT / "nv_episode.cu").read_text()
    start = parent.index("template <bool ECON_IN, bool DUMP, bool TABLE>\n__global__")
    body = parent[start:parent.index("\n}\n", start)]
    assert body.count("  nv_reset(p, s);\n") == 1
    assert body.replace("  nv_reset(p, s);\n", "  if (!DUMP) nv_reset(p, s);  // a dump steps no "
                        "pipeline (any lead time)\n") in episode
    assert episode.count("nv_reset(p, s)") == 1 and "NvEpisode" not in episode[
        episode.index("__global__ void k_nv_episodes_column("):]
    assert "template <bool ECON_IN, bool TABLE>\n__global__ void k_nv_episodes_column(" in episode
    assert ("  if (!DUMP && p.L > NV_MAX_L)\n    return p.table ? launch_column<ECON_IN, true>"
            in episode)
    assert ("const size_t smem = (size_t)((TABLE ? p.K : 0) + p.L) * p.threads * sizeof(float);"
            in episode)
    policy = (CSRC / "nv_policy.cu").read_text()
    assert "NvEpisode" not in policy
    assert "const NvSharedRing ring{smem + wide_smem_acts(m) + n, kWideLanes};" in policy
    assert ("const size_t smem = wide_smem_bytes(*wm) + (size_t)kWideLanes * p->L * "
            "sizeof(float);") in policy


# ------------------------------------------- the slice against the JAX package

def _streams(jp, tp, seed):
    r = np.random.default_rng(seed)
    u = r.random((5, B)).astype(np.float32)
    econ = np.stack([np.asarray(x) for x in jek._nv_econ_from_uniforms(jp, jnp.asarray(u))])
    acts = r.uniform(-50.0, tp.max_order_quantity * 1.1, (tp.step_limit, B)).astype(np.float32)
    dems = r.poisson(econ[4], (tp.step_limit, B)).astype(np.float32)
    return econ, acts, dems


def _jax_returns(name, jp, econ, acts, dems):
    """JAX's returns on the streams: its Pallas K13 in interpret mode, or at
    NV-lt60 its XLA step chain."""
    args = (jnp.asarray(np.asarray(econ)), jnp.asarray(np.asarray(acts)),
            jnp.asarray(np.asarray(dems)))
    if name == "NV-lt60":
        return np.asarray(_nv_reference_returns(jp, *args))
    return np.asarray(jek.episode_returns_nv(jp, *args, block=args[0].shape[1],
                                             interpret=True))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_k13_matches_jax(name):
    jp, tp = _params(name)
    econ, acts, dems = _streams(jp, tp, tp.lead_time)
    t = [torch.from_numpy(x) for x in (econ, acts, dems)]
    got = tek.episode_returns_nv(tp, *t)
    np.testing.assert_allclose(got.numpy(), _jax_returns(name, jp, econ, acts, dems),
                               rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_random_episode_returns_replay_through_jax(name):
    """``random_episode_returns`` (plain K16) equal to K16 on its seed, and
    K17's dump of it replayed through JAX's chain; on NV-lt64 no order
    arrives, so no episode sells a unit."""
    jp, tp = _params(name)
    gen = torch.Generator().manual_seed(5)
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    out = tfe.random_episode_returns(tp, gen, B, 2, device=CPU)
    seed = tfe.kernel_seed(replay)
    econ, acts, dems = tek.sample_streams_debug_nv_reset(tp, seed, B, 2, device=CPU)
    ret = out.reshape(2, B)
    for e in range(2):
        np.testing.assert_allclose(
            ret[e].numpy(), np.asarray(_nv_reference_returns(
                jp, jnp.asarray(econ[e].numpy()), jnp.asarray(acts[:, e].numpy()),
                jnp.asarray(dems[:, e].numpy()))), rtol=1e-5, atol=1e-2)
    assert len(np.unique(acts)) > 100
    if name == "NV-lt64":   # no sale: each period costs its order and its shortage
        assert bool((ret <= 0).all())


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_policy_episode_returns_replay_through_jax(name, deterministic):
    """``policy_episode_returns`` (plain K19) equal to K20's returns on its
    seed, and K20's orders (before the cap) and demand replayed through
    JAX's chain give them."""
    jp, tp = _params(name)
    actor = _mlp_actor(tp)
    log_std = None if deterministic else torch.full((1,), -0.7)
    gen = torch.Generator().manual_seed(6)
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    out = tfe.policy_episode_returns(tp, actor, gen, B, 1, deterministic, log_std, CPU)
    ret, econ, acts, dems = tek.sample_policy_streams_debug_nv(tp, actor,
                                                               tfe.kernel_seed(replay), B, 1,
                                                               log_std, CPU)
    assert torch.equal(out, ret)
    np.testing.assert_allclose(ret.numpy(), np.asarray(_nv_reference_returns(
        jp, jnp.asarray(econ[0].numpy()), jnp.asarray(acts[:, 0].numpy()),
        jnp.asarray(dems[:, 0].numpy()))), rtol=1e-5, atol=1e-2)
    assert len(np.unique(acts)) > 100


def test_assemble_obs_at_lead_time_60_matches_jax():
    jp, tp = _params("NV-lt60")
    r = np.random.default_rng(1)
    econ = r.random((5, B)).astype(np.float32) * 100
    orders = r.random((tp.step_limit, B)).astype(np.float32) * 50
    got = tnv.assemble_obs_from_streams(tp, torch.from_numpy(econ), torch.from_numpy(orders))
    want = np.asarray(jnv.assemble_obs_from_streams(jp, jnp.asarray(econ), jnp.asarray(orders)))
    assert got.shape == (121, B, 65)
    np.testing.assert_array_equal(got.numpy(), want)


def _replay(jp, tr, orders_raw):
    """A trajectory against JAX's chain on its econ, demand and the orders the
    kernel stepped (before the cap): the capped orders (the pipeline's newest
    slot) within rtol=1e-5, atol=1e-2 and the rewards within rtol=1e-5,
    atol=1e-1. JAX's env sums the pipeline with jnp.sum, the port oldest
    first, so a binding cap may move by an ulp of the pipeline's sum (~1e-3
    at 60 slots of orders to 200) and the reward by that times the cost
    (to 100)."""
    def one(econ, acts, dems):
        state, _ = jnv.reset_with_econ(jp, econ)

        def body(state, inputs):
            a, d = inputs
            state, ts = jnv.step_with_demand(jp, state, a[None], d)
            return state, (ts.reward, state.pipeline[-1])
        return jax.lax.scan(body, state, (acts, dems))[1]

    rew, capped = jax.vmap(one, in_axes=(1, 1, 1), out_axes=1)(
        jnp.asarray(tr["econ"].numpy()), jnp.asarray(orders_raw.numpy()),
        jnp.asarray(tr["demand"].numpy()))
    np.testing.assert_allclose(tr["orders"].numpy(), np.asarray(capped), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(tr["reward"].numpy(), np.asarray(rew), rtol=1e-5, atol=1e-1)


def _capture(monkeypatch, name):
    """Record every trajectory ``tek.<name>`` returns."""
    seen, fn = [], getattr(tek, name)

    def wrapped(*a, **k):
        seen.append(fn(*a, **k))
        return seen[-1]
    monkeypatch.setattr(tek, name, wrapped)
    return seen


def test_ppo_kernel_update_at_lead_time_60(monkeypatch):
    jp, tp = _params("NV-lt60")
    seen = _capture(monkeypatch, "rollout_traj_nv")
    cfg = tppo.PPOConfig(num_envs=32, rollout_steps=tp.step_limit, num_minibatches=4,
                         update_epochs=1, pi_arch=(16, 16), vf_arch=(16, 16), rollout="kernel")
    _, metrics = tppo.train(tnv.ENV, tp, cfg, torch.Generator().manual_seed(0),
                            32 * tp.step_limit, device=CPU)
    assert len(seen) == 1 and seen[0]["raw"].shape == (120, 1, 32)
    assert all(np.isfinite(v).all() for v in metrics.values())
    tr = seen[0]
    _replay(jp, tr, (torch.tanh(tr["raw"][:, 0]) + 1.0) * tek._nv_half_hi(tp)[0])


def test_td3_kernel_iteration_at_lead_time_60(monkeypatch):
    jp, tp = _params("NV-lt60")
    seen = _capture(monkeypatch, "rollout_traj_nv_offpolicy")
    cfg = top.OffPolicyConfig(algo="td3", collect="kernel", num_envs=16,
                              buffer_size=16 * tp.step_limit, batch_size=32, start_steps=0,
                              updates_per_iter=1, pi_arch=(16, 16), q_arch=(16, 16))
    _, _, metrics = top.train(tnv.ENV, tp, cfg, torch.Generator().manual_seed(1),
                              16 * tp.step_limit, log_every=1, device=CPU)
    assert len(seen) == 1 and seen[0]["raw"].shape == (120, 1, 16)
    assert np.isfinite(metrics["mean_step_reward"]).all()
    tr = seen[0]
    _replay(jp, tr, (tr["raw"][:, 0] + 1.0) * tek._nv_half_hi(tp)[0])


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the column instances have no CPU mode")
    return torch.device("cuda")


def _share(got, want, rtol=1e-4, atol=1e-2):
    err = (got.double().cpu() - want.double().cpu()).abs()
    ok = (err <= atol + rtol * want.double().cpu().abs()).reshape(-1, got.shape[-1]).all(0)
    return float(ok.double().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_k13_to_k17_columns_on_cuda(name, cuda):
    """K17's econ and actions equal plain K17's; K15 = K17's episode 0; on
    K17's streams K16 = K14 = K13 _random = K13 bit for bit; K13 and K16
    against plain on >= 99.99% of lanes."""
    _, tp = _params(name)
    econ, acts, dems = tek.sample_streams_debug_nv_reset(tp, 3, 1000, 2, cuda)
    pe, pa, _ = tek._nv_fused_plain(tp, 3, 1000, 2, cuda, dump=True)
    assert torch.equal(econ, pe) and torch.equal(acts, pa)
    k16 = tek.episode_returns_nv_reset_fused(tp, 3, 1000, 2, cuda)
    assert _share(k16, tek._nv_fused_plain(tp, 3, 1000, 2, cuda), 1e-5) >= 0.9999
    e0, a0, d0 = econ[0].contiguous(), acts[:, 0].contiguous(), dems[:, 0].contiguous()
    a15, d15 = tek.sample_streams_debug_nv(tp, e0, 3)
    assert torch.equal(a15, a0) and torch.equal(d15, d0)
    for got in (tek.episode_returns_nv_fused(tp, e0, 3),
                tek.episode_returns_nv_random(tp, e0, d0, 3),
                tek.episode_returns_nv(tp, e0, a0, d0)):
        assert torch.equal(got, k16[0])
    wild = a0 * 1.5 - 10.0
    torch.testing.assert_close(tek.episode_returns_nv(tp, e0, wild, d0),
                               tek._episode_returns_nv_plain(tp, e0, wild, d0),
                               rtol=1e-5, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_policy_kernels_and_k28_on_cuda(name, cuda):
    """K18-K20 against plain on >= 99% of lanes (econ and demand bit for
    bit); K28 det, sac and uniform on the cluster and det on the wide route:
    econ and demand K18's, the plain step chain replaying its orders and
    rewards bit for bit."""
    _, tp = _params(name)
    actor = tuple(tuple(x.to(cuda) for x in part) for part in _mlp_actor(tp, (64, 64)))
    std = torch.full((1,), -0.7, device=cuda)
    tr = tek.rollout_traj_nv(tp, actor, std, 3, 1024, device=cuda)
    want = tek._rollout_traj_nv_plain(tp, actor, tek.clipped_std(std), 3, 1024, cuda)
    assert torch.equal(tr["econ"], want["econ"]) and torch.equal(tr["demand"], want["demand"])
    assert min(_share(tr[k], want[k]) for k in ("orders", "raw", "reward")) >= 0.99
    ret, econ, acts, dems = tek.sample_policy_streams_debug_nv(tp, actor, 3, 1024, 2, std, cuda)
    wret, wecon, _, wdems = tek._nv_policy_plain(tp, actor, tek.clipped_std(std), 3, 1024, 2,
                                                 cuda, True)
    assert torch.equal(econ, wecon) and torch.equal(dems, wdems) and _share(ret, wret) >= 0.99
    half_hi = tek._nv_half_hi(tp)[0]
    for mode, out, arch, route in (("det", 1, (256, 256), "cluster"),
                                   ("sac", 2, (256, 256), "cluster"),
                                   ("uniform", 1, (256, 256), "cluster"),
                                   ("det", 1, (512, 512), "wide")):
        off = tuple(tuple(x.to(cuda) for x in part)
                    for part in _actor([tp.obs_dim, *arch, out], 0.05, 9))
        k28 = tek.rollout_traj_nv_offpolicy(tp, off, torch.full((1,), -1.0, device=cuda), 3,
                                            1024, mode, "relu", cuda)
        assert tek.rollout_traj_nv_offpolicy.route == route
        assert torch.equal(k28["econ"], tr["econ"]) and torch.equal(k28["demand"], tr["demand"])
        P = [torch.zeros(1024, device=cuda)] * tp.lead_time
        for t in range(tp.step_limit):
            P, rew, q = tek._nv_step_math(tp, P, *k28["econ"][:4],
                                          (k28["raw"][t, 0] + 1.0) * half_hi, k28["demand"][t])
            assert torch.equal(q, k28["orders"][t]) and torch.equal(rew, k28["reward"][t])
