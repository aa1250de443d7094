"""The LSTM kernels K22-K24 at any encoder depth, encoder width and hidden
width (the general actor class, csrc/lstm.cuh ``LstmG`` and
csrc/im_lstm_any.cu), and the seeded evaluators' wide demand laws
(``ops.distributions.seeded_law_draws``), against the JAX package and SciPy.

The kernels cannot run here, so what surrounds them is held on the CPU:

- the plain K22/K23/K24 at three actors past the fixed class's maxima (hidden
  256 without an encoder; six tanh encoder layers of 64 with hidden 90; an
  encoder (256, 256) with hidden 512), 256 lanes x 12 periods, with
  tests/test_torch_im_lstm.py's gates: K22 against JAX's stream-in K7
  ``episode_returns_im`` in interpret mode on K23's streams (``rtol=1e-5,
  atol=1e-3``), K23's actions against the flax chain on K23's demand (at least
  99.9% of elements), K24 replayed through ``_replay_chain`` (inv exact,
  rewards ``rtol=1e-5, atol=1e-2``) and its raws the flax mean on the replayed
  obs plus std times the Philox normals (atol 1e-4);
- ``fold_lstm_actor`` at those widths against JAX's fold (atol 1e-6);
- the pack and the plan: ``_pack_lstm_actor`` takes each actor; the
  ``_LstmG`` mirror has every field of the C struct; the regions go to shared
  memory or the workspace as their bytes say (a hand count); the fixed class
  is chosen exactly within the old maxima; the ValueError fires only past a
  launch's workspace; any hidden width of at least 1 packs; the packed table
  and half ranges read back;
- the seeded evaluators on a law past the table cap: each law of
  ``sample_from_law`` through both families' ``seeded_draws`` on 4,096 seeds,
  a chi-square test on equiprobable bins of the law against ``scipy.stats``
  at p >= 0.001; lane rows that do not depend on the batch; the table laws'
  draws bit for bit those of stream 0's word j.

The cuda-marked cases hold the kernels against their plain versions on the
card: the three actors on a ragged batch, and the general class against the
fixed one bit for bit in shared memory and on the workspace (chip_smoke.py
phase 57 holds the chain route).
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from test_kernel_rollout import _replay_chain
from test_torch_im_lstm import LOG_STD, _flax_chain_actions, _jax_actor, _jax_k7, _params, \
    _port_actor
from test_torch_net_k2_plan import _c_struct_fields, _ctypes_fields

from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import distributions as tdist
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.vector import evaluate_episodes_seeded
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
STEPS, B = 12, 256
# the actors past the fixed class: (hidden, encoder)
WIDTHS = {"lstm256": (256, ()), "deep90": (90, (64,) * 6), "wide512": (512, (256, 256))}


# ------------------------------------------------- the plain K22-K24 against JAX

@pytest.fixture(scope="module", params=list(WIDTHS))
def width_case(request):
    hidden, encoder = WIDTHS[request.param]
    jp, tp = _params()
    _, model, mp, rms = _jax_actor(jp, hidden, encoder)
    _, _, actor = _port_actor(jp, hidden, encoder)
    if not encoder:   # the fold keeps no normalisation without an encoder, as JAX's
        rms = jppo.RunningMeanStd.create(33)
    return request.param, jp, tp, model, mp, rms, actor


def test_plain_k22_k23_at_any_width_against_jax(width_case):
    name, jp, tp, model, mp, rms, actor = width_case
    st, _ = tek._pack_lstm_actor(actor, None, 33, 3, tek._half_c(tp), CPU)
    assert isinstance(st, tek._LstmG), name
    ret, acts, dems = tek.sample_lstm_streams_debug_im(tp, actor, 71, B, device=CPU)
    k22 = tek.episode_returns_im_lstm(tp, actor, 71, B, device=CPU)
    assert torch.equal(ret, k22)
    np.testing.assert_allclose(k22.numpy(), _jax_k7(jp, acts, dems), rtol=1e-5, atol=1e-3)
    want = _flax_chain_actions(jp, model, mp, rms, dems.numpy())
    agree = want == acts.numpy()
    assert agree.mean() >= 0.999, (name, agree.mean())
    assert len(np.unique(acts)) > 10


def test_plain_k24_at_any_width_replays_through_the_jax_chain(width_case):
    name, jp, tp, model, mp, rms, actor = width_case
    tr = tek.rollout_traj_im_lstm(tp, actor, LOG_STD, 71, B, device=CPU)
    _, _, dems = tek.sample_lstm_streams_debug_im(tp, actor, 71, B, device=CPU)
    assert torch.equal(tr["demand"], dems)
    obs_all, rew, final_inv = _replay_chain(jp, tr["actions"].numpy(), tr["demand"].numpy())
    obs_all = np.asarray(obs_all)
    np.testing.assert_array_equal(tr["inv"][:STEPS].numpy(),
                                  obs_all[:STEPS, :, :tp.m1].transpose(0, 2, 1))
    np.testing.assert_array_equal(tr["inv"][STEPS].numpy(), np.asarray(final_inv))
    np.testing.assert_allclose(tr["reward"].numpy(), np.asarray(rew), rtol=1e-5, atol=1e-2)
    _, (mean, _, _) = jax.lax.scan(
        lambda c, o: model.apply(mp, c, rms.normalize(o)), model.initial_carry(B),
        jnp.asarray(obs_all[:STEPS]))
    lanes = torch.arange(B, dtype=torch.int64)
    std = tek.clipped_std(LOG_STD)
    for t in range(STEPS):
        w = rng.period_words(71, lanes, 0, t, 1 + 2 * tp.m1, key1=rng.POLICY_KEY)
        z = rng.normal01(torch.stack(w[1:4]), torch.stack(w[4:]))
        np.testing.assert_allclose(tr["raw"][t].numpy(),
                                   np.asarray(mean[t]).T + (std * z).numpy(), atol=1e-4,
                                   err_msg=f"{name} raw[{t}]")


@pytest.mark.parametrize("name", list(WIDTHS))
def test_fold_at_any_width_matches_jax(name):
    hidden, encoder = WIDTHS[name]
    jp, _ = _params()
    cfg, _, mp, rms = _jax_actor(jp, hidden, encoder)
    _, _, got = _port_actor(jp, hidden, encoder)
    want = jek.fold_lstm_actor(cfg, mp, rms)
    assert len(got["enc"]) == len(want["enc"]) == len(encoder)
    for (W, b), (jW, jb) in zip(got["enc"], want["enc"]):
        np.testing.assert_allclose(W.numpy(), np.asarray(jW), atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-6)
    for k in ("wx", "wh", "bh", "wm", "bm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)


# ------------------------------------------------------------- pack and plan

def _actor(dims, h, act, seed=0):
    g = torch.Generator().manual_seed(seed)
    enc = [(torch.randn(o, i, generator=g) / i ** 0.5, torch.randn(o, 1, generator=g))
           for i, o in zip(dims, dims[1:])]
    return dict(enc=enc, wx=torch.randn(4 * h, dims[-1], generator=g),
                wh=torch.randn(4 * h, h, generator=g), bh=torch.randn(4 * h, 1, generator=g),
                wm=torch.randn(act, h, generator=g), bm=torch.randn(act, 1, generator=g))


def _pack(dims, h, act, records=0):
    return tek._pack_lstm_actor(_actor(dims, h, act), None, dims[0], act,
                                [0.5 * (i + 1) for i in range(act)], CPU, records)


def test_lstm_g_mirror_has_the_c_fields():
    fields = _c_struct_fields("lstm.cuh", "LstmG")
    assert _ctypes_fields(tek._LstmG) == fields
    assert ctypes.sizeof(tek._LstmG) == 8 + 4 * (len(fields) - 1) + 4   # padded to 8


# the configurations by hand: rows e, h0, h1, c, x0, x1, m, z and where the
# regions lie; bytes = 4 * stride * rows (stride lanes + 8, or lanes on the
# workspace). ``records`` are the chain route's words after the regions.
PLANS = {
    # LSTM-256: 40 + 3 x 256 + 3 + 8 = 819 rows; 64 lanes 235,872 B > 232,448, so 32
    # lanes (131,040 B); without C (the fixed class's layout) 162,144 B at 64
    "LSTM-256": ([33], 256, 3, 0, (32, 8), False, (40, 256, 256, 256, 0, 0, 3, 8)),
    # LSTM-deep90: 64 + 3 x 96 + 64 + 64 + 11 = 491 rows x 72 = 141,408 B
    "LSTM-deep90": ([33] + [64] * 6, 90, 3, 0, (64, 4), False,
                    (64, 96, 96, 96, 64, 64, 3, 8)),
    # LSTM-wide: 256 + 3 x 512 + 256 + 256 + 11 = 2,315 rows; 370,400 B at 32
    # lanes, so the workspace at 64 lanes: 148,160 floats a block's slice
    "LSTM-wide": ([33, 256, 256], 512, 3, 0, (64, 4), True,
                  (256, 512, 512, 512, 256, 256, 3, 8)),
    # IM-chain12-lt40 x LSTM: obs 492 -> 496 rows of x0; 1,366 rows x 40 =
    # 218,560 B + 392 B of records at 32 lanes (64 lanes: 393,536 B)
    "chain12": ([492, 64], 256, 12, 98, (32, 8), False, (64, 256, 256, 256, 496, 0, 12, 26)),
}
ROWS = ("e", "h0", "h1", "c", "x0", "x1", "m", "z")


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_picks_shared_memory_or_the_workspace_by_the_bytes(name):
    dims, h, act, rec, tile, ws, rows = PLANS[name]
    st, flat = _pack(dims, h, act, rec)
    assert isinstance(st, tek._LstmG)
    assert (st.lanes, st.warps_m, st.threads) == (*tile, tile[0] * tile[1])
    stride = tile[0] if ws else tile[0] + 8
    assert st.stride == stride and (st.e_pad, st.h_pad) == rows[:2]
    offsets, at = {}, 0
    for n, r in zip(ROWS, rows):
        offsets[n] = at
        at += r * stride
    if len(dims) == 1:
        offsets["x0"] = offsets["e"]
    assert {n: getattr(st, f"s_{n}") for n in ROWS} == offsets
    at4 = -(-at // 4) * 4 if ws else at
    assert st.s_total == at4
    assert (st.smem_floats, st.ws_floats) == ((0, at4) if ws else (at, 0))
    if not ws:
        assert 4 * (at + rec) <= tek.SMEM_OPTIN_BYTES
        if tile[0] == 32:   # 64 lanes did not fit
            assert 4 * (tek._lstm_plan(dims, h, act, (64, 4), True).floats + rec) \
                > tek.SMEM_OPTIN_BYTES
    else:
        assert 4 * (tek._lstm_plan(dims, h, act, (32, 8), True).floats + rec) \
            > tek.SMEM_OPTIN_BYTES
    # the table {in, out, w, b} a layer, 16-byte aligned, and half_hi, read back
    assert st.table % 4 == 0 and st.n_enc == len(dims) - 1
    table = flat[st.table:st.table + 4 * st.n_enc].view(torch.int32).reshape(-1, 4)
    for layer, (i, o, w, b) in enumerate(table.tolist()):
        assert (i, o) == (dims[layer], dims[layer + 1]) and w % 4 == 0
        assert b == w + -(-o // 16) * 16 * -(-i // 8) * 8
    assert flat[st.half_hi:st.half_hi + act].tolist() == [0.5 * (i + 1) for i in range(act)]
    assert flat.numel() == st.half_hi + act


# the fixed class exactly within the old maxima: (widths, hidden, actions,
# records) -> fixed?
CLASSES = {
    "benchmark": ([33, 64], 128, 3, 0, True),
    "four_layers": ([33] + [64] * 4, 128, 3, 0, True),
    "five_layers": ([33] + [64] * 5, 128, 3, 0, False),
    "hidden_132": ([33, 64], 132, 3, 0, False),
    "hidden_18": ([33, 64], 18, 3, 0, False),
    "hidden_4": ([33, 64], 4, 3, 0, True),
    "nine_actions": ([33, 64], 64, 9, 0, False),
    "nine_actions_chain": ([33, 64], 64, 9, 82, True),
    "no_block": ([33, 600, 600], 128, 3, 0, False),   # within the arrays, fits no block
}


@pytest.mark.parametrize("name", list(CLASSES))
def test_the_fixed_class_is_chosen_exactly_within_the_old_maxima(name):
    dims, h, act, rec, fixed = CLASSES[name]
    n_enc = len(dims) - 1
    within = n_enc <= 4 and h % 4 == 0 and h <= 128 and (act <= 8 or rec > 0)
    st, _ = _pack(dims, h, act, rec)
    assert isinstance(st, tek._Lstm if fixed else tek._LstmG)
    assert tek._lstm_fixed(n_enc, h, act, rec) == within
    assert fixed == (within and 4 * (min(tek._lstm_plan(dims, h, act, t).floats
                                         for t in tek._LSTM_TILES) + rec) <= tek.SMEM_OPTIN_BYTES)


def test_the_value_error_fires_only_past_the_workspace(monkeypatch):
    st, _ = _pack([33, 256, 256], 512, 3)
    slice_bytes = 4 * st.ws_floats
    monkeypatch.setattr(tek, "WORKSPACE_MAX_BYTES", slice_bytes)
    _pack([33, 256, 256], 512, 3)   # a slice that fills the workspace still packs
    monkeypatch.setattr(tek, "WORKSPACE_MAX_BYTES", slice_bytes - 4)
    with pytest.raises(ValueError, match=f"{slice_bytes} bytes"):
        _pack([33, 256, 256], 512, 3)


def test_any_hidden_width_of_at_least_one_packs_zero_padded():
    for h in (1, 3, 7, 9, 130):
        st, flat = _pack([33, 16], h, 3)
        assert isinstance(st, tek._Lstm if h % 4 == 0 and h <= 128 else tek._LstmG)
        assert st.h_pad == -(-h // 8) * 8
        bias = flat[st.b_gate:st.b_gate + 4 * st.h_pad].reshape(st.h_pad, 4)
        assert not bias[h:].any()


def test_the_general_class_entry_points_are_bound():
    from or_gym_inventory_torch.ops import _build
    names = set(_build.SIGNATURES["im_lstm_any"])
    assert names == {f"im_lstm_{k}{s}" for k in ("returns", "rollout_traj")
                     for s in ("_any", "_chain_any")}
    assert tek._lstm_lib("_chain_any") == "im_lstm_any" and tek._lstm_lib("_chain") == "im_lstm"
    text = (_build.CSRC / "im_lstm_any.cu").read_text()
    assert "#define LSTM_ANY_TILES(X) " + " ".join(f"X({a}, {b})" for a, b in tek._LSTM_TILES) \
        in text


# ---------------------------------------------- the seeded evaluators' wide laws

SEEDS = 4096
PERIODS = 3
# law past the 4,096-entry table -> its scipy.stats twin
WIDE_LAWS = {
    "poisson": (("poisson", 50_000.0), stats.poisson(50_000.0)),
    "binomial": (("binomial", 100_000, 0.3), stats.binom(100_000, 0.3)),
    "negbinomial": (("negbinomial", 5.0, 0.001), stats.nbinom(5.0, 0.001)),
    "randint": (("randint", 0, 100_000), stats.randint(0, 100_000)),
    "geometric": (("geometric", 1e-4), stats.geom(1e-4)),
    "normal": (("normal", 50_000.0, 5_000.0), None),
}
# InvManagement's dist modes for the laws it has
IM_LAWS = {"poisson": (1, {"mu": 50_000}), "binomial": (2, {"n": 100_000, "p": 0.3}),
           "randint": (3, {"low": 0, "high": 99_999}), "geometric": (4, {"p": 1e-4})}


def _chi2_pvalue(x, law, bins=40):
    """The chi-square p-value of the integer draws ``x`` against ``law`` on
    ``bins`` near-equiprobable bins cut at its quantiles; ``law`` None is
    max(0, round(N(50,000, 5,000))), through the normal's CDF at the
    half-integers."""
    x = np.asarray(x, np.float64)
    cdf = (lambda k: stats.norm(50_000.0, 5_000.0).cdf(k + 0.5)) if law is None else law.cdf
    q = np.linspace(0, 1, bins + 1)[1:-1]
    edges = np.unique(np.floor(stats.norm(50_000.0, 5_000.0).ppf(q)) if law is None
                      else law.ppf(q))
    probs = np.diff(np.concatenate([[0.0], cdf(edges), [1.0]]))
    counts = np.bincount(np.searchsorted(edges, x, side="left"), minlength=probs.size)
    assert counts.sum() == x.size and (probs > 0).all()
    return stats.chisquare(counts, probs * x.size).pvalue


def _net_params(spec):
    p = tnet.default_params(topology=ttopo.two_retail_topology(PERIODS), num_periods=PERIODS)
    topo = dataclasses.replace(p.topology, rt_demand=(tuple(spec),) + p.topology.rt_demand[1:])
    return dataclasses.replace(p, topology=topo)


@pytest.mark.parametrize("name", list(WIDE_LAWS))
def test_net_seeded_draws_of_a_wide_law_against_scipy(name):
    spec, law = WIDE_LAWS[name]
    with pytest.raises(NotImplementedError):
        tdist.cdf_table_for_spec(spec)   # past the table cap
    params = _net_params(spec)
    seeds = torch.arange(SEEDS) * 3 + 11
    _, demands = tnet.ENV.seeded_draws(params, seeds)
    x = torch.stack([d[:, 0] for d in demands]).double()
    assert bool((x == x.round()).all())
    assert _chi2_pvalue(x.reshape(-1).numpy(), law) >= 0.001, name
    # the table link beside it keeps its stream-0 word, bit for bit
    _, table = tnet.ENV.seeded_draws(
        tnet.default_params(topology=ttopo.two_retail_topology(PERIODS), num_periods=PERIODS),
        seeds)
    for d, dt in zip(demands, table):
        assert torch.equal(d[:, 1:], dt[:, 1:])


@pytest.mark.parametrize("name", list(IM_LAWS))
def test_im_seeded_draws_of_a_wide_law_against_scipy(name):
    mode, dp = IM_LAWS[name]
    params = tim.default_params(periods=PERIODS, dist=mode, dist_param=dp)
    assert tim._demand_plan(params, CPU)[0] == "law"
    seeds = torch.arange(SEEDS) * 5 + 2
    _, demands = tim.ENV.seeded_draws(params, seeds)
    x = torch.stack(demands)
    assert x.dtype == torch.int32
    assert _chi2_pvalue(x.reshape(-1).numpy(), WIDE_LAWS[name][1]) >= 0.001, name


@pytest.mark.parametrize("family", ["inv_management", "net_inv_management"])
def test_wide_law_rows_do_not_depend_on_the_batch(family):
    if family == "inv_management":
        env, params = tim.ENV, tim.default_params(periods=PERIODS, dist_param={"mu": 50_000})
    else:
        env, params = tnet.ENV, _net_params(("randint", 0, 100_000))
    space = env.action_space(params)

    def policy(_s, obs, _g, _t):
        return torch.full((obs.shape[0],) + space.shape, 5, dtype=torch.int32
                          if family == "inv_management" else torch.float32)

    seeds = torch.arange(64) * 7 + 1
    key = "demand_realized" if family == "inv_management" else "demand"
    full_tot, full = evaluate_episodes_seeded(env, params, policy, None, seeds, device=CPU)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(3))
    for idx in (perm, torch.arange(10, 20), torch.tensor([5])):
        tot, part = evaluate_episodes_seeded(env, params, policy, None, seeds[idx], device=CPU)
        assert torch.equal(tot, full_tot[idx])
        assert torch.equal(part.info[key], full.info[key][:, idx])
    assert full.info[key].double().std() > 0


def test_table_laws_keep_their_draws_bit_for_bit():
    """A law within the table cap: stream 0's word, as before wide laws were
    drawn: ``demand_from_uniform(s)`` on that word's 24-bit uniform."""
    seeds = torch.arange(512) * 13 + 5
    params = tim.default_params(periods=PERIODS)
    _, demands = tim.ENV.seeded_draws(params, seeds)
    for t, d in enumerate(demands):
        u = rng.uniform01(rng.seeded_words(seeds, t, 1)[0])
        assert torch.equal(d, tim.demand_from_uniform(params, u, t))
    params = tnet.default_params(topology=ttopo.two_retail_topology(PERIODS),
                                 num_periods=PERIODS)
    _, demands = tnet.ENV.seeded_draws(params, seeds)
    for t, d in enumerate(demands):
        u = torch.stack([rng.uniform01(w) for w in rng.seeded_words(seeds, t, 2)], dim=1)
        assert torch.equal(d, tnet.demand_from_uniforms(params, u, t))


def test_wide_draws_take_stream_one_plus_the_link():
    """Lane i's wide draw of period t is the 53-bit uniform of words 0 and 1
    of counter (0, 1 + j, t, 0) under (seeds[i], SEEDED_KEY), through the
    law's quantile; the table's tails hold less than WIDE_TAIL of the mode's
    pmf and its thresholds are the law's CDF."""
    seeds = torch.tensor([0, 1, 2 ** 32 - 1])
    for j in (0, 3):
        w0, w1 = rng.philox4x32_10(0, 1 + j, 4, 0, seeds, rng.SEEDED_KEY)[:2]
        u = ((w0 << 21) | (w1 >> 11)).double() * 2.0 ** -53
        got = tdist.seeded_law_draws(("randint", 10, 1_000_010), seeds, 1 + j, 4)
        assert torch.equal(got, 10 + torch.floor(u * 1_000_000))
    base, table = tdist._wide_table(("poisson", 50_000.0))
    ks = base + np.arange(table.size)
    np.testing.assert_allclose(table, stats.poisson(50_000.0).cdf(ks), atol=1e-12)
    law = stats.poisson(50_000.0)
    assert law.cdf(base - 1) < tdist.WIDE_TAIL * law.pmf(50_000)
    assert law.sf(base + table.size) < tdist.WIDE_TAIL * law.pmf(50_000)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDTHS))
def test_general_class_matches_plain_on_cuda(name, cuda):
    hidden, encoder = WIDTHS[name]
    jp, tp = _params(periods=30)
    _, _, actor = _port_actor(jp, hidden, encoder)
    actor = tek._lstm_on(actor, cuda)
    b = 1000   # not a multiple of the block's lanes: the tail is masked
    ret, acts, dems = tek.sample_lstm_streams_debug_im(tp, actor, 9, b, device=cuda)
    want, want_a, want_d = tek._im_lstm_plain(tp, actor, 9, b, cuda, True)
    assert torch.equal(dems, want_d)
    ok = (ret.double() - want.double()).abs() <= 1e-2 + 1e-4 * want.double().abs()
    assert float(ok.double().mean()) >= 0.99
    assert float((acts == want_a).all(1).all(0).double().mean()) >= 0.99
    assert torch.equal(tek.episode_returns_im_lstm(tp, actor, 9, b, device=cuda), ret)
    tr = tek.rollout_traj_im_lstm(tp, actor, LOG_STD.to(cuda), 9, b, device=cuda)
    ptr = tek._rollout_traj_im_lstm_plain(tp, actor, tek.clipped_std(LOG_STD), 9, b, cuda)
    assert torch.equal(tr["demand"], dems)
    assert float((tr["inv"] == ptr["inv"]).all(1).all(0).double().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("home", ["shared", "workspace"])
def test_general_class_equals_the_fixed_one_on_cuda(home, cuda, monkeypatch):
    jp, tp = _params(periods=30)
    _, _, actor = _port_actor(jp, 32, (16,))
    actor = tek._lstm_on(actor, cuda)
    fixed = tek.sample_lstm_streams_debug_im(tp, actor, 9, 3000, device=cuda)
    ftr = tek.rollout_traj_im_lstm(tp, actor, LOG_STD.to(cuda), 9, 3000, device=cuda)
    monkeypatch.setattr(tek, "_lstm_fixed", lambda *_a: False)
    if home == "workspace":
        monkeypatch.setattr(tek, "SMEM_OPTIN_BYTES", 0)
    got = tek.sample_lstm_streams_debug_im(tp, actor, 9, 3000, device=cuda)
    gtr = tek.rollout_traj_im_lstm(tp, actor, LOG_STD.to(cuda), 9, 3000, device=cuda)
    for x, y in zip(got, fixed):
        assert torch.equal(x, y)
    for k in ftr:
        assert torch.equal(gtr[k], ftr[k]), k
