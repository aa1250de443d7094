"""The float64 plain oracle of the port (ops/episode_kernels.py
``kernel_layers``, ``mlp_forward``, ``traj_policy`` and ``lstm_forward``
with ``dtype=torch.float64``; ops/net_step.py ``_batched_step_plain`` and
``_step_math``), held against the JAX package on the CPU:

- the float64 trunk and the ppo, det and sac heads on C6's two raw actors
  (chip_smoke.py ``c6_actors``: PPO's initial actor and the all-normal
  Gaussian one, over raw observations) against JAX's ``mlp_forward`` at
  ``Precision.HIGHEST`` (pallas_episode_kernels.py:1124) and its heads'
  formulas (:1036-1081) on the same noise: every element of JAX's float32
  result within the float32 forward bound that the float64 twin computes,
  and so is the port's own float32 plain version;
- the float32 default unchanged bit for bit: ``mlp_forward``,
  ``traj_policy``, ``lstm_forward`` and ``_batched_step_plain`` against
  their dtype-less forms as they were written before the oracle;
- the float64 step on ``default_regions(8)`` and ``custom_regions(6)``
  against the JAX package's plain step (pallas_net_step._step_math) over
  a chained horizon, every output within its bound;
- the float64 LSTM's bound, carried over an episode, holds the float32
  plain LSTM.

The ``cuda``-marked cases run phase 58's gates of chip_smoke.py on the card
(C6: K4, K10, K18 under both raw actors and K24 under LSTM-256 against the
float64 head, within the bound and within 2x the float32 plain head's
error; C8: K25 and K29 on both graphs within the bound); they skip here.
Inputs are made from seeds with numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import topology as jtopo
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek
from or_gym_inventory_tpu.ops import pallas_net_step as pns

CPU = torch.device("cpu")
B = 256
# each family's obs width, actions, and the scale of its raw obs (on-hand
# and orders in the hundreds, Newsvendor's prices and mean demand ~200)
FAMILIES = {"net": (68, 11, 400), "im": (33, 3, 200), "nv": (10, 1, 300)}
KINDS = ("ppo_init", "gaussian")


def _obs(family, seed=0):
    """(obs_dim, B) float32 raw observations: integers in [0, scale]."""
    obs_dim, _, scale = FAMILIES[family]
    r = np.random.default_rng(seed)
    return r.integers(0, scale + 1, size=(obs_dim, B)).astype(np.float32)


def _actor(family, kind, outputs=None):
    obs_dim, act, _ = FAMILIES[family]
    actor, log_std = chip_smoke.c6_actors(obs_dim, act)[kind]
    if outputs is not None:   # the sac head's 2 act outputs: a last layer drawn anew
        g = torch.Generator().manual_seed(5)
        Ws, bs = actor
        Ws = Ws[:-1] + (torch.randn(Ws[-1].shape[0], outputs, generator=g) * Ws[-1].std(),)
        bs = bs[:-1] + (torch.randn(outputs, generator=g) * 0.1,)
        actor = (Ws, bs)
    return actor, log_std


def _jax_trunk(actor, act_name, X):
    """JAX's mlp_forward at Precision.HIGHEST on obs rows X (obs, B)."""
    Ws, bs = actor
    return jek.mlp_forward([jnp.asarray(W.numpy().T) for W in Ws],
                           [jnp.asarray(b.numpy().reshape(-1, 1)) for b in bs], act_name,
                           jax.lax.Precision.HIGHEST, list(jnp.asarray(X)))


def _within(got, want64, bound):
    got = torch.as_tensor(np.array(got)).double()
    err = (got - want64).abs()
    assert torch.isfinite(bound).all() and bool((err <= bound).all()), \
        f"{int((err > bound).sum())} elements outside the bound; max |diff| {float(err.max())}"
    return float((err / bound.clamp_min(1e-300)).max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_float64_trunk_holds_jax_highest_within_its_bound(family, kind):
    actor, _ = _actor(family, kind)
    X = _obs(family)
    H64, bound = tek.mlp_forward(tek.kernel_layers(actor, CPU, torch.float64), "tanh",
                                 list(torch.from_numpy(X)), torch.float64)
    assert H64.dtype == bound.dtype == torch.float64
    used = _within(_jax_trunk(actor, "tanh", X), H64, bound)
    _within(tek.mlp_forward(tek.kernel_layers(actor, CPU), "tanh", list(torch.from_numpy(X))),
            H64, bound)
    # a float32 bound, not a vacuous one: its median well below the outputs' size
    assert float(bound.median()) < 1e-3 * max(1.0, float(H64.abs().max())) and used > 0.0


def _noise(mode, act, seed=3):
    """The period's words after one demand word, and their noise in float32
    and float64 (``_head_noise``)."""
    lanes = torch.arange(B, dtype=torch.int64)
    words = rng.period_words(seed, lanes, 0, 2, 1 + tek._head_words(mode, act),
                             key1=rng.POLICY_KEY)[1:]
    return tek._head_noise(mode, words), tek._head_noise(mode, words, torch.float64)


def _jax_head(mode, act, H, std, z):
    """pallas_episode_kernels.traj_policy's heads (:1065-1080) in JAX on the
    trunk H and the noise z (float32)."""
    z = jnp.asarray(z.numpy())
    if mode == "ppo":
        return H + jnp.asarray(std.numpy()) * z
    if mode == "det":
        return jnp.clip(jnp.tanh(H) + jnp.asarray(std.numpy()) * z, -1.0, 1.0)
    mean, ls = H[:act], H[act:]
    return jnp.tanh(mean + jnp.exp(jnp.clip(ls, -10.0, 2.0)) * z)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["ppo", "det", "sac"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_float64_heads_hold_jax_within_their_bound(family, mode, kind):
    obs_dim, act, _ = FAMILIES[family]
    actor, log_std = _actor(family, kind, 2 * act if mode == "sac" else None)
    act_name = "tanh" if mode == "ppo" else "relu"
    std = tek.clipped_std(log_std if mode == "ppo" else torch.full((act,), -2.3))
    X = _obs(family, 1)
    z32, z64 = _noise(mode, act)
    rows = list(torch.from_numpy(X))
    store, a64, bound = tek.traj_policy(mode, act_name, act, tek.kernel_layers(
        actor, CPU, torch.float64), std, rows, z64, torch.float64)
    assert store.shape == bound.shape == (act, B)
    jax_store = _jax_head(mode, act, _jax_trunk(actor, act_name, X), std, z32)
    _within(jax_store, store, bound)
    own, _ = tek.traj_policy(mode, act_name, act, tek.kernel_layers(actor, CPU), std, rows, z32)
    _within(own, store, bound)
    if mode != "ppo":
        assert bool((a64.abs() <= 1.0).all())


def test_uniform_head_is_exact_in_both_dtypes():
    lanes = torch.arange(B, dtype=torch.int64)
    words = rng.period_words(1, lanes, 0, 0, 3, key1=rng.POLICY_KEY)
    z32, z64 = (tek._head_noise("uniform", words, d) for d in (torch.float32, torch.float64))
    a32, _ = tek.traj_policy("uniform", "relu", 3, None, None, None, z32)
    a64, _, bound = tek.traj_policy("uniform", "relu", 3, None, None, None, z64, torch.float64)
    assert torch.equal(a32.double(), a64) and not bound.any()


def test_the_oracle_takes_only_float32_and_float64():
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        tek.kernel_layers(_actor("im", "ppo_init")[0], CPU, torch.float16)
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        tek.mlp_forward([], "tanh", [torch.zeros(2)], torch.bfloat16)


# --------------------------------------- the float32 default, bit for bit

def _mlp_forward_before(layers, act_name, obs_rows):
    """mlp_forward as it was written before the float64 twin."""
    act = {"tanh": torch.tanh, "relu": torch.relu}[act_name]
    H = torch.stack([r.to(torch.float32) for r in obs_rows])
    for i, (W, b) in enumerate(layers):
        H = W @ H + b
        if i < len(layers) - 1:
            H = act(H)
    return H


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_float32_default_is_unchanged_bit_for_bit(family):
    obs_dim, act, _ = FAMILIES[family]
    actor, log_std = _actor(family, "gaussian")
    rows = list(torch.from_numpy(_obs(family, 2)))
    layers = tek.kernel_layers(actor, CPU)
    assert all(_bits_equal(W, W2) and _bits_equal(b, b2) for (W, b), (W2, b2) in zip(
        layers, tek.kernel_layers(actor, CPU, torch.float32)))
    want = _mlp_forward_before(layers, "tanh", rows)
    assert _bits_equal(tek.mlp_forward(layers, "tanh", rows), want)
    assert _bits_equal(tek.mlp_forward(layers, "tanh", rows, torch.float32), want)
    z32, _ = _noise("ppo", act)
    std = tek.clipped_std(log_std)
    raw, a = tek.traj_policy("ppo", "tanh", act, layers, std, rows, z32)
    assert _bits_equal(raw, want + std * z32) and _bits_equal(a, torch.tanh(want + std * z32))


def _lstm_forward_before(actor, obs_rows, H, C):
    X = torch.stack([r.to(torch.float32) for r in obs_rows])
    for W, b in actor["enc"]:
        X = torch.tanh(W @ X + b)
    h = actor["wh"].shape[1]
    G = actor["wx"] @ X + actor["wh"] @ H + actor["bh"]
    i, f, o = (torch.sigmoid(G[k * h:(k + 1) * h]) for k in (0, 1, 3))
    C = f * C + i * torch.tanh(G[2 * h:3 * h])
    H = o * torch.tanh(C)
    return actor["wm"] @ H + actor["bm"], H, C


def _lstm(hidden=24, encoder=(16,)):
    params = tim.default_params()
    actor, _ = chip_smoke.seeded_lstm_actor(params, CPU, encoder=encoder, hidden=hidden)
    return params, actor


def test_lstm_float32_default_is_unchanged_and_its_bound_holds_over_an_episode():
    params, actor = _lstm()
    obs_dim = tim.observation_space(params).shape[0]
    r = np.random.default_rng(4)
    a32, a64 = tek._lstm_on(actor, CPU), tek._lstm_on(actor, CPU, torch.float64)
    H = torch.zeros((24, B))
    C = torch.zeros_like(H)
    H0, C0, H64, C64, e = H, C, H.double(), C.double(), None
    for _ in range(12):
        rows = list(torch.from_numpy(r.integers(0, 300, (obs_dim, B)).astype(np.float32)))
        m, H, C = tek.lstm_forward(a32, rows, H, C)
        m0, H0, C0 = _lstm_forward_before(a32, rows, H0, C0)
        assert _bits_equal(m, m0) and _bits_equal(H, H0) and _bits_equal(C, C0)
        m64, H64, C64, em, e = tek.lstm_forward(a64, rows, H64, C64, torch.float64, e)
        _within(m, m64, em)
        _within(H, H64, e[0])
        _within(C, C64, e[1])


# ------------------------------------------------ the step against JAX's

GRAPHS = {"default_regions_8": (ttopo.DEFAULT_GRAPH, 8), "custom_regions_6": (ttopo.CUSTOM_GRAPH, 6)}
STEPS = 12


def _graph(name):
    base, copies = GRAPHS[name]
    nodes, edges = ttopo.repeated_regions(base, copies)
    jp = jnet.NetInvParams(topology=jtopo.compile_graph(nodes, edges, STEPS),
                           num_periods=STEPS)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), STEPS, jp.backlog,
                                       jp.alpha)
    return jp, tp


@pytest.mark.parametrize("name", list(GRAPHS))
def test_float64_step_holds_the_jax_step_within_its_bound(name):
    jp, tp = _graph(name)
    T = tp.topology
    r = np.random.default_rng(6)
    acts = r.uniform(0.0, 2 * float(T.order_cap_heuristic), (STEPS, T.n_reorder, 64))
    dems = r.poisson(20.0, (STEPS, T.n_retail, 64))
    acts, dems = acts.astype(np.float32), dems.astype(np.float32)
    X, Y, U, RH = tns.init_transposed(tp, 64, CPU)
    lt = max(T.lt_max, 1)
    used = 0.0
    for t in range(STEPS):
        a, d = torch.from_numpy(acts[t]), torch.from_numpy(dems[t])
        out = tns._batched_step_plain(tp, X, Y, U, RH, a, d, t, torch.float64)
        valid = [1.0 if t >= L else 0.0 for L in T.ro_L]
        jX, jY, jU, jr, jprofit = pns._step_math(
            jp.topology, jp.backlog, list(jnp.asarray(X.numpy())), list(jnp.asarray(Y.numpy())),
            list(jnp.asarray(U.numpy())), list(jnp.asarray(RH.numpy())), list(jnp.asarray(acts[t])),
            list(jnp.asarray(dems[t])), valid)
        disc = float(np.float32(tp.alpha ** t))
        jRH = list(jr) + list(jnp.asarray(RH.numpy()))[:(lt - 1) * T.n_reorder]
        for key, got, i in (("X", jX, 0), ("Y", jY, 1), ("U", jU, 2), ("RH", jRH, 3)):
            used = max(used, _within(np.stack([np.asarray(x) for x in got]), out[i],
                                     out[5][key]))
        used = max(used, _within(np.float32(disc) * np.asarray(jprofit), out[4],
                                 out[5]["reward"]))
        X, Y, U, RH = (x.float() for x in out[:4])
    assert 0.0 < used < 1.0


def test_float64_step_float32_default_is_unchanged_bit_for_bit():
    _, tp = _graph("custom_regions_6")
    T = tp.topology
    r = np.random.default_rng(8)
    X, Y, U, RH = tns.init_transposed(tp, 32, CPU)
    for t in range(4):
        a = torch.from_numpy(r.uniform(0, 60, (T.n_reorder, 32)).astype(np.float32))
        d = torch.from_numpy(r.poisson(20.0, (T.n_retail, 32)).astype(np.float32))
        got = tns._batched_step_plain(tp, X, Y, U, RH, a, d, t)
        again = tns._batched_step_plain(tp, X, Y, U, RH, a, d, t, torch.float32)
        valid = [1.0 if t >= L else 0.0 for L in T.ro_L]
        Xn, Yn, Un, r_cur, profit = tns._step_math(T, tp.backlog, list(X), list(Y), list(U),
                                                   list(RH), list(a), list(d), valid)
        lt = max(T.lt_max, 1)
        want = (torch.stack(Xn), torch.stack(Yn), torch.stack(Un),
                torch.stack(r_cur + list(RH)[: (lt - 1) * T.n_reorder]),
                float(np.float32(tp.alpha ** t)) * profit)
        assert len(got) == len(again) == 5
        assert all(_bits_equal(g, w) and _bits_equal(g2, w) for g, g2, w in zip(got, again, want))
        X, Y, U, RH = got[:4]


# ------------------------------------------- phase 58's gates, on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (phase 58's gates run the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_c6_tile_kernels_against_the_float64_head(card):
    assert len(chip_smoke.c6_oracle_checks(card)) == 7


@pytest.mark.cuda
@pytest.mark.parametrize("name, copies", chip_smoke.GRAPH_REGIONS)
def test_c8_k25_and_k29_against_the_float64_oracle(card, name, copies):
    params = chip_smoke.graph_params(name, copies)
    chip_smoke.c8_k25_chain(name, params, card)
    assert set(chip_smoke.c8_k29(name, params, card)) == {"det", "sac"}
