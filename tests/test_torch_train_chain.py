"""The learners over a whole run, against the JAX package: the pieces the
one- and two-update tests (test_torch_ppo_xla.py, test_torch_rppo_xla.py,
test_torch_offpolicy_xla.py) do not reach.

- ``test_nv_ppo_train_matches_jax``: ``ppo.train`` on Newsvendor at
  tools/reward_parity.py's evaluation env, 16 envs x 50 periods x 12
  updates, both packages fed the same NumPy draws (the policy's normals,
  each step's demand, each reset's economics and each epoch's minibatch
  permutation) through ordered ``io_callback``s on the JAX side, as
  test_torch_ppo_xla.py does, from JAX's initial parameters. The run
  crosses 12 episode boundaries and ends where the learning-rate schedule
  reaches 0; the final parameters, ``rms``, ``ret_rms``, the optimizer's
  step count and every update's metrics agree at that test's tolerance
  (rtol 1e-4, atol 1e-5).
- ``test_initial_params_follow_jax_law``: each learner's initial
  parameters, at fixed seeds, follow the law of the JAX package's flax
  initialisers, checked on both packages' draws: orthogonal kernels times
  their gain (sqrt 2 for the trunks, 0.01 for the PPO mean heads, 1 for
  the PPO value head and the LSTM's recurrent kernels, one square block a
  gate), lecun-normal kernels (truncated at two standard deviations,
  variance 1 / fan-in), zero biases and a zero ``log_std``.
- ``test_reward_parity_statistics``: the tool's per-seed means, standard
  errors over seeds and Welch's t on fixed inputs, against SciPy;
  ``test_row_verdict_reads_the_newest_line_of_each_seed``: which log lines
  a row's verdict reads.
"""

import dataclasses
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import off_policy as top
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import vecenv as tvecenv
from or_gym_inventory_tpu.agents import networks as jnetworks
from or_gym_inventory_tpu.agents import off_policy as jop
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.vector import vecenv as jvecenv

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-5)


def _tool():
    spec = importlib.util.spec_from_file_location("reward_parity",
                                                  ROOT / "tools" / "reward_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------ a whole run on one stream

ENVS, STEPS, UPDATES = 16, 50, 12
CHAIN = dict(num_envs=ENVS, rollout_steps=STEPS, num_minibatches=4, update_epochs=2,
             pi_arch=(16, 16), vf_arch=(16, 16))


class _Streams:
    """A run's NumPy draws, handed out in the order a package asks for
    them."""

    def __init__(self, tp, seed=0):
        r = np.random.default_rng(seed)
        S = UPDATES * STEPS
        self.noise = r.standard_normal((S, ENVS, 1)).astype(np.float32)
        self.demand = r.poisson(60.0, (S, ENVS)).astype(np.float32)
        u = torch.from_numpy(r.random((S + 1, 5, ENVS)).astype(np.float32))
        self.econ = np.stack([torch.stack(tnv.econ_from_uniforms(tp, u[i])).T.numpy()
                              for i in range(S + 1)])          # (S + 1, ENVS, 5)
        n = STEPS * ENVS
        self.perm = np.stack([r.permutation(n) for _ in range(UPDATES * CHAIN["update_epochs"])
                              ]).astype(np.int32)
        self.at = {"noise": 0, "demand": 0, "econ": 0, "perm": 0}

    def next(self, what):
        i = self.at[what]
        self.at[what] += 1
        return getattr(self, what)[i]


def _patch(monkeypatch, js, ts):
    def j_draw(what):
        row = getattr(js, what)[0]
        return io_callback(lambda: js.next(what), jax.ShapeDtypeStruct(row.shape, row.dtype),
                           ordered=True)

    def j_sample(_key, mean, log_std):
        return mean + jnp.exp(jnp.clip(log_std, -10.0, 2.0)) * j_draw("noise")

    def j_step(env, params, state, action, _key, _n):
        return jax.vmap(env.step_with_demand, in_axes=(None, 0, 0, 0))(
            params, state, action, j_draw("demand"))

    def j_reset(env, params, _key, _num_envs):
        return jax.vmap(jnv.reset_with_econ, in_axes=(None, 0))(params, j_draw("econ"))

    def j_permutation(_key, n):
        assert n == js.perm.shape[1]
        return j_draw("perm")

    def t_sample(_generator, mean, log_std):
        return mean + torch.exp(torch.clamp(log_std, -10.0, 2.0)) * torch.from_numpy(
            ts.next("noise"))

    def t_step(env, params, state, action, _generator):
        return env.step_with_demand(params, state, action, torch.from_numpy(ts.next("demand")))

    def t_reset(env, params, _generator, _num_envs, device=None):
        return tnv.reset_with_econ(params, torch.from_numpy(ts.next("econ")))

    randperm = torch.randperm

    def t_randperm(n, *args, generator=None, device=None, **kw):
        if n != ts.perm.shape[1]:
            return randperm(n, *args, generator=generator, device=device, **kw)
        return torch.from_numpy(ts.next("perm").astype(np.int64)).to(device)

    for mod, name, fn in ((jnetworks, "gaussian_sample", j_sample),
                          (jvecenv, "batch_step", j_step), (jvecenv, "batch_reset", j_reset),
                          (jax.random, "permutation", j_permutation),
                          (tnetworks, "gaussian_sample", t_sample),
                          (tvecenv, "batch_step", t_step), (tvecenv, "batch_reset", t_reset),
                          (torch, "randperm", t_randperm)):
        monkeypatch.setattr(mod, name, fn)


def test_nv_ppo_train_matches_jax(monkeypatch):
    tool = _tool()
    jp = jnv.default_params(env_config=tool.NV_ENV_CONFIG)
    tp = tnv.NewsvendorParams(**dataclasses.asdict(jp))
    jcfg, tcfg = jppo.PPOConfig(**CHAIN), tppo.PPOConfig(**CHAIN)
    assert tcfg.resolved_shuffle(ENVS) and tcfg.rollout == "xla"
    budget = UPDATES * ENVS * STEPS
    key = jax.random.PRNGKey(0)
    # JAX's initial parameters, drawn before any stream is patched in
    j_init = jax.jit(lambda k: jppo.init_train_state(jnv.ENV, jp, jcfg, k, UPDATES).params)(key)
    j_init = jax.tree_util.tree_map(np.asarray, j_init)
    make_model = tppo._make_model

    def from_jax_init(*args, **kw):
        model = make_model(*args, **kw)
        model.load_state_dict(interop.ppo_params_from_numpy(j_init, device=CPU))
        return model

    js, ts = _Streams(tp), _Streams(tp)
    _patch(monkeypatch, js, ts)
    monkeypatch.setattr(tppo, "_make_model", from_jax_init)
    jstate, jmetrics = jppo.train(jnv.ENV, jp, jcfg, key, budget)
    tstate, tmetrics = tppo.train(tnv.ENV, tp, tcfg, torch.Generator().manual_seed(0), budget,
                                  device=CPU)
    assert js.at == ts.at == {"noise": UPDATES * STEPS, "demand": UPDATES * STEPS,
                              "econ": UPDATES * STEPS + 1,
                              "perm": UPDATES * CHAIN["update_epochs"]}
    # the schedule ran to its end: lr * (1 - k / N) reached 0 at step N
    n_steps = UPDATES * CHAIN["update_epochs"] * CHAIN["num_minibatches"]
    assert tstate.opt_state.count == n_steps == int(jstate.opt_state[1][0].count)
    assert tppo.Optimizer(tcfg, UPDATES)._lr(n_steps) == 0.0
    want = interop.ppo_params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.params),
                                         device=CPU)
    got = tstate.params.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **TOL)
    for name in ("rms", "ret_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(getattr(tstate, name), f).numpy(),
                                       np.asarray(getattr(getattr(jstate, name), f)),
                                       err_msg=f"{name}.{f}", **TOL)
    assert float(tstate.rms.count) == pytest.approx(1e-4 + budget)
    for k in ("mean_step_reward", "episodes", "pg_loss", "v_loss", "entropy", "timesteps"):
        np.testing.assert_allclose(tmetrics[k], jmetrics[k], err_msg=k, **TOL)
    assert tmetrics["episodes"].tolist() == [ENVS] * UPDATES


# ------------------------------------------------------- initial parameters

SQRT2 = math.sqrt(2.0)


def _orthogonal(w, gain, label):
    """``w`` (out, in) has orthonormal rows or columns times ``gain``."""
    w = np.asarray(w, np.float64)
    g = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(g / gain ** 2, np.eye(g.shape[0]), atol=2e-5, err_msg=label)


def _lecun(w, fan_in, label):
    """flax's lecun-normal: a normal truncated at two of its standard
    deviations, rescaled to variance 1 / fan_in."""
    w = np.asarray(w, np.float64).ravel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    assert np.abs(w).max() <= 2.0 * std * (1 + 1e-6), label
    n = w.size
    assert abs(w.mean()) < 5.0 * math.sqrt(1.0 / fan_in / n), label
    assert abs(w.var() * fan_in - 1.0) < 5.0 * math.sqrt(0.8 / n), label


def _check_law(state, laws, label):
    """Every entry of ``state`` (a port state dict) against ``laws``:
    name -> ("orth", gain) | ("lecun", fan_in) | ("zero",) |
    ("orth_blocks", gain, blocks) | ("lecun", fan_in)."""
    assert set(state) == set(laws), (label, sorted(set(state) ^ set(laws)))
    for name, law in laws.items():
        w = state[name].detach().numpy()
        where = f"{label} {name}"
        if law[0] == "zero":
            assert not w.any(), where
        elif law[0] == "orth":
            _orthogonal(w, law[1], where)
        elif law[0] == "orth_blocks":
            for b in np.split(w, law[2], axis=1):
                _orthogonal(b, law[1], where)
        else:
            _lecun(w, law[1], where)


def _dense_laws(prefix, widths, law):
    out = {}
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        out[f"{prefix}.{i}.weight"] = ("orth", SQRT2) if law == "orth" else ("lecun", a)
        out[f"{prefix}.{i}.bias"] = ("zero",)
    return out


def _ppo_case(seed):
    obs_dim, act_dim, arch = 11, 3, (64, 48)
    laws = {**_dense_laws("pi", (obs_dim,) + arch, "orth"),
            **_dense_laws("vf", (obs_dim,) + arch, "orth"),
            "mean.weight": ("orth", 0.01), "mean.bias": ("zero",),
            "value.weight": ("orth", 1.0), "value.bias": ("zero",), "log_std": ("zero",)}
    port = tnetworks.MLPActorCritic(obs_dim, act_dim, arch, arch,
                                    generator=torch.Generator().manual_seed(seed)).state_dict()
    tree = jnetworks.MLPActorCritic(act_dim, arch, arch).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    return laws, port, interop.ppo_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                                     device=CPU)


def _lstm_case(seed):
    obs_dim, act_dim, enc, hidden = 11, 3, (48,), 64
    laws = {**_dense_laws("enc", (obs_dim,) + enc, "orth"),
            "cell.wi": ("lecun", enc[-1]), "cell.wh": ("orth_blocks", 1.0, 4),
            "cell.bh": ("zero",), "mean.weight": ("orth", 0.01), "mean.bias": ("zero",),
            "value.weight": ("lecun", hidden), "value.bias": ("zero",), "log_std": ("zero",)}
    port = tnetworks.LSTMActorCritic(obs_dim, act_dim, hidden, enc,
                                     generator=torch.Generator().manual_seed(seed)).state_dict()
    model = jnetworks.LSTMActorCritic(act_dim, hidden, enc)
    tree = model.init(jax.random.PRNGKey(seed), model.initial_carry(1),
                               jnp.zeros((1, obs_dim)))
    return laws, port, interop.lstm_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                                      device=CPU)


def _offpolicy_case(seed, stochastic):
    obs_dim, act_dim, arch = 11, 3, (96, 64)
    laws = {**_dense_laws("trunk", (obs_dim,) + arch, "lecun"),
            "mean.weight": ("lecun", arch[-1]), "mean.bias": ("zero",)}
    if stochastic:
        laws.update({"log_std.weight": ("lecun", arch[-1]), "log_std.bias": ("zero",)})
    for j in range(2):
        laws.update({f"qs.{j}.{k}": v for k, v in
                     _dense_laws("trunk", (obs_dim + act_dim,) + arch, "orth").items()})
        laws.update({f"qs.{j}.out.weight": ("lecun", arch[-1]), f"qs.{j}.out.bias": ("zero",)})
    g = torch.Generator().manual_seed(seed)
    port = {**top._Actor(obs_dim, act_dim, arch, stochastic, g).state_dict(),
            **top.TwinQ(obs_dim, act_dim, arch, False, g).state_dict()}
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    obs, act = jnp.zeros((1, obs_dim)), jnp.zeros((1, act_dim))
    actor = jop._Actor(act_dim, arch, stochastic).init(k1, obs)
    q_init = jnetworks.QNetwork(arch).init
    q = {"params": {f"QNetwork_{j}": q_init(k, obs, act)["params"]
                    for j, k in enumerate((k2, k3))}}
    a_state, q_state = interop.offpolicy_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, actor), jax.tree_util.tree_map(np.asarray, q),
        stochastic, device=CPU)
    return laws, port, {**a_state, **q_state}


INIT_CASES = {"ppo": _ppo_case, "lstm": _lstm_case,
              "sac": lambda s: _offpolicy_case(s, True),
              "td3": lambda s: _offpolicy_case(s, False)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", list(INIT_CASES))
def test_initial_params_follow_jax_law(case, seed):
    laws, port, jax_state = INIT_CASES[case](seed)
    _check_law(jax_state, laws, f"{case} JAX seed {seed}")
    _check_law(port, laws, f"{case} port seed {seed}")
    for k in laws:
        assert port[k].shape == jax_state[k].shape, k


# ------------------------------------------------------- the tool's verdict

def test_reward_parity_statistics():
    stats = pytest.importorskip("scipy.stats")
    tool = _tool()
    a, b = [1.0, 2.0, 3.0, 4.0, 5.0], [2.0, 4.0, 6.0, 8.0, 10.0]
    assert tool.seed_stats(a) == pytest.approx((3.0, math.sqrt(0.5)))
    assert tool.seed_stats(b) == pytest.approx((6.0, math.sqrt(2.0)))
    mean, se = tool.seed_stats([7.0])
    assert mean == 7.0 and math.isnan(se)
    diff, se, t, dof = tool.welch(a, b)
    assert (diff, se) == pytest.approx((-3.0, math.sqrt(2.5)))
    assert dof == pytest.approx(6.25 / 1.0625)
    ref = stats.ttest_ind(a, b, equal_var=False)
    assert t == pytest.approx(ref.statistic, rel=1e-12)
    assert tool.verdict(t) == "no gap shown"
    r = np.random.default_rng(3)
    x, y = r.normal(100.0, 5.0, 5), r.normal(120.0, 9.0, 4)
    _, _, t, _ = tool.welch(list(x), list(y))
    assert t == pytest.approx(stats.ttest_ind(x, y, equal_var=False).statistic, rel=1e-12)
    assert [tool.verdict(v) for v in (-3.01, -3.0, 3.0, 3.01)] == \
        ["gap: below", "no gap shown", "no gap shown", "gap: above"]


def test_row_verdict_reads_the_newest_line_of_each_seed(tmp_path, monkeypatch):
    tool = _tool()
    log = tmp_path / "parity.jsonl"
    monkeypatch.setattr(tool, "LOG", log)

    def seed_line(package, seed, mean, path="xla", device="cpu", **extra):
        return {"kind": "seed", "row": "R1", "package": package, "path": path,
                "device": device, "seed": seed, "eval": {"mean": mean}, **extra}

    lines = [seed_line("torch", 0, 1.0), seed_line("torch", 0, 10.0),   # the newer one counts
             seed_line("torch", 1, 20.0), seed_line("jax", 0, 12.0), seed_line("jax", 1, 18.0),
             seed_line("torch", 2, -1e9, init="jax"),                  # a bisection run: not read
             seed_line("torch", 0, 11.0, path="kernel", device="cuda", card="H100, 700 W"),
             seed_line("torch", 1, 21.0, path="kernel", device="cuda", card="H100, 700 W"),
             seed_line("torch", 0, 9.0, device="cuda"), seed_line("torch", 1, 19.0, device="cuda"),
             {"kind": "row", "row": "R1"}, seed_line("jax", 2, 5.0) | {"row": "R2"}]
    for line in lines:
        tool.append(line, log)
    cpu = tool.row_verdict("R1", card=False)
    assert cpu["torch"]["seeds"] == [0, 1] and cpu["torch"]["means"] == [10.0, 20.0]
    assert cpu["jax"]["seeds"] == [0, 1] and cpu["jax"]["means"] == [12.0, 18.0]
    assert (cpu["diff"], cpu["t"]) == pytest.approx(tool.welch([10.0, 20.0], [12.0, 18.0])[::2])
    assert cpu["verdict"] == "no gap shown" and cpu["budget"] == 4_000_000
    card = tool.row_verdict("R1", card=True)
    assert card["kernel"]["means"] == [11.0, 21.0] and card["xla"]["means"] == [9.0, 19.0]
    assert card["card"] == "H100, 700 W" and card["device"] == "card"
