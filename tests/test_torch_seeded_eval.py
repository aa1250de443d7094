"""The seeded evaluators (``vector.vecenv.evaluate_episodes_seeded`` and
``evaluate_episodes_seeded_stateful``) on their per-lane Philox streams.

Lane i's episode is drawn from the key (seeds[i], ``rng.SEEDED_KEY``) alone
(ops/rng.py), so the port's streams cannot equal the JAX package's
``fold_in`` keys. What is held:

- the tensor-key Philox words equal the int-key words lane by lane, bit for
  bit, and the int path is untouched;
- lane independence, bit for bit: a permuted batch, a sub-batch and a batch
  of one give the same rows (an elementwise deterministic policy, so that
  nothing but the env's draws could couple the lanes);
- replay against JAX: the port's drawn demand (and Newsvendor's economics),
  read from the trajectory's ``info``, fed to JAX's own seeded evaluator
  through an env whose ``reset`` finds the lane from its ``fold_in`` key and
  whose ``step`` is ``step_with_demand`` on that lane's row, with the same
  deterministic MLP policy (``ppo_params_from_numpy``) or LSTM policy
  (``lstm_params_from_numpy``), gives the same totals: InvManagement exactly
  (integer state), the float families by the fraction-closeness rule
  (at least 99% of lanes within rtol 1e-4, atol 1e-2, as the repo holds them;
  f32 tanh differs by ulps between XLA and torch);
- the stateful evaluator equals a hand-written carry loop over the same
  demand, bit for bit;
- the distribution against JAX's own seeded evaluator (its own samplers) on
  2,048 seeds with a constant policy: mean demand and mean return within 4
  standard errors of the difference;
- each family's ``seeded_draws`` gives the evaluator's demand, and a
  family without one, or a demand law past the table cap, raises before
  any step.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.agents import recurrent_ppo as trppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import evaluate_episodes_seeded, \
    evaluate_episodes_seeded_stateful
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.agents import recurrent_ppo as jrppo
from or_gym_inventory_tpu.vector import vecenv as jvecenv
from test_torch_ppo_xla import _family

CPU = "cpu"
FAMILIES = ("inv_management", "net_inv_management", "newsvendor")
DEMAND_KEY = {"inv_management": "demand_realized", "net_inv_management": "demand",
              "newsvendor": "demand"}
NV_ECON = ("price", "cost", "holding_cost_rate", "penalty_cost_rate", "demand_mean")
MLP = dict(pi_arch=(16, 16), vf_arch=(16, 16), num_envs=1)
LSTM = dict(hidden=16, encoder=(16,), num_envs=1)


def test_tensor_keys_equal_int_keys():
    seeds = torch.tensor([0, 1, 7, 4000, 2 ** 31 - 1, 2 ** 32 - 1], dtype=torch.int64)
    lanes = torch.arange(seeds.shape[0], dtype=torch.int64)
    for period in (0, 3, rng.SEEDED_RESET_PERIOD):
        for blk in (0, 1):
            got = rng.philox4x32_10(lanes, 2, period, blk, seeds, rng.SEEDED_KEY)
            for i, s in enumerate(seeds.tolist()):
                want = rng.philox4x32_10(lanes[i], 2, period, blk, s, rng.SEEDED_KEY)
                assert [int(g[i]) for g in got] == [int(w) for w in want]
        words = rng.seeded_words(seeds, period, 6)
        for i, s in enumerate(seeds.tolist()):
            one = rng.seeded_words(torch.tensor([s]), period, 6)
            assert [int(w[i]) for w in words] == [int(w[0]) for w in one]
            blocks = (rng.philox4x32_10(0, 0, period, 0, s, rng.SEEDED_KEY)
                      + rng.philox4x32_10(0, 0, period, 1, s, rng.SEEDED_KEY))
            assert [int(w[i]) for w in words] == [int(b) for b in blocks[:6]]
    # the int path, as every kernel's plain version draws it: a known block
    w = rng.philox4x32_10(0, 0, 0, 0, 0, 0)
    assert [int(x) for x in w] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def _elementwise_policy(tmod, tp):
    """A deterministic policy whose every output depends on its own lane's
    obs alone, elementwise."""
    space = tmod.ENV.action_space(tp)
    low = torch.as_tensor(space.low, dtype=torch.float32)
    high = torch.as_tensor(np.where(np.isinf(space.high), 1e4, space.high), dtype=torch.float32)
    n = low.shape[0]
    ints = np.issubdtype(space.dtype, np.integer)

    def policy(_state, obs, _generator, _t):
        x = obs[:, :n].to(torch.float32)
        a = torch.minimum(torch.maximum(0.5 * high - 0.25 * x, low), high)
        return a.to(torch.int32) if ints else a
    return policy


@pytest.mark.parametrize("family", FAMILIES)
def test_lanes_depend_on_their_seed_alone(family):
    _, tmod, _, tp, _ = _family(family)
    policy = _elementwise_policy(tmod, tp)
    seeds = torch.arange(100, 164)

    def run(s):
        totals, traj = evaluate_episodes_seeded(tmod.ENV, tp, policy, None, s, device=CPU)
        return totals, traj.info[DEMAND_KEY[family]], traj.obs

    full = run(seeds)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(3))
    for idx in (perm, torch.arange(10, 20), torch.tensor([5])):
        part = run(seeds[idx])
        for got, want in zip(part, full):
            assert torch.equal(got, want[idx] if got.dim() == 1 else want[:, idx])
    assert full[1].float().std() > 0


def _replay_env(jmod, seeds, demand, econ=None):
    """JAX's env whose ``reset`` finds the lane from its key (fold_in(
    PRNGKey(seed), 0), as JAX's seeded evaluators make it) and whose
    ``step`` is ``step_with_demand`` on the lane's row of ``demand`` (T, N,
    ...); Newsvendor resets with the lane's ``econ`` (N, 5)."""
    base = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    table = jax.vmap(jax.random.fold_in, (0, None))(base, 0)
    dem = jnp.asarray(demand)
    ec = None if econ is None else jnp.asarray(econ)

    def reset(params, key):
        lane = jnp.argmax(jnp.all(key == table, axis=-1))
        state, ts = (jmod.reset(params, key) if ec is None
                     else jmod.reset_with_econ(params, ec[lane]))
        return (state, lane, jnp.int32(0)), ts

    def step(params, state, action, _key):
        inner, lane, t = state
        inner, ts = jmod.step_with_demand(params, inner, action, dem[t, lane])
        return (inner, lane, t + 1), ts

    return dataclasses.replace(jmod.ENV, reset=reset, step=step)


def _replayed(family, jmod, seeds, traj):
    info = traj.info
    econ = (torch.stack([info[k][0] for k in NV_ECON], dim=1).numpy()
            if family == "newsvendor" else None)
    return _replay_env(jmod, seeds.numpy(), info[DEMAND_KEY[family]].numpy(), econ)


def _assert_totals(family, got, want):
    if family == "inv_management":
        np.testing.assert_array_equal(got, want)
    else:
        close = np.isclose(got, want, rtol=1e-4, atol=1e-2)
        assert close.mean() >= 0.99, (got[~close], want[~close])


@pytest.mark.parametrize("family", FAMILIES)
def test_replay_through_jax_matches(family):
    jmod, tmod, jp, tp, _ = _family(family)
    jcfg, tcfg = jppo.PPOConfig(**MLP), tppo.PPOConfig(**MLP)
    jstate = jppo.init_train_state(jmod.ENV, jp, jcfg, jax.random.PRNGKey(0), 1)
    tstate = tppo.init_train_state(tmod.ENV, tp, tcfg, torch.Generator().manual_seed(0), 1,
                                   device=CPU)
    tstate.params.load_state_dict(interop.ppo_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), device=CPU))
    seeds = torch.arange(4000, 4064)
    totals, traj = evaluate_episodes_seeded(
        tmod.ENV, tp, tppo.make_eval_policy(tmod.ENV, tp, tcfg), (tstate.params, tstate.rms),
        seeds, device=CPU)
    assert totals.shape == (64,) and torch.isfinite(totals).all()
    torch.testing.assert_close(totals, traj.reward.sum(dim=0), rtol=1e-6, atol=0)
    jtotals, jtraj = jvecenv.evaluate_episodes_seeded(
        _replayed(family, jmod, seeds, traj), jp, jppo.make_eval_policy(jmod.ENV, jp, jcfg),
        (jstate.params, jstate.rms), seeds.numpy())
    _assert_totals(family, totals.numpy(), np.asarray(jtotals))
    assert int(np.sum(np.asarray(jtraj.done)[-1])) == 64


def _lstm_pair(family, jmod, tmod, jp, tp):
    """A JAX and a port recurrent agent holding the same LSTM parameters
    and unit obs statistics, as after training."""
    jcfg, tcfg = jrppo.RecurrentPPOConfig(**LSTM), trppo.RecurrentPPOConfig(**LSTM)
    jmodel = jrppo._make_model(jmod.ENV, jp, jcfg)
    obs_dim = int(jmod.ENV.observation_space(jp).shape[0])
    jparams = jmodel.init(jax.random.PRNGKey(1), jmodel.initial_carry(1),
                          jnp.zeros((1, obs_dim), jnp.float32))
    model = trppo._make_model(tmod.ENV, tp, tcfg)
    model.load_state_dict(interop.lstm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device=CPU))
    jagent = jrppo.RecurrentPPOAgent(jmod.ENV, jmod.default_params, config=jcfg)
    jagent.env_params = jp
    jagent.train_state = SimpleNamespace(params=jparams,
                                         rms=jppo.RunningMeanStd.create(obs_dim))
    tagent = trppo.RecurrentPPOAgent(tmod.ENV, tmod.default_params, config=tcfg, device=CPU)
    tagent.env_params = tp
    tagent.train_state = SimpleNamespace(params=model,
                                         rms=tppo.RunningMeanStd.create(obs_dim, CPU))
    return jagent, tagent


@pytest.mark.parametrize("family", FAMILIES)
def test_stateful_matches_a_carry_loop_and_jax(family):
    jmod, tmod, jp, tp, _ = _family(family)
    jagent, tagent = _lstm_pair(family, jmod, tmod, jp, tp)
    carry0_fn, policy_fn = tagent.device_policy_stateful(tmod.ENV, tp)
    seeds = torch.arange(4000, 4032)
    totals, traj = evaluate_episodes_seeded_stateful(tmod.ENV, tp, carry0_fn, policy_fn,
                                                     seeds, device=CPU)
    assert totals.shape == (32,) and torch.isfinite(totals).all()

    # a hand-written carry loop over the same demand
    demand = traj.info[DEMAND_KEY[family]]
    if family == "newsvendor":
        state, ts = tmod.reset_with_econ(tp, torch.stack([traj.info[k][0] for k in NV_ECON], 1))
    else:
        state, ts = tmod.ENV.reset(tp, None, 32, device=CPU)
    model, rms = tagent.train_state.params, tagent.train_state.rms
    low, high, ints = tppo._action_bounds(tmod.ENV, tp, CPU)
    carry, obs, total = model.initial_carry(32), ts.obs, torch.zeros(32)
    with torch.no_grad():
        for t in range(tmod.ENV.horizon(tp)):
            carry, (mean, _, _) = model(carry, rms.normalize(obs), torch.zeros(32, dtype=bool))
            a = low + (torch.tanh(mean) + 1.0) * 0.5 * (high - low)
            state, ts = tmod.ENV.step_with_demand(tp, state, a.to(torch.int32) if ints else a,
                                                  demand[t])
            assert torch.equal(ts.obs, traj.next_obs[t])
            total, obs = total + ts.reward, ts.obs
    assert torch.equal(total, totals)

    # JAX's own stateful evaluator on the replayed streams
    jcarry0, jpolicy = jagent.device_policy_stateful(jmod.ENV, jp)
    jtotals, _ = jvecenv.evaluate_episodes_seeded_stateful(
        _replayed(family, jmod, seeds, traj), jp, jcarry0, jpolicy, seeds.numpy())
    _assert_totals(family, totals.numpy(), np.asarray(jtotals))


def _constant_policies(family, jmod, jp):
    space = jmod.ENV.action_space(jp)
    value = {"inv_management": 15, "net_inv_management": 20.0, "newsvendor": 60.0}[family]
    arr = np.full(space.shape, value, space.dtype)

    def jpolicy(_s, obs, _key, _t):
        return jnp.broadcast_to(jnp.asarray(arr), (obs.shape[0],) + arr.shape)

    def tpolicy(_s, obs, _generator, _t):
        return torch.from_numpy(arr).expand((obs.shape[0],) + arr.shape).clone()
    return jpolicy, tpolicy


def _mean_se(x):
    x = np.asarray(x, np.float64)
    return x.mean(), x.std(ddof=1) / np.sqrt(len(x))


@pytest.mark.parametrize("family", FAMILIES)
def test_distribution_matches_jax_seeded_evaluator(family):
    jmod, tmod, jp, tp, _ = _family(family)
    jpolicy, tpolicy = _constant_policies(family, jmod, jp)
    n = 2048
    totals, traj = evaluate_episodes_seeded(tmod.ENV, tp, tpolicy, None, torch.arange(n),
                                            device=CPU)
    jtotals, jtraj = jvecenv.evaluate_episodes_seeded(jmod.ENV, jp, jpolicy, None,
                                                      np.arange(n, dtype=np.uint32))
    key = DEMAND_KEY[family]
    dem = traj.info[key].double().reshape(traj.info[key].shape[0], n, -1).mean(dim=(0, 2))
    jd = np.asarray(jtraj.info[key], np.float64)
    jdem = jd.reshape(jd.shape[0], n, -1).mean(axis=(0, 2))
    for name, got, want in (("demand", dem.numpy(), jdem),
                            ("return", totals.numpy(), np.asarray(jtotals))):
        (m1, s1), (m2, s2) = _mean_se(got), _mean_se(want)
        assert abs(m1 - m2) <= 4 * np.hypot(s1, s2), (family, name, m1, m2, s1, s2)


def test_wide_law_refused_before_any_step():
    def policy(*_a):
        raise AssertionError("a step ran")

    wide = tim.default_params(periods=5, dist_param={"mu": 50_000})
    with pytest.raises(NotImplementedError, match="cap"):
        evaluate_episodes_seeded(tim.ENV, wide, policy, None, torch.arange(4), device=CPU)
    p = tnet.default_params(num_periods=5)
    topo = dataclasses.replace(p.topology, rt_demand=(("poisson", 50_000.0),)
                               + tuple(p.topology.rt_demand[1:]))
    wide = dataclasses.replace(p, topology=topo)
    with pytest.raises(NotImplementedError, match="cap"):
        evaluate_episodes_seeded_stateful(tnet.ENV, wide, lambda n: None, policy,
                                          torch.arange(4), device=CPU)


@pytest.mark.parametrize("family", FAMILIES)
def test_env_seeded_draws_feed_the_evaluator(family):
    """The evaluator steps on its env's ``seeded_draws``: one demand a
    period, equal to the trajectory's, bit for bit; an env without
    ``seeded_draws`` raises before any step."""
    _, mod, _, params, _ = _family(family)
    seeds = torch.arange(5, dtype=torch.int64) * 7 + 3
    reset, demands = mod.ENV.seeded_draws(params, seeds)
    _, ts = reset()
    assert len(demands) == mod.ENV.horizon(params) and ts.obs.shape[0] == 5
    policy = _elementwise_policy(mod, params)
    _, traj = evaluate_episodes_seeded(mod.ENV, params, policy, None, seeds, device=CPU)
    got = traj.info[DEMAND_KEY[family]]
    assert torch.equal(got, torch.stack(demands).to(got.dtype))

    def never(*_a):
        raise AssertionError("a step ran")
    bare = dataclasses.replace(mod.ENV, seeded_draws=None)
    with pytest.raises(NotImplementedError, match=family):
        evaluate_episodes_seeded(bare, params, never, None, seeds, device=CPU)
