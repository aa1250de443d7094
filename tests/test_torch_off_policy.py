"""The off-policy learners of the port (agents/off_policy.py: SAC, TD3 and
DDPG with ``collect="kernel"``) against the JAX package.

The JAX side's ``update_kernel`` runs on the CPU as tests/test_torch_im_ppo.py
runs its PPO update: ``pallas_episode_kernels.rollout_traj_im`` is patched
to return a trajectory made by the port's plain K27, and
``jax.default_backend`` answers "tpu" only while ``make_offpolicy`` is
built. The port runs the same trajectory, and its gradient steps take the
minibatch indices and normals that JAX's keys give (``iterate`` and
``one_update`` take them as tensors). Nothing in the JAX package changes.

Tolerances: networks, folds and the n-step collapse ``rtol=1e-5,
atol=1e-6`` (f32 sums in another order); the buffer and its pointer exactly;
one gradient step's losses ``rtol=1e-5``, its post-Adam parameters, targets,
temperature and statistics ``rtol=1e-5, atol=1e-6`` (the atol for the
biases Adam moves away from zero by ~lr, whose first update is
g / (|g| + eps)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import off_policy as top
from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.agents import networks as jnetworks
from or_gym_inventory_tpu.agents import off_policy as jop
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-6)
ARCH = (16, 16)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _im(periods):
    jp = jim.default_params(periods=periods)
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


def _jax_init(jp, cfg):
    init, _, _ = jop.make_offpolicy(jim.ENV, jp, cfg.replace(collect="xla"))
    return jax.jit(init)(jax.random.PRNGKey(0))


def _load(tstate, jstate, stochastic):
    """The port's state's networks and targets from a JAX state."""
    a_sd, q_sd = interop.offpolicy_params_from_numpy(
        _np_tree(jstate.actor_params), _np_tree(jstate.q_params), stochastic, device=CPU)
    ta_sd, tq_sd = interop.offpolicy_params_from_numpy(
        _np_tree(jstate.target_actor_params), _np_tree(jstate.target_q_params), stochastic,
        device=CPU)
    tstate.actor_params.load_state_dict(a_sd)
    tstate.q_params.load_state_dict(q_sd)
    tstate.target_actor_params.load_state_dict(ta_sd)
    tstate.target_q_params.load_state_dict(tq_sd)


def _assert_state_close(tstate, jstate, stochastic):
    a_sd, q_sd = interop.offpolicy_params_from_numpy(
        _np_tree(jstate.actor_params), _np_tree(jstate.q_params), stochastic, device=CPU)
    ta_sd, tq_sd = interop.offpolicy_params_from_numpy(
        _np_tree(jstate.target_actor_params), _np_tree(jstate.target_q_params), stochastic,
        device=CPU)
    for name, module, want in (("actor", tstate.actor_params, a_sd),
                               ("critics", tstate.q_params, q_sd),
                               ("target actor", tstate.target_actor_params, ta_sd),
                               ("target critics", tstate.target_q_params, tq_sd)):
        got = module.state_dict()
        assert set(got) == set(want), name
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                       err_msg=f"{name} {k}", **TOL)
    np.testing.assert_allclose(float(tstate.log_alpha), float(jstate.log_alpha), **TOL)


# ------------------------------------------------------------ config, networks

def test_config_fields_and_defaults_match_jax():
    jfields = [f.name for f in dataclasses.fields(jop.OffPolicyConfig)]
    tfields = [f.name for f in dataclasses.fields(top.OffPolicyConfig)]
    assert tfields == jfields
    jcfg, tcfg = jop.OffPolicyConfig(), top.OffPolicyConfig()
    for name in jfields:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.replace(algo="td3").algo == "td3"


@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_actor_and_critics_match_flax(algo):
    """_Actor, TwinQ (networks.QNetwork twice, once for DDPG) and the interop
    carry give flax's outputs on the same parameters and inputs."""
    jp, tp = _im(4)
    cfg = jop.OffPolicyConfig(algo=algo, num_envs=8, pi_arch=ARCH, q_arch=(12, 8))
    jstate = _jax_init(jp, cfg)
    stochastic = algo == "sac"
    D, A = 33, 3
    actor = top._Actor(D, A, ARCH, stochastic)
    twin = top.TwinQ(D, A, (12, 8), single=algo == "ddpg")
    a_sd, q_sd = interop.offpolicy_params_from_numpy(
        _np_tree(jstate.actor_params), _np_tree(jstate.q_params), stochastic, device=CPU)
    assert {k: tuple(v.shape) for k, v in actor.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in a_sd.items()}
    assert {k: tuple(v.shape) for k, v in twin.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in q_sd.items()}
    actor.load_state_dict(a_sd)
    twin.load_state_dict(q_sd)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(20, D)).astype(np.float32) * 3.0
    act = rng.uniform(-1, 1, size=(20, A)).astype(np.float32)
    jactor = jop._Actor(action_dim=A, arch=ARCH, stochastic=stochastic)
    jmean, jls = jactor.apply(jstate.actor_params, jnp.asarray(obs))
    with torch.no_grad():
        tmean, tls = actor(torch.from_numpy(obs))
        q1, q2 = twin(torch.from_numpy(obs), torch.from_numpy(act))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), **TOL)
    if stochastic:
        np.testing.assert_allclose(tls.numpy(), np.asarray(jls), **TOL)
    else:
        assert tls is None and jls is None
    qp = jstate.q_params["params"]
    for j, q in enumerate((q1, q2)):
        sub = qp[f"QNetwork_{0 if algo == 'ddpg' else j}"]
        want = jnetworks.QNetwork(arch=(12, 8)).apply({"params": sub}, jnp.asarray(obs),
                                                       jnp.asarray(act))
        np.testing.assert_allclose(q.numpy(), np.asarray(want), **TOL)


def test_qnetwork_initialisation():
    """QNetwork's trunk is orthogonal with gain sqrt(2), its output
    lecun-normal (flax's default Dense), its biases zero."""
    g = torch.Generator().manual_seed(0)
    q = tnetworks.QNetwork(30, 2, (64, 48), generator=g)
    w0 = q.trunk[0].weight.detach()          # (64, 32): orthogonal columns
    np.testing.assert_allclose((w0.T @ w0).numpy(), 2.0 * np.eye(32), atol=1e-5)
    w1 = q.trunk[1].weight.detach()          # (48, 64): orthogonal rows
    np.testing.assert_allclose((w1 @ w1.T).numpy(), 2.0 * np.eye(48), atol=1e-5)
    assert all(float(layer.bias.detach().abs().max()) == 0.0 for layer in q.trunk)
    assert float(q.out.bias.detach().abs().max()) == 0.0
    w = q.out.weight.detach()
    assert w.shape == (1, 48) and float(w.abs().max()) <= 2.0 * np.sqrt(1.0 / 48) / 0.8796 + 1e-6
    assert q(torch.zeros(5, 30), torch.zeros(5, 2)).shape == (5,)


# ------------------------------------------------------- n-step, buffer

def test_nstep_aggregate_hand_case():
    """The tests/test_off_policy.py:60 case: a done at entry 1 cuts the
    3-step return after it."""
    g = 0.9
    wrew = torch.tensor([[1.0, 1.0], [2.0, 2.0], [4.0, 4.0]])
    wdone = torch.tensor([[False, False], [True, False], [False, False]])
    wnext = torch.arange(6, dtype=torch.float32).reshape(3, 2, 1) + 10.0
    r, nxt, done, disc = top.nstep_aggregate(wrew, wdone, wnext, g)
    assert np.isclose(float(r[0]), 1.0 + g * 2.0) and float(nxt[0, 0]) == 12.0
    assert bool(done[0]) and np.isclose(float(disc[0]), g ** 2)
    assert np.isclose(float(r[1]), 1.0 + g * 2.0 + g * g * 4.0) and float(nxt[1, 0]) == 15.0
    assert not bool(done[1]) and np.isclose(float(disc[1]), g ** 3)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_nstep_aggregate_matches_jax(n):
    rng = np.random.default_rng(n)
    B, D = 6, 3
    wrew = rng.normal(size=(n, B)).astype(np.float32)
    wdone = rng.random((n, B)) < 0.3
    wnext = rng.normal(size=(n, B, D)).astype(np.float32)
    got = top.nstep_aggregate(torch.from_numpy(wrew), torch.from_numpy(wdone),
                              torch.from_numpy(wnext), 0.97)
    want = jop.nstep_aggregate(jnp.asarray(wrew), jnp.asarray(wdone), jnp.asarray(wnext), 0.97)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **TOL)


@pytest.mark.parametrize("n_step", [1, 2, 3])
def test_episode_transitions_match_jax(n_step):
    """tests/test_kernel_collect.py:53's collapse, on the same inputs."""
    T, B, D, A = 7, 4, 3, 2
    rng = np.random.default_rng(n_step)
    obs = rng.normal(size=(T + 1, B, D)).astype(np.float32)
    a = rng.normal(size=(T, B, A)).astype(np.float32)
    r = rng.normal(size=(T, B)).astype(np.float32)
    got = top.episode_transitions(torch.from_numpy(obs), torch.from_numpy(a),
                                  torch.from_numpy(r), n_step, 0.9)
    want = jop.episode_transitions(jnp.asarray(obs), jnp.asarray(a), jnp.asarray(r), n_step,
                                   0.9)
    for name, x, y in zip(top.ReplayBuffer.FIELDS, got, want):
        assert tuple(x.shape) == tuple(y.shape), name
        if name == "done":
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), err_msg=name, **TOL)


def _buffers_equal(tbuf, jbuf):
    for name in top.ReplayBuffer.FIELDS:
        np.testing.assert_array_equal(getattr(tbuf, name).numpy(),
                                      np.asarray(getattr(jbuf, name)), name)
    assert tbuf.ptr == int(jbuf.ptr) and tbuf.filled == int(jbuf.filled)


def test_replay_buffer_wraps_like_jax():
    """tests/test_off_policy.py:15: two inserts of 10 into 16 rows wrap the
    pointer to 4; the port's rows equal JAX's."""
    tbuf, jbuf = top.ReplayBuffer.create(16, 3, 2), jop.ReplayBuffer.create(16, 3, 2)
    obs = np.arange(30, dtype=np.float32).reshape(10, 3)
    act = np.linspace(-1, 1, 20, dtype=np.float32).reshape(10, 2)
    r = np.arange(10, dtype=np.float32)
    done = np.arange(10) % 3 == 0
    disc = np.full(10, 0.99, np.float32)
    for k in range(2):
        tbuf = tbuf.insert(*(torch.from_numpy(x + k) if x.dtype != bool else torch.from_numpy(x)
                             for x in (obs, act, r, obs, done, disc)))
        jbuf = jbuf.insert(*(jnp.asarray(x + k) if x.dtype != bool else jnp.asarray(x)
                             for x in (obs, act, r, obs, done, disc)))
    assert tbuf.filled == 16 and tbuf.ptr == 4
    _buffers_equal(tbuf, jbuf)
    mb = tbuf.sample(torch.Generator().manual_seed(0), 8)
    assert mb["obs"].shape == (8, 3) and mb["done"].dtype == torch.bool
    idx = torch.tensor([0, 5, 15])
    assert torch.equal(tbuf.gather(idx)["reward"], tbuf.reward[idx])


def test_insert_chunk_equals_insert_and_fills_exactly():
    """tests/test_kernel_collect.py:88: one chunk fills a buffer of exactly
    num_envs * horizon rows; insert_chunk at aligned pointers equals the row
    scatter, across the ring's wrap; t-major, oldest first."""
    T, B, D, A = 5, 8, 3, 2
    rng = np.random.default_rng(0)
    obs_all = rng.normal(size=(T + 1, B, D)).astype(np.float32)
    a = rng.normal(size=(T, B, A)).astype(np.float32)
    r = rng.normal(size=(T, B)).astype(np.float32)
    tup = top.episode_transitions(torch.from_numpy(obs_all), torch.from_numpy(a),
                                  torch.from_numpy(r), 1, 0.99)
    jtup = jop.episode_transitions(jnp.asarray(obs_all), jnp.asarray(a), jnp.asarray(r), 1,
                                   0.99)
    buf = top.ReplayBuffer.create(T * B, D, A).insert(*tup)
    assert buf.filled == T * B and buf.ptr == 0
    buf2 = top.ReplayBuffer.create(2 * T * B, D, A).insert_chunk(*tup)
    ref2 = top.ReplayBuffer.create(2 * T * B, D, A).insert(*tup)
    for f in top.ReplayBuffer.FIELDS:
        assert torch.equal(getattr(buf2, f), getattr(ref2, f)), f
    assert (buf2.ptr, buf2.filled) == (ref2.ptr, ref2.filled)
    buf3 = buf2.insert_chunk(*tup).insert_chunk(*tup)
    assert buf3.ptr == T * B and buf3.filled == 2 * T * B
    jbuf = jop.ReplayBuffer.create(2 * T * B, D, A)
    for _ in range(3):
        jbuf = jbuf.insert_chunk(*jtup)
    _buffers_equal(buf3, jbuf)
    np.testing.assert_allclose(buf.obs[0].numpy(), obs_all[0, 0])
    np.testing.assert_allclose(buf.obs[-1].numpy(), obs_all[T - 1, -1])
    np.testing.assert_allclose(buf.next_obs[-1].numpy(), obs_all[T, -1])
    assert bool(buf.done[-1]) and not bool(buf.done[0])


def test_insert_chunk_refuses_a_chunk_that_does_not_divide():
    tup = top.episode_transitions(torch.zeros(4, 3, 2), torch.zeros(3, 3, 1), torch.zeros(3, 3),
                                  1, 0.9)
    with pytest.raises(AssertionError, match="capacity"):
        top.ReplayBuffer.create(10, 2, 1).insert_chunk(*tup)
    buf = top.ReplayBuffer.create(18, 2, 1).insert(*(x[:4] for x in tup))
    with pytest.raises(AssertionError, match="ptr"):
        buf.insert_chunk(*tup)


# ------------------------------------------------------- config contract

def test_collect_kernel_config_validation():
    """tests/test_kernel_collect.py:160, with the port's departures: no
    num_envs % 1024 and no TPU-backend check; a mesh raises
    NotImplementedError naming ROADMAP A14; the default config
    (collect="xla") and the four agents construct."""
    _, tp = _im(30)
    make = top.make_offpolicy
    with pytest.raises(ValueError, match="'xla' or 'kernel'"):
        make(tim.ENV, tp, top.OffPolicyConfig(collect="x"), device=CPU)
    _, update, _ = make(tim.ENV, tp, top.OffPolicyConfig(), device=CPU)
    assert callable(update.iterate) and callable(update.one_update)
    with pytest.raises(ValueError, match="n_step"):
        make(tim.ENV, tp, top.OffPolicyConfig(collect="kernel", num_envs=100, n_step=99),
             device=CPU)
    with pytest.raises(ValueError, match="n_step must be >= 1"):
        make(tim.ENV, tp, top.OffPolicyConfig(collect="kernel", n_step=0), device=CPU)
    with pytest.raises(ValueError, match="collection chunk"):
        make(tim.ENV, tp, top.OffPolicyConfig(collect="kernel", num_envs=1024,
                                              buffer_size=1024), device=CPU)
    with pytest.raises(ValueError, match="algo"):
        make(tim.ENV, tp, top.OffPolicyConfig(algo="ppo", collect="kernel"), device=CPU)
    with pytest.raises(NotImplementedError, match="A14"):
        make(tim.ENV, tp, top.OffPolicyConfig(collect="kernel"), axis_name="env", device=CPU)
    with pytest.raises(NotImplementedError, match="A14"):
        top.train(tim.ENV, tp, top.OffPolicyConfig(collect="kernel"), torch.Generator(), 10,
                  mesh=object(), device=CPU)
    for agent, algo in ((top.OffPolicyAgent, "sac"), (top.SACAgent, "sac"),
                        (top.TD3Agent, "td3"), (top.DDPGAgent, "ddpg")):
        built = agent(tim.ENV, tim.default_params)
        assert built.config.algo == algo and built.state is None
    # 100 envs run (JAX refused num_envs % 1024); the capacity is rounded
    # down to whole collection chunks, as JAX does (off_policy.py:339)
    init, _, _ = make(tim.ENV, tp, top.OffPolicyConfig(
        collect="kernel", num_envs=100, buffer_size=100 * 30 * 5 // 2, pi_arch=(8,),
        q_arch=(8,)), device=CPU)
    state = init(torch.Generator().manual_seed(0))
    assert state.buffer.size == 2 * 100 * 30 and state.last_obs.shape == (100, 33)


# ------------------------------------------------- one iteration against JAX

def _jax_draws(key, n_upd, batch, act_dim, filled, algo):
    """The minibatch rows and normals JAX's update_kernel draws from
    ``key`` (off_policy.py:588, :645, :488-530)."""
    _, ukey = jax.random.split(key)
    idx, zs = [], []
    for uk in jax.random.split(ukey, n_upd):
        idx.append(np.asarray(jax.random.randint(uk, (batch,), 0,
                                                 jnp.maximum(jnp.int32(filled), 1))))
        zn = jax.random.normal(jax.random.fold_in(uk, 0 if algo == "sac" else 1),
                               (batch, act_dim))
        zp = jax.random.normal(jax.random.fold_in(uk, 2), (batch, act_dim))
        zs.append(np.stack([np.asarray(zn), np.asarray(zp)]))
    return torch.from_numpy(np.stack(idx).astype(np.int64)), torch.from_numpy(np.stack(zs))


def _jax_losses(jstate, jnew, cfg, idx, z, act_dim):
    """JAX's first gradient step's losses, written out with its own modules
    (off_policy.py:488-542): the critics' loss on the initial parameters,
    the actor's on the critics after their step (jnew's, one update)."""
    stochastic = cfg.algo == "sac"
    actor = jop._Actor(action_dim=act_dim, arch=cfg.pi_arch, stochastic=stochastic)
    buf, rms = jnew.buffer, jnew.rms
    mb = {k: getattr(buf, k)[jnp.asarray(idx.numpy())] for k in top.ReplayBuffer.FIELDS}
    nob, nnext = rms.normalize(mb["obs"]), rms.normalize(mb["next_obs"])
    zn, zp = jnp.asarray(z[0].numpy()), jnp.asarray(z[1].numpy())

    def twin(q_tree, obs, act):
        qp = q_tree["params"]
        qs = [jnetworks.QNetwork(arch=cfg.q_arch).apply({"params": qp[f"QNetwork_{j}"]},
                                                         obs, act)
              for j in range(1 if cfg.algo == "ddpg" else 2)]
        return qs[0], qs[-1]

    alpha = jnp.exp(jstate.log_alpha)
    if stochastic:
        mean, ls = actor.apply(jstate.actor_params, nnext)
        raw = mean + jnp.exp(jnp.clip(ls, -10.0, 2.0)) * zn
        q1t, q2t = twin(jstate.target_q_params, nnext, jnp.tanh(raw))
        qt = jnp.minimum(q1t, q2t) - alpha * jnetworks.gaussian_log_prob(raw, mean, ls)
    else:
        next_a = jnp.tanh(actor.apply(jstate.target_actor_params, nnext)[0])
        if cfg.algo == "td3":
            next_a = jnp.clip(next_a + jnp.clip(cfg.target_noise * zn, -cfg.noise_clip,
                                                cfg.noise_clip), -1.0, 1.0)
        q1t, q2t = twin(jstate.target_q_params, nnext, next_a)
        qt = jnp.minimum(q1t, q2t)
    target = mb["reward"] + mb["disc"] * qt
    q1, q2 = twin(jstate.q_params, nob, mb["action"])
    q_loss = ((q1 - target) ** 2).mean()
    if cfg.algo != "ddpg":
        q_loss = q_loss + ((q2 - target) ** 2).mean()
    if stochastic:
        mean, ls = actor.apply(jstate.actor_params, nob)
        raw = mean + jnp.exp(jnp.clip(ls, -10.0, 2.0)) * zp
        q1, q2 = twin(jnew.q_params, nob, jnp.tanh(raw))
        a_loss = (alpha * jnetworks.gaussian_log_prob(raw, mean, ls)
                  - jnp.minimum(q1, q2)).mean()
    else:
        mean, _ = actor.apply(jstate.actor_params, nob)
        q1, _ = twin(jnew.q_params, nob, jnp.tanh(mean))
        sat = jnp.maximum(jnp.abs(mean) - 1.0, 0.0)
        a_loss = -q1.mean() + cfg.pretanh_penalty * (jnp.abs(q1).mean() + 1.0) * (sat ** 2).mean()
    return float(q_loss), float(a_loss)


@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_iterations_match_jax_update_kernel(monkeypatch, algo):
    """Two iterations of JAX's update_kernel (one period, one update each:
    TD3's delay skips the actor's gradient at the second) against the port's
    ``iterate`` on the same trajectory and draws: the buffer and its pointer
    exactly, the statistics, networks, targets and temperature; then one
    ``one_update`` on JAX's first buffer gives JAX's first losses."""
    B, batch = 1024, 32
    jp, tp = _im(1)
    stochastic = algo == "sac"
    kw = dict(algo=algo, collect="kernel", num_envs=B, buffer_size=2 * B, batch_size=batch,
              pi_arch=ARCH, q_arch=ARCH, start_steps=0)
    jcfg, tcfg = jop.OffPolicyConfig(**kw), top.OffPolicyConfig(**kw)
    jstate0 = _jax_init(jp, jcfg)

    tinit, tupdate, _ = top.make_offpolicy(tim.ENV, tp, tcfg, device=CPU)
    tstate = tinit(torch.Generator().manual_seed(0))
    _load(tstate, jstate0, stochastic)
    actor_f = tek.fold_offpolicy_actor(ARCH, tstate.actor_params, None, stochastic)
    log_std = torch.full((3,), float(np.log(np.float32(0.1))))
    mode = "sac" if stochastic else "det"
    tr = tek.rollout_traj_im_offpolicy(tp, actor_f, log_std, 9, B, mode, "relu", CPU)
    jtr = {k: jnp.asarray(v.numpy()) for k, v in tr.items()}
    monkeypatch.setattr(jek, "rollout_traj_im", lambda *a, **k: jtr)
    monkeypatch.setattr(tek, "rollout_traj_im_offpolicy", lambda *a, **k: tr)
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        _, jupdate, _ = jop.make_offpolicy(jim.ENV, jp, jcfg)
    jupdate = jax.jit(jupdate)

    jstate, states = jstate0, []
    for it in range(2):
        key = jax.random.PRNGKey(10 + it)
        jnew, jmetrics = jupdate(jstate, key)
        idx, z = _jax_draws(key, 1, batch, 3, min((it + 1) * B, 2 * B), algo)
        tstate, tmetrics = tupdate.iterate(tstate, 0, idx, z)
        _buffers_equal(tstate.buffer, jnew.buffer)
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(tstate.rms, f).numpy(),
                                       np.asarray(getattr(jnew.rms, f)), err_msg=f, **TOL)
        _assert_state_close(tstate, jnew, stochastic)
        for k in jmetrics:
            np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), err_msg=k, **TOL)
        assert tstate.step_idx == it + 1 == int(jnew.step_idx)
        states.append((jstate, jnew, idx, z))
        jstate = jnew

    # the first step's losses, on a fresh port state holding JAX's first buffer
    j0, j1, idx, z = states[0]
    fresh = tinit(torch.Generator().manual_seed(0))
    _load(fresh, j0, stochastic)
    fresh.buffer = top.ReplayBuffer(*(torch.from_numpy(np.array(getattr(j1.buffer, f)))
                                      for f in top.ReplayBuffer.FIELDS),
                                    ptr=int(j1.buffer.ptr), filled=int(j1.buffer.filled))
    fresh.rms = interop.rms_from_numpy(j1.rms.mean, j1.rms.var, j1.rms.count, device=CPU)
    losses = tupdate.one_update(fresh, idx[0], z[0, 0], z[0, 1], 0)
    q_loss, a_loss = _jax_losses(j0, j1, jcfg, idx[0], z[0], 3)
    np.testing.assert_allclose(float(losses["q_loss"]), q_loss, rtol=1e-5)
    np.testing.assert_allclose(float(losses["actor_loss"]), a_loss, rtol=1e-5, atol=1e-6)
    _assert_state_close(fresh, j1, stochastic)


# ------------------------------------------------------------ train smoke

FAMILIES = {
    "inv_management": (tim.ENV, lambda: tim.default_params(periods=4)),
    "newsvendor": (tnv.ENV, lambda: tnv.default_params(step_limit=4)),
    "net_inv_management": (tnet.ENV, lambda: tnet.default_params(num_periods=4)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("algo", ["sac", "td3", "ddpg"])
def test_train_collect_kernel_on_cpu(algo, family):
    """``train`` runs JAX's iteration counts (off_policy.py:779-784: a whole
    horizon per env an iteration, the uniform warmup first) through the
    family's plain trajectory kernel, and the trained actor evaluates inside
    the action box."""
    env, make_params = FAMILIES[family]
    params = make_params()
    horizon = env.horizon(params)
    n_envs = 12
    steps_per_iter = n_envs * horizon
    total, start = 5 * steps_per_iter + 7, steps_per_iter + 1
    cfg = top.OffPolicyConfig(algo=algo, collect="kernel", num_envs=n_envs,
                              buffer_size=3 * steps_per_iter, batch_size=16, start_steps=start,
                              pi_arch=(8, 8), q_arch=(8, 8), n_step=2)
    n_iters = max(1, total // steps_per_iter)
    warm_iters = min(n_iters, -(-start // steps_per_iter))
    assert (n_iters, warm_iters) == (5, 2)
    state, eval_policy, metrics = top.train(env, params, cfg, torch.Generator().manual_seed(0),
                                            total, log_every=2, device=CPU)
    # chunks of at most 2 iterations, each within one phase: 2 warm, then 2 + 1
    np.testing.assert_array_equal(metrics["timesteps"],
                                  np.array([2, 4, 5]) * steps_per_iter)
    assert np.isfinite(metrics["mean_step_reward"]).all()
    assert state.step_idx == n_iters and state.buffer.filled == 3 * steps_per_iter
    assert (metrics["alpha"] != 1.0).any() == (algo == "sac")
    space = env.action_space(params)
    obs = torch.randn(6, env.observation_space(params).shape[0]) * 10
    a = eval_policy((state.actor_params, state.rms), obs, None, 0)
    assert a.shape == (6,) + tuple(space.shape)
    assert torch.isfinite(a.float()).all()
    assert (a >= torch.as_tensor(space.low)).all() and (a <= torch.as_tensor(space.high)).all()


def test_nstep_kernel_collection_inserts_only_real_transitions():
    """The kernel path's analogue of tests/test_off_policy.py:78: with
    n_step=3 each iteration inserts exactly num_envs * horizon transitions,
    every one from the episode (no zero-padded window); a window that
    reaches the horizon is cut there, done, with gamma^k of its k steps."""
    params = tnv.default_params(step_limit=6)
    cfg = top.OffPolicyConfig(algo="sac", collect="kernel", num_envs=8, buffer_size=8 * 6 * 2,
                              batch_size=8, start_steps=0, n_step=3, pi_arch=(8,), q_arch=(8,))
    init, update, _ = top.make_offpolicy(tnv.ENV, params, cfg, device=CPU)
    state = init(torch.Generator().manual_seed(0))
    state, _ = update(state, torch.Generator().manual_seed(1))
    assert state.buffer.filled == 48 and state.buffer.ptr == 48
    obs = state.buffer.obs[:48]
    assert (obs[:, :5] != 0).all()                 # the economics of every row
    disc = state.buffer.disc[:48].reshape(6, 8)
    np.testing.assert_allclose(disc[:4].numpy(), 0.99 ** 3, rtol=1e-6)
    np.testing.assert_allclose(disc[5].numpy(), 0.99, rtol=1e-6)
    done = state.buffer.done[:48].reshape(6, 8)
    assert done[3:].all() and not done[:3].any()   # the window reaches the horizon


def test_eval_policy_matches_jax():
    """The deterministic squashed mean rescaled to the box and int-cast, on
    carried parameters and statistics."""
    jp, tp = _im(4)
    cfg = dict(algo="td3", num_envs=8, pi_arch=ARCH, q_arch=ARCH)
    jstate = _jax_init(jp, jop.OffPolicyConfig(**cfg))
    rms = jstate.rms.update(40.0 + 15.0 * jax.random.normal(jax.random.PRNGKey(3), (64, 33)))
    _, _, jeval = jop.make_offpolicy(jim.ENV, jp, jop.OffPolicyConfig(**cfg))
    tinit, _, teval = top.make_offpolicy(tim.ENV, tp, top.OffPolicyConfig(
        **cfg, collect="kernel"), device=CPU)
    tstate = tinit(torch.Generator().manual_seed(0))
    _load(tstate, jstate, False)
    obs = np.random.default_rng(0).integers(0, 120, (16, 33)).astype(np.float32)
    want = jeval((jstate.actor_params, rms), jnp.asarray(obs), jax.random.PRNGKey(0), 0)
    got = teval((tstate.actor_params, interop.rms_from_numpy(rms.mean, rms.var, rms.count, device=CPU)),
                torch.from_numpy(obs), None, 0)
    assert got.dtype == torch.int32
    # an int cast: a rounding tie may land on the other integer
    assert (np.abs(got.numpy() - np.asarray(want)) <= 1).all()
    assert (got.numpy() == np.asarray(want)).mean() > 0.95
