"""The LSTM actor-critic (agents/networks.py ``LSTMActorCritic``), its fold
(``episode_kernels.fold_lstm_actor``), the plain versions of the LSTM
kernels K22 ``episode_returns_im_lstm``, K23 ``sample_lstm_streams_debug_im``
and K24 ``rollout_traj_im_lstm``, and ``lstm_policy_episode_returns``,
against the JAX package.

The JAX LSTM kernels draw from the TPU's hardware generator and cannot run
on the CPU, so the plain versions are held to the JAX math and to the JAX
stream-in kernel: the port's Philox streams are handed to JAX as NumPy
arrays. JAX runs its Pallas stream-in kernel ``episode_returns_im`` in
interpret mode, its env chain (``_replay_chain`` of
tests/test_kernel_rollout.py, and a flax chain written after
tests/test_pallas_policy.py:319-349) and ``model.apply``. Tolerances:

- the module against flax ``model.apply`` over 6 steps with an episode
  boundary inside: ``rtol=atol=2e-5`` (tests/test_pallas_policy.py:275-280);
- the fold against JAX's on the same parameters and statistics: atol 1e-6;
- ``lstm_forward`` against JAX's folded math (fast_episodes.py:268-278) on
  the same obs and carry: ``rtol=atol=2e-5``;
- plain K22 against JAX's K7 on K23's streams: ``rtol=1e-5, atol=1e-3``
  (f32 profit sums in the same order; XLA may contract a product and a sum
  into an FMA);
- K23's actions against the flax chain on K23's demand: at least 99.9% of
  elements agree (the actor sums in another order, so a value on a
  truncation boundary may take the other integer and the lane diverges);
- plain K24 replayed through ``_replay_chain``: inv exact, rewards
  ``rtol=1e-5, atol=1e-2``; its raws the flax mean on the replayed obs plus
  std times the replayed Philox normals: atol 1e-4.

Kernel-against-plain checks need the card; they are marked ``cuda`` and
skip without one (chip_smoke.py makes them at full width).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernel_rollout import _replay_chain

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import recurrent_ppo as trppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_torch.vector import vecenv
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.agents import recurrent_ppo as jrppo
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
STEPS, B = 12, 256
LOG_STD = torch.full((3,), -0.7)


def _params(**kw):
    jp = jim.default_params(**dict(dict(periods=STEPS), **kw))
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


def _jax_actor(jp, hidden=16, encoder=(8,), seed=0, head_gain=30.0):
    """A flax LSTMActorCritic for ``jp`` whose mean head is scaled by
    ``head_gain`` (so that the actions move), and obs statistics of mean
    ~50, std ~20. Returns (cfg, model, params, rms)."""
    cfg = jrppo.RecurrentPPOConfig(hidden=hidden, encoder=encoder)
    model = jrppo._make_model(jim.ENV, jp, cfg)
    D = jim.ENV.observation_space(jp).shape[0]
    mp = model.init(jax.random.PRNGKey(seed), model.initial_carry(1), jnp.zeros((1, D)))
    mp = jax.tree_util.tree_map(np.asarray, mp)
    head = f"Dense_{len(encoder)}"
    mp["params"][head]["kernel"] = mp["params"][head]["kernel"] * head_gain
    rms = jppo.RunningMeanStd.create(D).update(
        50.0 + 20.0 * jax.random.normal(jax.random.PRNGKey(seed + 1), (256, D)))
    return cfg, model, mp, rms


def _port_actor(jp, hidden=16, encoder=(8,), seed=0):
    """The same actor on the port's side: (model, rms, folded actor)."""
    cfg, _, mp, rms = _jax_actor(jp, hidden, encoder, seed)
    D = jim.ENV.observation_space(jp).shape[0]
    model = tnetworks.LSTMActorCritic(D, jp.m1, hidden=hidden, encoder=encoder)
    model.load_state_dict(interop.lstm_params_from_numpy(mp, device=CPU))
    trms = interop.rms_from_numpy(rms.mean, rms.var, rms.count, device=CPU)
    return model, trms, tek.fold_lstm_actor(trppo.RecurrentPPOConfig(), model, trms)


def _flax_chain_actions(jp, model, mp, rms, dems):
    """The deterministic flax policy on the JAX env chain driven by
    ``dems`` (T, n): its int actions (T, m1, n)."""
    c = jnp.asarray(jp.c, jnp.float32)

    @jax.jit
    def run(dems_tb):
        n = dems_tb.shape[1]
        state = jax.vmap(lambda _: jim.reset(jp)[0])(jnp.arange(n))
        obs0 = jax.vmap(lambda s: jim._obs(jp, s))(state)

        def body(carry, d):
            state, obs, lc = carry
            lc, (mean, _, _) = model.apply(mp, lc, rms.normalize(obs))
            a = ((jnp.tanh(mean) + 1.0) * 0.5 * c).astype(jnp.int32)
            state, ts = jax.vmap(jim.step_with_demand, in_axes=(None, 0, 0, 0))(jp, state, a, d)
            return (state, ts.obs, lc), a

        return jax.lax.scan(body, (state, obs0, model.initial_carry(n)), dems_tb)[1]

    return np.asarray(run(jnp.asarray(dems))).transpose(0, 2, 1)


def _jax_k7(jp, acts, dems):
    return np.asarray(jek.episode_returns_im(jp, jnp.asarray(np.asarray(acts)),
                                             jnp.asarray(np.asarray(dems)),
                                             block=acts.shape[-1], interpret=True))


def test_lstm_actor_critic_matches_flax_over_a_sequence():
    jp, _ = _params()
    _, model, mp, _ = _jax_actor(jp, head_gain=1.0)
    D, n = 33, 16
    tmodel = tnetworks.LSTMActorCritic(D, 3, hidden=16, encoder=(8,),
                                       generator=torch.Generator().manual_seed(0))
    want_shapes = {k: tuple(v.shape) for k, v in
                   interop.lstm_params_from_numpy(mp, device=CPU).items()}
    assert {k: tuple(v.shape) for k, v in tmodel.state_dict().items()} == want_shapes
    tmodel.load_state_dict(interop.lstm_params_from_numpy(mp, device=CPU))
    r = np.random.default_rng(3)
    obs = r.normal(size=(6, n, D)).astype(np.float32)
    done = np.zeros((6, n), bool)
    done[2, :5] = done[4, 3:9] = True
    c0 = r.normal(size=(n, 16)).astype(np.float32)
    h0 = r.normal(size=(n, 16)).astype(np.float32)
    jc, tc = (jnp.asarray(c0), jnp.asarray(h0)), (torch.from_numpy(c0), torch.from_numpy(h0))
    tol = dict(rtol=2e-5, atol=2e-5)
    means = []
    for t in range(6):
        jc, (jm, jls, jv) = model.apply(mp, jc, jnp.asarray(obs[t]), jnp.asarray(done[t]))
        with torch.no_grad():
            tc, (tm, tls, tv) = tmodel(tc, torch.from_numpy(obs[t]), torch.from_numpy(done[t]))
        for name, got, want in (("c", tc[0], jc[0]), ("h", tc[1], jc[1]), ("mean", tm, jm),
                                ("value", tv, jv), ("log_std", tls, jls)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       err_msg=f"{name}[{t}]", **tol)
        means.append(tm)
    with torch.no_grad():
        carry = (torch.from_numpy(c0), torch.from_numpy(h0))
        _, (seq_mean, _, _) = tmodel.forward_sequence(carry, torch.from_numpy(obs),
                                                      torch.from_numpy(done))
    np.testing.assert_allclose(seq_mean.numpy(), torch.stack(means).numpy(), **tol)


@pytest.mark.parametrize("encoder", [(8,), (8, 6), ()], ids=["enc8", "enc8-6", "no_enc"])
def test_fold_lstm_actor_matches_jax(encoder):
    jp, _ = _params()
    cfg, _, mp, rms = _jax_actor(jp, encoder=encoder)
    _, _, got = _port_actor(jp, encoder=encoder)
    want = jek.fold_lstm_actor(cfg, mp, rms)
    assert len(got["enc"]) == len(want["enc"]) == len(encoder)
    for (W, b), (jW, jb) in zip(got["enc"], want["enc"]):
        np.testing.assert_allclose(W.numpy(), np.asarray(jW), atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-6)
    for k in ("wx", "wh", "bh", "wm", "bm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)


def test_lstm_forward_is_jax_folded_math():
    jp, _ = _params()
    cfg, _, mp, rms = _jax_actor(jp)
    _, _, actor = _port_actor(jp)
    jactor = jek.fold_lstm_actor(cfg, mp, rms)
    r = np.random.default_rng(5)
    obs = (50.0 + 30.0 * r.normal(size=(64, 33))).astype(np.float32)
    H0 = (0.3 * r.normal(size=(64, 16))).astype(np.float32)
    C0 = (0.3 * r.normal(size=(64, 16))).astype(np.float32)
    X = jnp.asarray(obs)
    for W, b in jactor["enc"]:
        X = jnp.tanh(X @ W.T + b.T)
    G = X @ jactor["wx"].T + jnp.asarray(H0) @ jactor["wh"].T + jactor["bh"].T
    i, f = jax.nn.sigmoid(G[:, :16]), jax.nn.sigmoid(G[:, 16:32])
    g, o = jnp.tanh(G[:, 32:48]), jax.nn.sigmoid(G[:, 48:])
    C1 = f * jnp.asarray(C0) + i * g
    H1 = o * jnp.tanh(C1)
    mean = H1 @ jactor["wm"].T + jactor["bm"].T
    got_m, got_h, got_c = tek.lstm_forward(actor, list(torch.from_numpy(obs.T.copy())),
                                           torch.from_numpy(H0.T.copy()),
                                           torch.from_numpy(C0.T.copy()))
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_m.T.numpy(), np.asarray(mean), **tol)
    np.testing.assert_allclose(got_h.T.numpy(), np.asarray(H1), **tol)
    np.testing.assert_allclose(got_c.T.numpy(), np.asarray(C1), **tol)


@pytest.mark.parametrize("backlog", [True, False], ids=["backlog", "lost_sales"])
def test_plain_k22_k23_against_jax_k7_and_the_flax_chain(backlog):
    jp, tp = _params(backlog=backlog)
    _, model, mp, rms = _jax_actor(jp)
    _, _, actor = _port_actor(jp)
    ret, acts, dems = tek.sample_lstm_streams_debug_im(tp, actor, 71, B, device=CPU)
    k22 = tek.episode_returns_im_lstm(tp, actor, 71, B, device=CPU)
    assert acts.shape == (STEPS, tp.m1, B) and dems.shape == (STEPS, B)
    assert acts.dtype == dems.dtype == torch.int32 and torch.equal(ret, k22)
    np.testing.assert_allclose(k22.numpy(), _jax_k7(jp, acts, dems), rtol=1e-5, atol=1e-3)
    want = _flax_chain_actions(jp, model, mp, rms, dems.numpy())
    agree = want == acts.numpy()
    assert agree.mean() >= 0.999, agree.mean()
    assert len(np.unique(acts)) > 10 and acts.numpy().std(axis=0).mean() > 0


@pytest.mark.parametrize("backlog", [True, False], ids=["backlog", "lost_sales"])
def test_plain_k24_replays_through_the_jax_chain(backlog):
    jp, tp = _params(backlog=backlog)
    _, model, mp, rms = _jax_actor(jp)
    _, _, actor = _port_actor(jp)
    tr = tek.rollout_traj_im_lstm(tp, actor, LOG_STD, 71, B, device=CPU)
    _, _, dems = tek.sample_lstm_streams_debug_im(tp, actor, 71, B, device=CPU)
    assert torch.equal(tr["demand"], dems)   # K10's stream: the same demand words
    acts = tr["actions"].numpy()
    obs_all, rew, final_inv = _replay_chain(jp, acts, tr["demand"].numpy())
    obs_all = np.asarray(obs_all)
    np.testing.assert_array_equal(tr["inv"][:STEPS].numpy(),
                                  obs_all[:STEPS, :, :tp.m1].transpose(0, 2, 1))
    np.testing.assert_array_equal(tr["inv"][STEPS].numpy(), np.asarray(final_inv))
    np.testing.assert_allclose(tr["reward"].numpy(), np.asarray(rew), rtol=1e-5, atol=1e-2)
    # teacher-forced raws: the flax mean on the replayed obs + std * the normals
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
                                   err_msg=f"raw[{t}]")
    assert len(np.unique(acts)) > 10


def test_lstm_policy_episode_returns_on_the_three_families(monkeypatch):
    jp, tp = _params()
    _, _, actor = _port_actor(jp)
    out = tfe.lstm_policy_episode_returns(tp, actor, torch.Generator().manual_seed(5), 32,
                                          device=CPU)
    seed = tfe.kernel_seed(torch.Generator().manual_seed(5))
    assert out.shape == (32,) and torch.equal(out, tek.episode_returns_im_lstm(
        tp, actor, seed, 32, device=CPU))
    # a law past the inversion table's cap: the vecenv route with the carry
    # threaded, with a RuntimeWarning, as the JAX package's XLA scan
    wide = tim.default_params(periods=STEPS, dist_param={"mu": 50_000})
    with pytest.warns(RuntimeWarning, match="cap"):
        out = tfe.lstm_policy_episode_returns(wide, actor, torch.Generator().manual_seed(3), 4,
                                              device=CPU)
    assert out.shape == (4,) and bool(torch.isfinite(out).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfe.lstm_policy_episode_returns(tp, actor, torch.Generator(), 4)

    # Newsvendor and NetInvMgmt: the folded math on vecenv with the carry
    # threaded; Newsvendor's rewards weighted by gamma^t when gamma != 1
    g = torch.Generator().manual_seed(0)
    for params, env in ((tnv.default_params(step_limit=7, gamma=0.9), tnv.ENV),
                        (tnet.default_params(num_periods=5), tnet.ENV)):
        D = env.observation_space(params).shape[0]
        act_dim = int(np.prod(env.action_space(params).shape))
        model = tnetworks.LSTMActorCritic(D, act_dim, hidden=8, encoder=(8,), generator=g)
        folded = tek.fold_lstm_actor(trppo.RecurrentPPOConfig(), model, None)
        rewards = []
        real_step = vecenv.batch_step

        def spy(*a, **k):
            state, ts = real_step(*a, **k)
            rewards.append(ts.reward)
            return state, ts

        monkeypatch.setattr(vecenv, "batch_step", spy)
        got = tfe.lstm_policy_episode_returns(params, folded, torch.Generator().manual_seed(1),
                                              16, device=CPU)
        monkeypatch.setattr(vecenv, "batch_step", real_step)
        assert got.shape == (16,) and torch.isfinite(got).all()
        assert len(rewards) == env.horizon(params)
        w = [np.float32(getattr(params, "gamma", 1.0)) ** np.float32(t)
             for t in range(len(rewards))] if env is tnv.ENV else [1.0] * len(rewards)
        want = sum(float(wt) * r for wt, r in zip(w, rewards))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-2)


def test_lstm_wrappers_check_inputs_and_count_no_launches_on_cpu():
    jp, tp = _params()
    _, _, actor = _port_actor(jp)
    wrappers = (tek.episode_returns_im_lstm, tek.sample_lstm_streams_debug_im,
                tek.rollout_traj_im_lstm)
    counts = [w.launches for w in wrappers]
    tek.episode_returns_im_lstm(tp, actor, 1, 8, device=CPU)
    tek.sample_lstm_streams_debug_im(tp, actor, 1, 8, device=CPU)
    tek.rollout_traj_im_lstm(tp, actor, LOG_STD, 1, 8, device=CPU)
    assert counts == [w.launches for w in wrappers]
    if not torch.cuda.is_available():   # device=None means the card
        for call in (lambda: tek.episode_returns_im_lstm(tp, actor, 1, 8),
                     lambda: tek.sample_lstm_streams_debug_im(tp, actor, 1, 8),
                     lambda: tek.rollout_traj_im_lstm(tp, actor, LOG_STD, 1, 8)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    with pytest.raises(ValueError, match="batch"):
        tek.episode_returns_im_lstm(tp, actor, 1, 0, device=CPU)
    with pytest.raises(ValueError, match="obs_dim"):
        tek.episode_returns_im_lstm(tp, dict(actor, enc=actor["enc"][:0] + [
            (torch.zeros(8, 5), torch.zeros(8, 1))]), 1, 4, device=CPU)
    with pytest.raises(ValueError, match="wm"):
        tek.rollout_traj_im_lstm(tp, dict(actor, wm=actor["wm"][:2]), LOG_STD, 1, 4, device=CPU)
    # a NaN std: NaN raws cast to 0, as JAX's cast gives them
    tr = tek.rollout_traj_im_lstm(tp, actor, torch.full((3,), float("nan")), 1, 8, device=CPU)
    assert bool(torch.isnan(tr["raw"]).all()) and int(tr["actions"].abs().max()) == 0
    # a hidden width off the multiples of 4 packs for the general class,
    # padded to the unit groups of 8 with zero weights
    cpu = torch.device("cpu")
    model = tnetworks.LSTMActorCritic(33, 3, hidden=18, encoder=(8,))
    odd = tek.fold_lstm_actor(trppo.RecurrentPPOConfig(), model, None)
    st_odd, _ = tek._pack_lstm_actor(odd, None, 33, 3, tek._half_c(tp), cpu)
    assert isinstance(st_odd, tek._LstmG) and (st_odd.hidden, st_odd.h_pad) == (18, 24)
    assert tek.episode_returns_im_lstm(tp, odd, 1, 4, device=CPU).shape == (4,)
    st, flat = tek._pack_lstm_actor(actor, tek.clipped_std(LOG_STD), 33, 3, tek._half_c(tp), cpu)
    # the gates' and the encoder's weights as tensor-core fragments, zero-padded:
    # gates (4 x 16, 16 + 16), encoder (16, 40) and its bias 16
    assert flat.numel() == (16 + 16) * 16 * 4 + 16 * 4 + 16 * 40 + 16 + 3 * 16 + 3 + 3
    # a block of 64 lanes, 8 warps; rows of 64 + 8 floats: E 16, H 2 x 16, obs
    # 40, means 3, the draws' two buffers of 3 normals and the demand
    assert (st.lanes, st.threads, st.s_total) == (64, 256, (16 + 2 * 16 + 40 + 3 + 8) * 72)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backlog", [True, False])
def test_k22_k23_k24_match_plain_on_cuda(backlog, cuda):
    jp, tp = _params(backlog=backlog, periods=30)
    _, _, actor = _port_actor(jp, hidden=32, encoder=(16,))
    actor = tek._lstm_on(actor, cuda)
    b = 3000   # not a multiple of the block's lanes: the tail is masked
    ret, acts, dems = tek.sample_lstm_streams_debug_im(tp, actor, 9, b, device=cuda)
    want, want_a, want_d = tek._im_lstm_plain(tp, actor, 9, b, cuda, True)
    assert torch.equal(dems, want_d)
    ok = (ret.double() - want.double()).abs() <= 1e-2 + 1e-4 * want.double().abs()
    assert float(ok.double().mean()) >= 0.99
    assert float((acts == want_a).all(1).all(0).double().mean()) >= 0.99
    torch.testing.assert_close(tek.episode_returns_im_lstm(tp, actor, 9, b, device=cuda), ret,
                               rtol=0, atol=0)
    tr = tek.rollout_traj_im_lstm(tp, actor, LOG_STD.to(cuda), 9, b, device=cuda)
    ptr = tek._rollout_traj_im_lstm_plain(tp, actor, tek.clipped_std(LOG_STD), 9, b, cuda)
    assert torch.equal(tr["demand"], dems) and torch.equal(ptr["demand"], dems)
    assert float((tr["inv"] == ptr["inv"]).all(1).all(0).double().mean()) >= 0.99
