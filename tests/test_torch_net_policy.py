"""The policy kernels' plain PyTorch versions (ops/net_step.py K4-K6), the
folded actor (ops/episode_kernels.py), ``assemble_obs_from_streams`` and
``policy_episode_returns`` against the JAX package, and the two repairs of
the episode step.

The JAX side runs on the CPU as its own tests run it: the XLA step chain
under vmap, and the Pallas stream-in kernel in interpret mode. The port's
streams come from its Philox generator, so they are handed to JAX as NumPy
arrays. Tolerances:

- streams replayed through the JAX step chain and the interpret kernel
  against plain K4's x, u, r and reward: ``rtol=1e-5, atol=1e-3``;
- ``assemble_obs_from_streams`` against JAX's, and the JAX ``_obs`` of the
  chain's states: exact (a gather of the same values);
- JAX ``folded_actor_mean`` on the assembled obs plus the plain normals
  against plain K4's ``raw``: ``atol=1e-4`` (matmul sums in another order);
- ``fold_actor_params`` against JAX's: ``rtol=1e-5, atol=1e-5``;
- plain K6's actions against JAX ``apply_folded_actor`` on the chain's obs:
  ``atol=1e-3`` (actions up to 1,700);
- plain K1 on plain K6's streams against plain K5: exact (the same PyTorch
  arithmetic on the same values);
- Poisson(50,000) and other wide laws: mean and variance within 5 standard
  errors.

Kernel-against-plain checks need the card; they are marked ``cuda`` and skip
without one (chip_smoke.py phase 7 makes them at full width).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_torch.vector import vecenv as tvec
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek
from or_gym_inventory_tpu.ops import pallas_net_step as pns

CPU = "cpu"
STEPS, B = 10, 8
HALF_HI = 850.0


class _Cfg:
    activation = "tanh"
    normalize_obs = True


@pytest.fixture(scope="module")
def params():
    jp = jnet.default_params(num_periods=STEPS)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), STEPS,
                                       jp.backlog, jp.alpha)
    return jp, tp


@pytest.fixture(scope="module")
def model_and_rms(params):
    """A seeded actor-critic of the default widths, and obs statistics with
    mean ~50 and std ~20, so that the fold moves every weight."""
    _, tp = params
    g = torch.Generator().manual_seed(3)
    model = tnetworks.MLPActorCritic(tp.obs_dim, tp.topology.n_reorder,
                                     pi_arch=(32, 32), vf_arch=(32,), generator=g)
    with torch.no_grad():   # a mean head that moves the actions
        model.mean.weight.mul_(30.0)
    r = np.random.default_rng(3)
    rms = interop.rms_from_numpy(50.0 + r.normal(0, 5, tp.obs_dim),
                                 (20.0 + r.uniform(0, 5, tp.obs_dim)) ** 2, 1e3,
                                 device=CPU)
    return model, rms


@pytest.fixture(scope="module")
def actor(model_and_rms):
    model, rms = model_and_rms
    return tek.fold_actor_params(_Cfg, model, rms)


def _jax_actor(actor):
    Ws, bs = actor
    return (tuple(jnp.asarray(W.numpy()) for W in Ws),
            tuple(jnp.asarray(b.numpy()) for b in bs))


def _jax_chain(jp):
    """The JAX step chain over (T, rows, B) streams: per period the state's
    X, U and obs before the step, the fulfilled orders and the reward."""
    @jax.jit
    def run(actions, demands):
        def one_env(acts, dems):
            state, _ = jnet.reset(jp)

            def body(state, ad):
                obs = jnet._obs(jp, state)
                x, u = state.X, state.U
                state, ts = jnet.step_with_demand(jp, state, ad[0], ad[1])
                return state, (x, u, obs, ts.info["fulfilled_orders"], ts.reward)

            final, outs = jax.lax.scan(body, state, (acts, dems))
            return outs + (final.X, final.U, jnet._obs(jp, final))

        return jax.vmap(one_env, in_axes=(2, 2), out_axes=-1)(actions, demands)

    return run


@pytest.fixture(scope="module")
def chain(params):
    """The JAX step chain at (STEPS, rows, B), compiled once."""
    return _jax_chain(params[0])


@pytest.fixture(scope="module")
def k4(params, actor):
    _, tp = params
    return tns.rollout_traj_net(tp, actor, torch.full((11,), -0.5), 2024, B,
                                device=CPU)


def test_plain_k4_replays_through_jax(params, k4, chain):
    jp, _ = params
    acts = ((torch.tanh(k4["raw"]) + 1.0) * HALF_HI).numpy()
    dems = k4["demand"].numpy()
    x, u, _obs, r, rew, xT, uT, _ = chain(jnp.asarray(acts), jnp.asarray(dems))
    tol = dict(rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(x), k4["x"][:STEPS].numpy(), **tol)
    np.testing.assert_allclose(np.asarray(u), k4["u"][:STEPS].numpy(), **tol)
    np.testing.assert_allclose(np.asarray(xT), k4["x"][STEPS].numpy(), **tol)
    np.testing.assert_allclose(np.asarray(uT), k4["u"][STEPS].numpy(), **tol)
    np.testing.assert_allclose(np.asarray(r), k4["r"].numpy(), **tol)
    np.testing.assert_allclose(np.asarray(rew), k4["reward"].numpy(), **tol)
    kern = pns.episode_returns(jp, jnp.asarray(acts), jnp.asarray(dems), block=8,
                               interpret=True)
    np.testing.assert_allclose(np.asarray(kern), k4["reward"].sum(0).numpy(), **tol)
    # the policy's support and the demand's
    assert torch.equal(k4["demand"], k4["demand"].round())
    assert float(k4["r"].min()) >= 0


def test_assemble_obs_matches_jax(params, k4, chain):
    jp, tp = params
    mine = tnet.assemble_obs_from_streams(tp, k4["x"], k4["u"], k4["r"])
    ref = jnet.assemble_obs_from_streams(jp, jnp.asarray(k4["x"].numpy()),
                                         jnp.asarray(k4["u"].numpy()),
                                         jnp.asarray(k4["r"].numpy()))
    assert mine.shape == (STEPS + 1, B, tp.obs_dim)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    # and row t is the JAX env's own observation of the period-t state
    acts = (torch.tanh(k4["raw"]) + 1.0) * HALF_HI
    *_, obs, _r, _rew, _xT, _uT, obsT = chain(
        jnp.asarray(acts.numpy()), jnp.asarray(k4["demand"].numpy()))
    np.testing.assert_array_equal(mine[:STEPS].numpy(),
                                  np.asarray(obs).transpose(0, 2, 1))
    np.testing.assert_array_equal(mine[STEPS].numpy(), np.asarray(obsT).T)


def test_raw_is_jax_mean_plus_plain_noise(params, actor, k4):
    jp, tp = params
    T = tp.topology
    obs = jnet.assemble_obs_from_streams(jp, jnp.asarray(k4["x"].numpy()),
                                         jnp.asarray(k4["u"].numpy()),
                                         jnp.asarray(k4["r"].numpy()))
    mean = np.asarray(jek.folded_actor_mean(_jax_actor(actor), obs))[:STEPS]
    lanes = torch.arange(B)
    z = []
    for t in range(STEPS):
        w = rng.period_words(2024, lanes, 0, t, T.n_retail + 2 * T.n_reorder,
                             key1=rng.POLICY_KEY)[T.n_retail:]
        z.append(rng.normal01(torch.stack(w[:T.n_reorder]),
                              torch.stack(w[T.n_reorder:])))
    std = np.exp(-0.5)
    want = mean.transpose(0, 2, 1) + std * torch.stack(z).numpy()
    np.testing.assert_allclose(k4["raw"].numpy(), want, rtol=0, atol=1e-4)


def test_fold_matches_jax(params, model_and_rms):
    _, tp = params
    model, rms = model_and_rms
    Ws, bs = tek.fold_actor_params(_Cfg, model, rms)
    flax = {"params": {f"Dense_{i}": {"kernel": layer.weight.detach().numpy().T,
                                      "bias": layer.bias.detach().numpy()}
                       for i, layer in enumerate(list(model.pi) + [model.mean])}}

    class _Rms:
        mean = jnp.asarray(rms.mean.numpy())
        var = jnp.asarray(rms.var.numpy())

    jWs, jbs = jek.fold_actor_params(
        type("C", (), {"activation": "tanh", "normalize_obs": True,
                       "pi_arch": (32, 32)}), flax, _Rms)
    for a, b in zip(Ws + bs, jWs + jbs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    # and the unfolded actor on normalised obs is the folded one on raw obs
    obs = torch.from_numpy(np.random.default_rng(0).uniform(0, 100, (16, tp.obs_dim))
                           .astype(np.float32))
    with torch.no_grad():
        mean, _, _ = model(rms.normalize(obs))
    torch.testing.assert_close(tek.folded_actor_mean((Ws, bs), obs), mean,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stochastic", [False, True])
def test_plain_k6_actions_match_jax_folded_actor(params, actor, chain, stochastic):
    jp, tp = params
    E = 3
    log_std = torch.full((11,), -1.0) if stochastic else None
    ret, acts, dems = tns.sample_policy_streams_debug_net(
        tp, actor, 11, B, episodes_per_lane=E, log_std=log_std, device=CPU)
    assert ret.shape == (E, B) and acts.shape == (STEPS, E, 11, B)
    assert dems.shape == (STEPS, E, 1, B)
    # K5 gives the same returns, and K1 on K6's streams replays them
    assert torch.equal(ret, tns.episode_returns_net_policy(
        tp, actor, 11, B, episodes_per_lane=E, log_std=log_std, device=CPU))
    for e in range(E):
        torch.testing.assert_close(
            tns.episode_returns(tp, acts[:, e].contiguous(), dems[:, e].contiguous()),
            ret[e], rtol=0, atol=0)
    if stochastic:
        return
    # deterministic: the actions are the JAX folded actor on the JAX chain's obs
    e = 1
    *_, obs, _r, _rew, _xT, _uT, _ = chain(
        jnp.asarray(acts[:, e].numpy()), jnp.asarray(dems[:, e].numpy()))
    space = jnet.action_space(jp)
    obs = jnp.asarray(np.asarray(obs).transpose(0, 2, 1).reshape(-1, tp.obs_dim))
    want = jek.apply_folded_actor(_jax_actor(actor), obs, jnp.asarray(space.low),
                                  jnp.asarray(space.high), False)
    want = np.asarray(want).reshape(STEPS, B, 11).transpose(0, 2, 1)
    np.testing.assert_allclose(acts[:, e].numpy(), want, rtol=0, atol=1e-3)


def test_policy_episode_returns_runs_plain_k5(params, actor):
    _, tp = params
    for det, log_std in ((True, None), (False, torch.zeros(11))):
        out = tfe.policy_episode_returns(tp, actor, torch.Generator().manual_seed(5), 16,
                                         episodes_per_lane=2, deterministic=det,
                                         log_std=log_std, device=CPU)
        seed = tfe.kernel_seed(torch.Generator().manual_seed(5))
        ref = tns.episode_returns_net_policy(tp, actor, seed, 16, episodes_per_lane=2,
                                             log_std=log_std, device=CPU)
        assert out.shape == (32,) and torch.equal(out, ref.reshape(-1))
    det = tfe.policy_episode_returns(tp, actor, torch.Generator().manual_seed(5), 16,
                                     device=CPU)
    assert not torch.equal(det, out[:16])   # the noise changes the episodes
    with pytest.raises(ValueError, match="log_std"):
        tfe.policy_episode_returns(tp, actor, torch.Generator(), 4,
                                   deterministic=False, device=CPU)
    with pytest.raises(TypeError, match="Unknown params type"):
        tfe.policy_episode_returns(object(), actor, torch.Generator(), 4, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfe.policy_episode_returns(tp, actor, torch.Generator(), 4)


def test_policy_wrappers_refuse_what_is_not_ported(params, actor):
    _, tp = params
    # the off-policy heads are ported (K29): "det" and a relu trunk run, and
    # "sac" needs the 2 * n_ro outputs of mean and log_std
    for kw in (dict(policy="det"), dict(act_name="relu")):
        tr = tns.rollout_traj_net(tp, actor, torch.zeros(11), 1, 4, device=CPU, **kw)
        assert tr["raw"].shape == (STEPS, 11, 4)
    with pytest.raises(ValueError, match="obs_dim"):
        tns.rollout_traj_net(tp, actor, torch.zeros(11), 1, 4, policy="sac", device=CPU)
    Ws, bs = actor
    with pytest.raises(ValueError, match="obs_dim"):
        tns.episode_returns_net_policy(tp, (Ws[1:], bs[1:]), 1, 4, device=CPU)
    # the kernels' caps hold on the card only: the CPU takes any actor
    wide = (torch.zeros(68, 300), torch.zeros(300, 11)), (torch.zeros(300), torch.zeros(11))
    assert tns.episode_returns_net_policy(tp, wide, 1, 4, device=CPU).shape == (4,)
    # past MlpTile's 256 the card takes the general class (MlpTileG)
    st, _ = tns._pack_net_tile_actor(tp.topology, wide, None, CPU)
    assert isinstance(st, tek._MlpTileG) and st.lanes == 64 and st.ws_floats == 0
    # K4-K6's tile holds any actor within the width cap in a block's shared
    # memory (four hidden layers of 256: two buffers of 256 rows at 64 lanes)
    big = ((torch.zeros(68, 256),) + (torch.zeros(256, 256),) * 3 + (torch.zeros(256, 11),),
           (torch.zeros(256),) * 4 + (torch.zeros(11),))
    st, _ = tns._pack_net_tile_actor(tp.topology, big, None, CPU)
    assert st.lanes == 64 and st.s_total * 4 <= tek.SMEM_OPTIN_BYTES
    T = dataclasses.replace(tp.topology, rt_demand=(("hostfn", lambda **kw: 5, ()),))
    with pytest.raises(NotImplementedError, match="host callable"):
        tns.rollout_traj_net(tnet.NetInvParams(topology=T, num_periods=STEPS), actor,
                             torch.zeros(11), 1, 4, device=CPU)


def test_wrappers_on_cpu_count_no_launches(params, actor):
    _, tp = params
    counts = (tns.rollout_traj_net.launches, tns.episode_returns_net_policy.launches,
              tns.sample_policy_streams_debug_net.launches)
    tns.rollout_traj_net(tp, actor, torch.zeros(11), 1, 4, device=CPU)
    tns.episode_returns_net_policy(tp, actor, 1, 4, device=CPU)
    tns.sample_policy_streams_debug_net(tp, actor, 1, 4, device=CPU)
    assert counts == (tns.rollout_traj_net.launches,
                      tns.episode_returns_net_policy.launches,
                      tns.sample_policy_streams_debug_net.launches)


def test_policy_stream_differs_from_k2_stream_and_normals_are_normal():
    lanes = torch.arange(20000, dtype=torch.int64)
    w0 = rng.period_words(7, lanes, 0, 0, 4)
    w1 = rng.period_words(7, lanes, 0, 0, 4, key1=rng.POLICY_KEY)
    assert not torch.equal(w0[0], w1[0])
    z = rng.normal01(w1[1], w1[2]).double().numpy()
    assert stats.kstest(z, "norm").pvalue > 1e-4
    assert abs(z).max() <= np.sqrt(48 * np.log(2)) + 1e-5
    # episodes given as a tensor draw what one int episode at a time draws
    e = torch.tensor([0, 3, 3, 1])
    mixed = rng.period_words(7, lanes[:4], e, 2, 3, key1=1)
    for k in range(4):
        one = rng.period_words(7, lanes[k:k + 1], int(e[k]), 2, 3, key1=1)
        assert all(int(a[k]) == int(b[0]) for a, b in zip(mixed, one))


# ------------------------------------------------------- repairs of slice 1

def test_nan_action_propagates_through_plain_k1(params, chain):
    """A NaN action gives a NaN return in its lane only, as JAX's step does
    (jnp.maximum/minimum propagate NaN); the CUDA step keeps this with
    max_nan/min_nan (chip_smoke.py phase 7 holds K1 to it)."""
    jp, tp = params
    r = np.random.default_rng(2)
    acts = r.uniform(0, 150, (STEPS, 11, B)).astype(np.float32)
    dems = r.poisson(20.0, (STEPS, 1, B)).astype(np.float32)
    acts[3, 4, 5] = np.nan
    mine = tns.episode_returns(tp, torch.from_numpy(acts), torch.from_numpy(dems)).numpy()
    ref = np.asarray(chain(jnp.asarray(acts), jnp.asarray(dems))[4]).sum(0)
    assert np.isnan(mine[5]) and np.isnan(ref[5])
    assert np.isfinite(np.delete(mine, 5)).all()
    np.testing.assert_allclose(np.delete(mine, 5), np.delete(ref, 5), rtol=1e-5, atol=1e-3)


# (spec, mean, variance, kurtosis) of laws too wide for a 4,096-entry table
WIDE_SPECS = [
    (("poisson", 50000.0), 50000.0, 50000.0, 3.0),
    (("negbinomial", 40000.0, 0.5), 40000.0, 80000.0, 3.0),
    (("binomial", 1_000_000, 0.5), 500000.0, 250000.0, 3.0),
    (("randint", 0, 100_000), 49999.5, (100_000 ** 2 - 1) / 12, 1.8),
    (("geometric", 1e-4), 1e4, (1 - 1e-4) / 1e-8, 9.0),
    (("normal", 1e5, 1e4), 1e5, 1e8 + 1 / 12, 3.0),
]


@pytest.mark.parametrize("spec,mean,var,kurt", WIDE_SPECS, ids=[w[0][0] for w in WIDE_SPECS])
def test_sample_demand_draws_specs_beyond_the_table_cap(spec, mean, var, kurt):
    """Poisson(50,000) and the other named laws with wider support than the
    4,096-entry inversion table: the env draws them from the law, as the
    JAX env does; the kernels' plan still refuses them, and
    ``random_episode_returns`` runs them through the vecenv rollout, with a
    RuntimeWarning, as the JAX package runs its XLA rollout."""
    T = dataclasses.replace(ttopo.default_topology(6), rt_demand=(spec,))
    params = tnet.NetInvParams(topology=T, num_periods=6)
    n = 200_000
    d = tnet.sample_demand(params, torch.Generator().manual_seed(0), 0, n,
                           device=CPU)[:, 0].double().numpy()
    assert abs(d.mean() - mean) < 5 * np.sqrt(var / n)
    # the sample variance's standard error is var * sqrt((kurtosis - 1) / n)
    assert abs(d.var(ddof=1) - var) < 5 * var * np.sqrt((kurt - 1) / n)
    assert np.array_equal(d, np.round(d)) and d.min() >= 0
    with pytest.raises(NotImplementedError, match="cap"):
        tns._topology_link_specs(T, 6)
    with pytest.warns(RuntimeWarning, match="cap"):
        out = tfe.random_episode_returns(params, torch.Generator().manual_seed(1), 4,
                                         device=CPU)
    space = tnet.action_space(params)
    _, traj = tvec.rollout(tnet.ENV, params,
                           lambda _s, obs, g, _t: space.sample(g, (obs.shape[0],), device=CPU),
                           None, torch.Generator().manual_seed(1), 4, 6, device=CPU)
    assert out.shape == (4,) and torch.equal(out, traj.reward.sum(0))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _lane_share(got, want, rtol=1e-4, atol=1e-2):
    ok = (got - want).abs() <= atol + rtol * want.abs()
    return float(ok.reshape(-1, got.shape[-1]).all(0).float().mean())


@pytest.mark.cuda
def test_k4_matches_plain_on_cuda(params, actor, cuda):
    _, tp = params
    b = 3000   # not a multiple of the block: the tail is masked
    act = tuple(tuple(a.to(cuda) for a in x) for x in actor)
    log_std = torch.full((11,), -0.5, device=cuda)
    got = tns.rollout_traj_net(tp, act, log_std, 9, b, device=cuda)
    want = tns._rollout_traj_plain(tp, act, tek.clipped_std(log_std), 9, b, cuda)
    assert torch.equal(got["demand"], want["demand"])
    for k in got:
        assert _lane_share(got[k], want[k]) >= 0.99, k


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [False, True])
def test_k5_k6_match_plain_on_cuda(params, actor, cuda, stochastic):
    _, tp = params
    b, E = 3000, 4
    act = tuple(tuple(a.to(cuda) for a in x) for x in actor)
    log_std = torch.full((11,), -0.5, device=cuda) if stochastic else None
    k5 = tns.episode_returns_net_policy(tp, act, 9, b, episodes_per_lane=E,
                                        log_std=log_std, device=cuda)
    k6, acts, dems = tns.sample_policy_streams_debug_net(
        tp, act, 9, b, episodes_per_lane=E, log_std=log_std, device=cuda)
    std = None if log_std is None else tek.clipped_std(log_std)
    want, _, want_d = tns._policy_returns_plain(tp, act, std, 9, b, E, cuda, True)
    assert torch.equal(k5, k6) and torch.equal(dems, want_d)
    assert _lane_share(k5, want) >= 0.99
    for e in range(E):
        torch.testing.assert_close(
            tns.episode_returns(tp, acts[:, e].contiguous(), dems[:, e].contiguous()),
            k5[e], rtol=1e-5, atol=1e-3)
