"""The Newsvendor policy kernels' plain PyTorch versions
(ops/episode_kernels.py K18 ``rollout_traj_nv``, K19
``episode_returns_nv_policy``, K20 ``sample_policy_streams_debug_nv`` and
K21 ``sample_normals_debug``) and the Newsvendor branch of
``policy_episode_returns``, against the JAX package.

The JAX side runs on the CPU as its own tests run it: the Pallas stream-in
kernel ``episode_returns_nv`` in interpret mode, the vmapped XLA
``newsvendor.step_with_demand`` chain, ``assemble_obs_from_streams`` and
the folded actor of ``pallas_episode_kernels.apply_folded_actor``. The
port's random streams come from its Philox generator, so they are handed to
JAX as NumPy arrays. Tolerances:

- returns against JAX's K13 on the dumped streams: ``rtol=1e-5, atol=1e-2``,
  as tests/test_torch_nv_kernels.py holds K16 (f32 sums; XLA may contract a
  product and a sum into an FMA);
- deterministic orders against JAX's folded actor on the chain's obs: at
  least 99.9% of (period, lane) within ``rtol=1e-4, atol=1e-2`` (the MLP sums
  in another order);
- K18's rewards and capped orders against the JAX chain on its squashed raws
  and demand: at least 99.5% of entries within ``rtol=1e-3, atol=2.0``, the
  rule of tests/test_kernel_rollout.py:411 (tanh ulps compound through the
  pipeline); the assembled obs exactly;
- K18's raws against the folded actor mean on the assembled obs plus std
  times the plain normals: ``atol=1e-4`` (matmul sums in another order);
- plain K19's stochastic episode 0 against plain K18 on the same seed: bit
  for bit (the same words, the same arithmetic in the same order);
- K21's normals: the moments, tail cap and KS bounds of
  tests/test_pallas_policy.py:394-419.

Kernel-against-plain checks need the card; they are marked ``cuda`` and skip
without one (chip_smoke.py makes them at full width).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
STEPS, B = 10, 128
LOG_STD = torch.tensor([-0.5])


def _params(**kw):
    jp = jnv.default_params(**dict(dict(step_limit=STEPS), **kw))
    return jp, tnv.NewsvendorParams(**dataclasses.asdict(jp))


def _actor(tp, seed=3):
    """A seeded 16x16 actor whose mean head moves the orders across their
    range, with obs statistics folded in."""
    g = torch.Generator().manual_seed(seed)
    model = tnetworks.MLPActorCritic(tp.obs_dim, 1, pi_arch=(16, 16), vf_arch=(16,),
                                     generator=g)
    with torch.no_grad():
        model.mean.weight.mul_(3.0)
    rms = interop.rms_from_numpy(np.full(tp.obs_dim, 40.0), np.full(tp.obs_dim, 900.0), 1e3,
                                 device=CPU)
    return tek.fold_actor_params(tppo.PPOConfig(), model, rms)


def _jax_actor(actor):
    Ws, bs = actor
    return (tuple(jnp.asarray(W.numpy()) for W in Ws), tuple(jnp.asarray(b.numpy()) for b in bs))


def _jax_k13(jp, econ, acts, dems):
    return np.asarray(jek.episode_returns_nv(
        jp, jnp.asarray(np.asarray(econ)), jnp.asarray(np.asarray(acts)),
        jnp.asarray(np.asarray(dems)), block=econ.shape[1], interpret=True))


def _jax_chain(jp, econ, acts, dems):
    """The vmapped JAX step chain from ``econ`` (5, n) on the orders and
    demand (T, n): (obs (T+1, n, D), rewards (T, n))."""
    jstate, jts = jax.vmap(lambda e: jnv.reset_with_econ(jp, e), in_axes=1)(jnp.asarray(econ))
    step = jax.jit(jax.vmap(jnv.step_with_demand, in_axes=(None, 0, 0, 0)), static_argnums=0)
    obs, rews = [np.asarray(jts.obs)], []
    for t in range(jp.step_limit):
        jstate, jts = step(jp, jstate, jnp.asarray(acts[t])[:, None], jnp.asarray(dems[t]))
        obs.append(np.asarray(jts.obs))
        rews.append(np.asarray(jts.reward))
    return np.stack(obs), np.stack(rews)


@pytest.mark.parametrize("gamma", [1.0, 0.99])
@pytest.mark.parametrize("L", [5, 0])
@pytest.mark.parametrize("E", [1, 4])
@pytest.mark.parametrize("log_std", [None, LOG_STD], ids=["det", "stoch"])
def test_plain_k20_streams_through_jax_k13_give_plain_k19(log_std, E, L, gamma):
    jp, tp = _params(lead_time=L, gamma=gamma)
    actor = _actor(tp)
    ret, econ, acts, dems = tek.sample_policy_streams_debug_nv(
        tp, actor, 17, B, episodes_per_lane=E, log_std=log_std, device=CPU)
    k19 = tek.episode_returns_nv_policy(tp, actor, 17, B, episodes_per_lane=E,
                                        log_std=log_std, device=CPU)
    assert econ.shape == (E, 5, B) and acts.shape == dems.shape == (STEPS, E, B)
    assert all(x.dtype == torch.float32 for x in (ret, econ, acts, dems, k19))
    assert k19.shape == ((B,) if E == 1 else (E, B)) and torch.equal(ret, k19)
    # every episode's lanes side by side: one interpret call for all of them
    want = _jax_k13(jp, econ.permute(1, 0, 2).reshape(5, E * B), acts.reshape(STEPS, E * B),
                    dems.reshape(STEPS, E * B))
    np.testing.assert_allclose(k19.reshape(-1).numpy(), want, rtol=1e-5, atol=1e-2)
    assert float(acts.min()) >= 0 and float(acts.max()) <= tp.max_order_quantity
    assert float(acts.std()) > 10.0   # the actor moves the orders


@pytest.mark.parametrize("L", [5, 0])
def test_plain_k19_orders_are_jax_folded_actor_on_the_chain(L):
    jp, tp = _params(lead_time=L)
    actor = _actor(tp)
    n = 512
    _, econ, acts, dems = tek.sample_policy_streams_debug_nv(tp, actor, 99, n, device=CPU)
    econ, acts, dems = econ[0].numpy(), acts[:, 0].numpy(), dems[:, 0].numpy()
    obs, _ = _jax_chain(jp, econ, acts, dems)
    jactor = _jax_actor(actor)
    want = np.stack([np.asarray(jek.apply_folded_actor(
        jactor, jnp.asarray(obs[t]), jnp.zeros(1), jnp.full(1, tp.max_order_quantity),
        False))[:, 0] for t in range(STEPS)])   # (T, n)
    agree = np.isclose(acts, want, rtol=1e-4, atol=1e-2)
    assert agree.mean() >= 0.999, agree.mean()


@pytest.mark.parametrize("gamma", [1.0, 0.99])
@pytest.mark.parametrize("L", [5, 0])
def test_plain_k18_replays_through_the_jax_chain(L, gamma):
    jp, tp = _params(lead_time=L, gamma=gamma)
    actor = _actor(tp)
    n = 1024
    tr = tek.rollout_traj_nv(tp, actor, LOG_STD, 17, n, device=CPU)
    assert tr["econ"].shape == (5, n) and tr["raw"].shape == (STEPS, 1, n)
    assert all(tr[k].shape == (STEPS, n) for k in ("orders", "reward", "demand"))
    hi = np.float32(0.5 * tp.max_order_quantity)
    acts = (np.tanh(tr["raw"][:, 0].numpy()) + np.float32(1.0)) * hi
    obs, rew = _jax_chain(jp, tr["econ"].numpy(), acts, tr["demand"].numpy())
    close_r = np.isclose(tr["reward"].numpy(), rew, rtol=1e-3, atol=2.0)
    assert close_r.mean() > 0.995, close_r.mean()
    got_obs = tnv.assemble_obs_from_streams(tp, tr["econ"], tr["orders"])
    want_obs = jnv.assemble_obs_from_streams(jp, jnp.asarray(tr["econ"].numpy()),
                                             jnp.asarray(tr["orders"].numpy()))
    np.testing.assert_array_equal(got_obs.numpy(), np.asarray(want_obs))
    if L:
        close_o = np.isclose(tr["orders"].numpy(), obs[1:, :, 5 + L - 1], rtol=1e-3, atol=2.0)
        assert close_o.mean() > 0.995, close_o.mean()
    else:   # no pipeline in the obs: the capped order is the clipped one
        np.testing.assert_allclose(tr["orders"].numpy(), acts, rtol=1e-6, atol=1e-3)
    assert acts.std(axis=-1).mean() > 0   # exploration noise is live


@pytest.mark.parametrize("L", [5, 0])
def test_plain_k18_raws_are_the_folded_actor_plus_the_normals(L):
    _, tp = _params(lead_time=L)
    actor = _actor(tp)
    n = 256
    tr = tek.rollout_traj_nv(tp, actor, LOG_STD, 4, n, device=CPU)
    obs = tnv.assemble_obs_from_streams(tp, tr["econ"], tr["orders"])
    lanes = torch.arange(n, dtype=torch.int64)
    std = tek.clipped_std(LOG_STD)
    for t in range(STEPS):
        w = rng.period_words(4, lanes, 0, t, 3, key1=rng.POLICY_KEY)
        want = tek.folded_actor_mean(actor, obs[t])[:, 0] + std[0, 0] * rng.normal01(w[1], w[2])
        np.testing.assert_allclose(tr["raw"][t, 0].numpy(), want.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("L", [5, 0])
@pytest.mark.parametrize("gamma", [1.0, 0.99])
def test_stochastic_k19_episode_0_is_k18(gamma, L):
    _, tp = _params(lead_time=L, gamma=gamma)
    actor = _actor(tp)
    ret, econ, acts, dems = tek.sample_policy_streams_debug_nv(
        tp, actor, 2024, 64, episodes_per_lane=3, log_std=LOG_STD, device=CPU)
    tr = tek.rollout_traj_nv(tp, actor, LOG_STD, 2024, 64, device=CPU)
    assert torch.equal(econ[0], tr["econ"]) and torch.equal(dems[:, 0], tr["demand"])
    disc = tek._discounts(tp.gamma, STEPS)
    want = functools.reduce(lambda acc, t: acc + disc[t] * tr["reward"][t], range(STEPS),
                            torch.zeros(64))
    assert torch.equal(ret[0], want)
    assert not torch.equal(ret[1], ret[0])   # episodes draw their own words


def test_plain_k21_normals_pass_the_goodness_of_fit_pin():
    z = tek.sample_normals_debug(3, 64, 16384, device=CPU)
    assert z.shape == (64, 16384) and z.dtype == torch.float32
    z = z.double().numpy().ravel()
    n = z.size
    assert abs(z.mean()) < 5.0 / math.sqrt(n)
    assert abs(z.std() - 1.0) < 0.005
    assert abs(((z - z.mean()) ** 3).mean()) < 0.02
    assert abs(((z - z.mean()) ** 4).mean() - 3.0) < 0.06
    assert np.abs(z).max() <= math.sqrt(48 * math.log(2)) + 1e-3
    zs = np.sort(z)
    cdf = 0.5 * (1.0 + special.erf(zs / math.sqrt(2.0)))
    ks = max(np.abs(np.arange(1, n + 1) / n - cdf).max(), np.abs(np.arange(n) / n - cdf).max())
    assert ks < 0.006, ks
    # the stream the stochastic kernels draw from: normal01 of two words
    lanes = torch.arange(8, dtype=torch.int64)
    w = rng.period_words(3, lanes, 0, 5, 2, key1=rng.POLICY_KEY)
    assert torch.equal(tek.sample_normals_debug(3, 6, 8, device=CPU)[5], rng.normal01(*w))


@pytest.mark.parametrize("L", [5, 0])
def test_nan_std_gives_nan_orders_and_keeps_the_draws(L):
    _, tp = _params(lead_time=L)
    actor = _actor(tp)
    nan = torch.tensor([float("nan")])
    tr = tek.rollout_traj_nv(tp, actor, nan, 6, 32, device=CPU)
    ok = tek.rollout_traj_nv(tp, actor, LOG_STD, 6, 32, device=CPU)
    assert torch.isnan(tr["raw"]).all() and torch.isnan(tr["reward"]).all()
    assert torch.equal(tr["econ"], ok["econ"]) and torch.equal(tr["demand"], ok["demand"])
    ret, econ, acts, dems = tek.sample_policy_streams_debug_nv(tp, actor, 6, 32, log_std=nan,
                                                               device=CPU)
    assert torch.isnan(ret).all() and torch.isnan(acts).all()
    assert torch.isfinite(econ).all() and torch.isfinite(dems).all()


def test_policy_episode_returns_runs_plain_k19():
    _, tp = _params()
    actor = _actor(tp)
    for det, log_std in ((True, None), (False, LOG_STD)):
        out = tfe.policy_episode_returns(tp, actor, torch.Generator().manual_seed(5), 16,
                                         episodes_per_lane=2, deterministic=det,
                                         log_std=log_std, device=CPU)
        seed = tfe.kernel_seed(torch.Generator().manual_seed(5))
        ref = tek.episode_returns_nv_policy(tp, actor, seed, 16, episodes_per_lane=2,
                                            log_std=None if det else log_std, device=CPU)
        assert out.shape == (32,) and torch.isfinite(out).all()
        assert torch.equal(out, ref.reshape(-1))
    with pytest.raises(ValueError, match="log_std"):
        tfe.policy_episode_returns(tp, actor, torch.Generator(), 4, deterministic=False,
                                   device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfe.policy_episode_returns(tp, actor, torch.Generator(), 4)


def test_policy_wrappers_check_inputs_and_count_no_launches_on_cpu():
    _, tp = _params()
    actor = _actor(tp)
    wrappers = (tek.rollout_traj_nv, tek.episode_returns_nv_policy,
                tek.sample_policy_streams_debug_nv, tek.sample_normals_debug)
    counts = [w.launches for w in wrappers]
    tek.rollout_traj_nv(tp, actor, LOG_STD, 1, 8, device=CPU)
    tek.episode_returns_nv_policy(tp, actor, 1, 8, device=CPU)
    tek.sample_policy_streams_debug_nv(tp, actor, 1, 8, log_std=LOG_STD, device=CPU)
    tek.sample_normals_debug(1, 2, 8, device=CPU)
    assert counts == [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="episodes_per_lane"):
        tek.episode_returns_nv_policy(tp, actor, 1, 8, episodes_per_lane=0, device=CPU)
    with pytest.raises(ValueError, match="batch"):
        tek.rollout_traj_nv(tp, actor, LOG_STD, 1, 0, device=CPU)
    with pytest.raises(ValueError, match="rows"):
        tek.sample_normals_debug(1, 0, 8, device=CPU)
    with pytest.raises(ValueError, match="log_std"):
        tek.rollout_traj_nv(tp, actor, None, 1, 8, device=CPU)
    Ws, bs = actor
    with pytest.raises(ValueError, match="obs_dim"):
        tek.episode_returns_nv_policy(tp, (Ws[1:], bs[1:]), 1, 4, device=CPU)
    _, tp0 = _params(lead_time=0)
    with pytest.raises(ValueError, match="obs_dim"):
        tek.rollout_traj_nv(tp0, actor, LOG_STD, 1, 4, device=CPU)
    # the off-policy heads are ported (K28): "sac" needs the mean and log_std
    # outputs, two for the one order
    with pytest.raises(ValueError, match="obs_dim"):
        tek.rollout_traj_nv(tp, actor, LOG_STD, 1, 4, policy="sac", device=CPU)
    for fn in (tek.rollout_traj_nv, tek.episode_returns_nv_policy,
               tek.sample_policy_streams_debug_nv, tek.sample_normals_debug):
        assert not {"block", "interpret", "precision", "demand_chunk"} & set(
            fn.__code__.co_varnames[:fn.__code__.co_argcount])


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [5, 0])
def test_k18_to_k21_match_plain_on_cuda(L, cuda):
    _, tp = _params(lead_time=L, step_limit=50, gamma=0.99)
    b, E = 3000, 3   # not a multiple of the block: the tail is masked
    actor = tuple(tuple(a.to(cuda) for a in x) for x in _actor(tp))
    log_std = LOG_STD.to(cuda)
    std = tek.clipped_std(log_std)
    tr = tek.rollout_traj_nv(tp, actor, log_std, 9, b, device=cuda)
    want = tek._rollout_traj_nv_plain(tp, actor, std, 9, b, cuda)
    assert torch.equal(tr["econ"], want["econ"]) and torch.equal(tr["demand"], want["demand"])
    for k in ("orders", "raw", "reward"):
        ok = ((tr[k].double() - want[k].double()).abs()
              <= 1e-2 + 1e-4 * want[k].double().abs()).reshape(-1, b).all(0)
        assert float(ok.double().mean()) >= 0.99, k
    for ls in (None, log_std):
        ret, econ, acts, dems = tek.sample_policy_streams_debug_nv(
            tp, actor, 9, b, episodes_per_lane=E, log_std=ls, device=cuda)
        pr, pe, _, pd = tek._nv_policy_plain(tp, actor, None if ls is None else std, 9, b, E,
                                             cuda, True)
        assert torch.equal(econ, pe) and torch.equal(dems, pd)
        ok = (ret.double() - pr.double()).abs() <= 1e-2 + 1e-4 * pr.double().abs()
        assert float(ok.double().mean()) >= 0.99
        k19 = tek.episode_returns_nv_policy(tp, actor, 9, b, episodes_per_lane=E, log_std=ls,
                                            device=cuda)
        torch.testing.assert_close(k19, ret, rtol=0, atol=0)
    z = tek.sample_normals_debug(9, 8, b, device=cuda)
    torch.testing.assert_close(z, tek._sample_normals_plain(9, 8, b, cuda), rtol=0, atol=1e-5)
