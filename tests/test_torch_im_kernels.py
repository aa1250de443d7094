"""The InvManagement kernels' plain PyTorch versions (ops/episode_kernels.py
K7-K10) and the InvManagement branch of ``random_episode_returns`` against
the JAX package.

The JAX side runs on the CPU as its own tests run it: the Pallas stream-in
kernel ``episode_returns_im`` in interpret mode (as
tests/test_pallas_episode_kernels.py:191 does) and the XLA step chain
``_replay_chain`` of tests/test_kernel_rollout.py. The port's random streams
come from its Philox generator, so they are handed to JAX as NumPy arrays.
Tolerances:

- returns and rewards against JAX: ``rtol=1e-5, atol=1e-3`` (f32 profit
  sums in the same order, but XLA may contract a product and a sum into an
  FMA; the atol covers returns near 0);
- int32 state, streams and observations: exact;
- the helpers ``_im_step_math`` and ``_im_obs_rows`` on the same lists: int
  rows exact, profit ``rtol=1e-6``;
- plain K10's raws against JAX's folded actor on the chain's obs plus the
  plain normals: ``atol=1e-4`` (matmul sums in another order); its actions
  against JAX's cast of its own raws: at most 0.1% differ (an ulp of tanh at
  a truncation boundary);
- the draws: a chi-squared test per law at p > 1e-4;
- the port's random-policy mean against JAX's XLA path: within 4 standard
  errors of the difference.

Kernel-against-plain checks need the card; they are marked ``cuda`` and skip
without one (chip_smoke.py makes them at full width).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from test_kernel_rollout import _replay_chain
from test_torch_im_env import chi2_pvalue

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_torch.vector import vecenv as tvec
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek
from or_gym_inventory_tpu.vector import fast_episodes as jfe

CPU = "cpu"
STEPS, B = 10, 128


def _params(**kw):
    jp = jim.default_params(**dict(dict(periods=STEPS), **kw))
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


def _jax_k7(jp, acts, dems):
    """JAX ``episode_returns_im`` in interpret mode on (T, m1, B) and (T, B)
    int32 streams."""
    return np.asarray(jek.episode_returns_im(jp, jnp.asarray(np.asarray(acts)),
                                             jnp.asarray(np.asarray(dems)),
                                             block=B, interpret=True))


@pytest.mark.parametrize("kw", [dict(), dict(backlog=False), dict(L=(0, 5, 10))],
                         ids=["backlog", "lost_sales", "L0-5-10"])
def test_plain_k7_matches_jax_interpret(kw):
    jp, tp = _params(**kw)
    r = np.random.default_rng(2)
    c = np.asarray(tp.c)[None, :, None]
    acts = r.integers(-20, c + 30, (STEPS, tp.m1, B)).astype(np.int32)
    dems = r.poisson(20.0, (STEPS, B)).astype(np.int32)
    got = tek.episode_returns_im(tp, torch.from_numpy(acts), torch.from_numpy(dems))
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_k7(jp, acts, dems), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("E", [1, 4])
def test_plain_k9_through_jax_k7_equals_plain_k8(E):
    jp, tp = _params()
    acts, dems = tek.sample_streams_debug_im(tp, 31, B, episodes_per_lane=E, device=CPU)
    ret = tek.episode_returns_im_fused(tp, 31, B, episodes_per_lane=E, device=CPU)
    if E == 1:
        assert acts.shape == (STEPS, tp.m1, B) and dems.shape == (STEPS, B)
        acts, dems, ret = acts[:, None], dems[:, None], ret[None]
    assert acts.dtype == dems.dtype == torch.int32 and ret.shape == (E, B)
    for e in range(E):
        np.testing.assert_allclose(ret[e].numpy(), _jax_k7(jp, acts[:, e], dems[:, e]),
                                   rtol=1e-5, atol=1e-3)
        assert torch.equal(tek.episode_returns_im(tp, acts[:, e].contiguous(),
                                                  dems[:, e].contiguous()), ret[e])


def test_k7_random_on_k9_demand_equals_k8():
    _, tp = _params(backlog=False)
    _, dems = tek.sample_streams_debug_im(tp, 5, B, device=CPU)
    assert torch.equal(tek.episode_returns_im_random(tp, dems, 5),
                       tek.episode_returns_im_fused(tp, 5, B, device=CPU))


@pytest.mark.parametrize("backlog", [True, False])
def test_helpers_match_jax(backlog):
    jp, tp = _params(backlog=backlog, L=(0, 2, 3))
    m1, lt, n = tp.m1, tp.lt_max, 32
    r = np.random.default_rng(4)
    rows = lambda k, lo, hi: [r.integers(lo, hi, n).astype(np.int32) for _ in range(k)]  # noqa: E731
    for t in (0, 2, 7):
        inv, bkl = rows(m1, -30, 200), rows(m1 + 1, 0, 40)
        RH, act, d = rows(lt * m1, 0, 150), rows(m1, -10, 260), rows(1, 0, 60)[0]
        AH = rows(lt * m1, 0, 260)
        T = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
        J = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
        got = tek._im_step_math(tp, t, T(inv), T(bkl), T(RH), T(act), torch.from_numpy(d))
        want = jek._im_step_math(jp, t, J(inv), J(bkl), J(RH), J(act), jnp.asarray(d))
        for g, w in zip(got[:4], want[:4]):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-6)
        got = tek._im_obs_rows(tp, t, T(inv), T(AH))
        want = jek._im_obs_rows(jp, t, J(inv), J(AH))
        assert len(got) == len(want) == tp.pipeline_length
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _actor(tp, seed=3):
    """A seeded 32x32 actor whose mean head moves the actions, with obs
    statistics folded in."""
    g = torch.Generator().manual_seed(seed)
    D = tim.observation_space(tp).shape[0]
    model = tnetworks.MLPActorCritic(D, tp.m1, pi_arch=(32, 32), vf_arch=(32,), generator=g)
    with torch.no_grad():
        model.mean.weight.mul_(30.0)
    rms = interop.rms_from_numpy(np.full(D, 40.0), np.full(D, 900.0), 1e3, device=CPU)
    return tek.fold_actor_params(tppo.PPOConfig(), model, rms)


@pytest.mark.parametrize("kw", [dict(periods=12), dict(periods=12, backlog=False, L=(0, 5, 10))],
                         ids=["backlog", "lost_sales-L0"])
def test_plain_k10_replays_through_jax_chain(kw):
    jp, tp = _params(**kw)
    T, m1, n = tp.periods, tp.m1, 64
    actor = _actor(tp)
    log_std = torch.full((m1,), -0.7)
    tr = tek.rollout_traj_im(tp, actor, log_std, 2024, n, device=CPU)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tr.items()} == {
        "inv": ((T + 1, m1, n), torch.int32), "actions": ((T, m1, n), torch.int32),
        "raw": ((T, m1, n), torch.float32), "reward": ((T, n), torch.float32),
        "demand": ((T, n), torch.int32)}
    obs_all, rew, final_inv = _replay_chain(jp, tr["actions"].numpy(), tr["demand"].numpy())
    obs_all = np.asarray(obs_all)
    np.testing.assert_array_equal(tr["inv"][:T].numpy(), obs_all[:T, :, :m1].transpose(0, 2, 1))
    np.testing.assert_array_equal(tr["inv"][T].numpy(), np.asarray(final_inv))
    np.testing.assert_allclose(tr["reward"].numpy(), np.asarray(rew), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        tim.assemble_obs_from_streams(tp, tr["inv"], tr["actions"]).numpy(), obs_all)
    # the raws are JAX's folded actor on the chain's obs plus the plain normals
    lanes = torch.arange(n)
    z = torch.stack([rng.normal01(*(torch.stack(w) for w in (ws[1:1 + m1], ws[1 + m1:])))
                     for ws in (rng.period_words(2024, lanes, 0, t, 1 + 2 * m1,
                                                 key1=rng.POLICY_KEY) for t in range(T))])
    Ws, bs = actor
    jactor = (tuple(jnp.asarray(W.numpy()) for W in Ws), tuple(jnp.asarray(b.numpy()) for b in bs))
    mean = np.asarray(jek.folded_actor_mean(jactor, jnp.asarray(obs_all[:T])))
    want_raw = mean.transpose(0, 2, 1) + np.exp(-0.7).astype(np.float32) * z.numpy()
    np.testing.assert_allclose(tr["raw"].numpy(), want_raw, rtol=0, atol=1e-4)
    # and the actions are JAX's truncating cast of those raws
    half_c = jnp.asarray([0.5 * c for c in tp.c], jnp.float32)[None, :, None]
    want_a = np.asarray(((jnp.tanh(jnp.asarray(tr["raw"].numpy())) + 1.0) * half_c)
                        .astype(jnp.int32))
    assert np.mean(want_a != tr["actions"].numpy()) <= 1e-3
    assert tr["actions"].min() >= 0 and (tr["actions"] <= torch.tensor(tp.c)[:, None]).all()


def test_nan_raw_casts_to_zero_as_jax_does():
    assert int(jnp.asarray(jnp.nan, jnp.float32).astype(jnp.int32)) == 0
    assert tim.trunc_i32(torch.tensor([float("nan"), 2.9, -2.9, 3e9])).tolist() == \
        np.asarray(jnp.asarray([np.nan, 2.9, -2.9, 3e9], jnp.float32).astype(jnp.int32)).tolist()
    _, tp = _params()
    tr = tek.rollout_traj_im(tp, _actor(tp), torch.full((tp.m1,), float("nan")), 1, 8,
                             device=CPU)
    assert torch.isnan(tr["raw"]).all() and int(tr["actions"].abs().max()) == 0


DRAW_LAWS = [
    (dict(), lambda k: stats.poisson.pmf(k, 20)),
    (dict(dist=2, dist_param={"n": 30, "p": 0.4}), lambda k: stats.binom.pmf(k, 30, 0.4)),
    (dict(dist=3, dist_param={"low": 3, "high": 17}), lambda k: stats.randint.pmf(k, 3, 18)),
    (dict(dist=4, dist_param={"p": 0.3}), lambda k: stats.geom.pmf(k, 0.3)),
    (dict(dist=5, periods=4, user_D=(7, 0, 3, 11)), None),
]


@pytest.mark.parametrize("kw,pmf", DRAW_LAWS,
                         ids=["poisson", "binomial", "randint", "geometric", "user"])
def test_kernel_draws_follow_their_laws(kw, pmf):
    """Plain K9's demand follows each dist mode's law (USER mode: user_D[t]
    in every lane), and its actions are uniform on [0, c_i] inclusive."""
    _, tp = _params(**kw)
    acts, dems = tek.sample_streams_debug_im(tp, 77, 4096, device=CPU)
    if pmf is None:
        assert torch.equal(dems, torch.tensor(tp.user_D, dtype=torch.int32)[:, None]
                           .expand_as(dems))
    else:
        assert chi2_pvalue(dems.numpy().ravel().astype(np.int64), pmf) > 1e-4
    for i, c in enumerate(tp.c):
        a = acts[:, i].numpy().ravel()
        assert a.min() >= 0 and a.max() <= c
        counts = np.bincount(a, minlength=c + 1)
        assert stats.chisquare(counts).pvalue > 1e-4


@pytest.mark.parametrize("E", [1, 4])
def test_random_episode_returns_runs_plain_k8(E):
    _, tp = _params()
    out = tfe.random_episode_returns(tp, torch.Generator().manual_seed(0), 32,
                                     episodes_per_lane=E, device=CPU)
    assert out.shape == (E * 32,) and out.dtype == torch.float32
    seed = tfe.kernel_seed(torch.Generator().manual_seed(0))
    ref = tek.episode_returns_im_fused(tp, seed, 32, episodes_per_lane=E, device=CPU)
    assert torch.equal(out, ref.reshape(-1))


def test_random_mean_matches_jax_xla_path():
    n = 2048
    mine = tfe.random_episode_returns(tim.default_params(), torch.Generator().manual_seed(3),
                                      n, device=CPU).double().numpy()
    ref = np.asarray(jfe.random_episode_returns(jim.default_params(), jax.random.PRNGKey(3),
                                                n, use_pallas=False), np.float64)
    se = np.sqrt(mine.var(ddof=1) / n + ref.var(ddof=1) / n)
    assert abs(mine.mean() - ref.mean()) < 4 * se, (mine.mean(), ref.mean(), se)


def test_wrappers_check_inputs_and_count_no_launches_on_cpu():
    _, tp = _params()
    wrappers = (tek.episode_returns_im, tek.episode_returns_im_random,
                tek.episode_returns_im_fused, tek.sample_streams_debug_im,
                tek.rollout_traj_im)
    counts = [w.launches for w in wrappers]
    acts, dems = tek.sample_streams_debug_im(tp, 1, 8, device=CPU)
    tek.episode_returns_im(tp, acts, dems)
    tek.episode_returns_im_random(tp, dems, 1)
    tek.episode_returns_im_fused(tp, 1, 8, device=CPU)
    tek.rollout_traj_im(tp, _actor(tp), torch.zeros(3), 1, 8, device=CPU)
    assert counts == [w.launches for w in wrappers]
    with pytest.raises(TypeError, match="int32"):
        tek.episode_returns_im(tp, acts.float(), dems)
    with pytest.raises(ValueError, match="expected"):
        tek.episode_returns_im(tp, acts[:-1], dems[:-1])
    with pytest.raises(ValueError, match="episodes_per_lane"):
        tek.episode_returns_im_fused(tp, 1, 8, episodes_per_lane=0, device=CPU)
    # the off-policy heads are ported (K27): "sac" needs the 2 * m1 outputs of
    # mean and log_std, and the PPO head runs on a relu trunk too
    with pytest.raises(ValueError, match="obs_dim"):
        tek.rollout_traj_im(tp, _actor(tp), torch.zeros(3), 1, 4, policy="sac", device=CPU)
    relu = tek.rollout_traj_im(tp, _actor(tp), torch.zeros(3), 1, 4, act_name="relu",
                               device=CPU)
    assert relu["raw"].shape == (tp.periods, 3, 4) and counts == [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="obs_dim"):
        Ws, bs = _actor(tp)
        tek.rollout_traj_im(tp, (Ws[1:], bs[1:]), torch.zeros(3), 1, 4, device=CPU)
    # nine stocked stages take the chain route (ImParamsG); a lane's state
    # past a block of 32 lanes is refused, naming the words
    assert tek._im_plan(tim.default_params(I0=(1,) * 9, r=(1.0,) * 10, k=(0.0,) * 10,
                                           h=(0.0,) * 9, c=(5,) * 9, L=(1,) * 9), CPU)["chain"]
    with pytest.raises(ValueError, match="words a lane"):
        tek._im_plan(tim.default_params(I0=(1,) * 9, r=(1.0,) * 10, k=(0.0,) * 10,
                                        h=(0.0,) * 9, c=(5,) * 9, L=(120,) * 9), CPU)
    # a law past the inversion table's cap runs the vecenv rollout, with a
    # RuntimeWarning, as the JAX package runs its XLA rollout
    wide = tim.default_params(periods=STEPS, dist_param={"mu": 50_000})
    with pytest.warns(RuntimeWarning, match="cap"):
        out = tfe.random_episode_returns(wide, torch.Generator().manual_seed(3), 4,
                                         episodes_per_lane=2, device=CPU)
    space = tim.action_space(wide)
    _, traj = tvec.rollout(tim.ENV, wide,
                           lambda _s, obs, g, _t: space.sample(g, (obs.shape[0],), device=CPU),
                           None, torch.Generator().manual_seed(3), 8, STEPS, device=CPU)
    assert out.shape == (8,) and torch.equal(out, traj.reward.sum(0))
    assert counts == [w.launches for w in wrappers]
    # the stream-in kernel takes any law: it reads no table
    tek.episode_returns_im(wide, acts, dems)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfe.random_episode_returns(tp, torch.Generator(), 4)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backlog", [True, False])
def test_k7_to_k10_match_plain_on_cuda(backlog, cuda):
    _, tp = _params(backlog=backlog, periods=30)
    b, E = 3000, 3   # not a multiple of the block: the tail is masked
    acts, dems = tek.sample_streams_debug_im(tp, 9, b, episodes_per_lane=E, device=cuda)
    pa, pd = tek._im_fused_plain(tp, 9, b, E, cuda, dump=True)
    assert torch.equal(acts, pa) and torch.equal(dems, pd)
    k8 = tek.episode_returns_im_fused(tp, 9, b, episodes_per_lane=E, device=cuda)
    torch.testing.assert_close(k8, tek._im_fused_plain(tp, 9, b, E, cuda), rtol=1e-5, atol=1e-3)
    k7 = tek.episode_returns_im(tp, acts[:, 1].contiguous(), dems[:, 1].contiguous())
    torch.testing.assert_close(k7, k8[1], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(tek.episode_returns_im_random(tp, dems[:, 0].contiguous(), 9),
                               k8[0], rtol=1e-5, atol=1e-3)
    actor = tuple(tuple(a.to(cuda) for a in x) for x in _actor(tp))
    log_std = torch.full((tp.m1,), -0.5, device=cuda)
    got = tek.rollout_traj_im(tp, actor, log_std, 9, b, device=cuda)
    want = tek._rollout_traj_im_plain(tp, actor, tek.clipped_std(log_std), 9, b, cuda)
    assert torch.equal(got["demand"], want["demand"])
    for k in got:
        ok = (got[k].double() - want[k].double()).abs() <= 1e-2 + 1e-4 * want[k].double().abs()
        assert float(ok.reshape(-1, b).all(0).double().mean()) >= 0.99, k
