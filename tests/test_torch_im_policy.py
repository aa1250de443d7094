"""The InvManagement learned-policy kernels' plain PyTorch versions
(ops/episode_kernels.py K11 ``episode_returns_im_policy`` and K12
``sample_policy_streams_debug_im``) and the InvManagement branch of
``policy_episode_returns``, against the JAX package.

The JAX side runs on the CPU as its own tests run it: the Pallas stream-in
kernel ``episode_returns_im`` in interpret mode and the XLA step chain
``_replay_chain`` of tests/test_kernel_rollout.py, with the folded actor of
``pallas_episode_kernels.apply_folded_actor``. The port's random streams come
from its Philox generator, so they are handed to JAX as NumPy arrays.
Tolerances:

- returns against JAX's K7 on the same streams: ``rtol=1e-5, atol=1e-3``
  (f32 profit sums in the same order; XLA may contract a product and a sum
  into an FMA; the atol covers returns near 0);
- deterministic actions against JAX's folded actor on the chain's obs: at
  least 99.9% of lanes agree in every action of the episode (the MLP sums in
  another order, so a product on a truncation boundary may take the other
  integer);
- plain K11's episode 0 against plain K10 on the same seed: bit for bit
  (the same words, the same arithmetic in the same order).

Kernel-against-plain checks need the card; they are marked ``cuda`` and skip
without one (chip_smoke.py makes them at full width).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernel_rollout import _replay_chain

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
STEPS, B = 12, 128


def _params(**kw):
    jp = jim.default_params(**dict(dict(periods=STEPS), **kw))
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


def _actor(tp, seed=3):
    """A seeded 16x16 actor whose mean head moves the actions, with obs
    statistics folded in."""
    g = torch.Generator().manual_seed(seed)
    D = tim.observation_space(tp).shape[0]
    model = tnetworks.MLPActorCritic(D, tp.m1, pi_arch=(16, 16), vf_arch=(16,), generator=g)
    with torch.no_grad():
        model.mean.weight.mul_(30.0)
    rms = interop.rms_from_numpy(np.full(D, 40.0), np.full(D, 900.0), 1e3, device=CPU)
    return tek.fold_actor_params(tppo.PPOConfig(), model, rms)


def _jax_k7(jp, acts, dems):
    return np.asarray(jek.episode_returns_im(jp, jnp.asarray(np.asarray(acts)),
                                             jnp.asarray(np.asarray(dems)),
                                             block=B, interpret=True))


LOG_STD = torch.full((3,), -0.7)


@pytest.mark.parametrize("E", [1, 4])
@pytest.mark.parametrize("backlog", [True, False], ids=["backlog", "lost_sales"])
@pytest.mark.parametrize("log_std", [None, LOG_STD], ids=["det", "stoch"])
def test_plain_k12_streams_through_jax_k7_give_plain_k11(E, backlog, log_std):
    jp, tp = _params(backlog=backlog)
    actor = _actor(tp)
    ret, acts, dems = tek.sample_policy_streams_debug_im(tp, actor, 17, B,
                                                         episodes_per_lane=E,
                                                         log_std=log_std, device=CPU)
    k11 = tek.episode_returns_im_policy(tp, actor, 17, B, episodes_per_lane=E,
                                        log_std=log_std, device=CPU)
    assert acts.shape == (STEPS, E, tp.m1, B) and dems.shape == (STEPS, E, B)
    assert acts.dtype == dems.dtype == torch.int32 and k11.dtype == torch.float32
    assert k11.shape == ((B,) if E == 1 else (E, B)) and torch.equal(ret, k11)
    k11 = k11.reshape(E, B)
    for e in range(E):
        np.testing.assert_allclose(k11[e].numpy(), _jax_k7(jp, acts[:, e], dems[:, e]),
                                   rtol=1e-5, atol=1e-3)
    assert int(acts.min()) >= 0 and (acts <= torch.tensor(tp.c)[:, None]).all()


@pytest.mark.parametrize("kw", [dict(), dict(backlog=False, L=(0, 5, 10))],
                         ids=["backlog", "lost_sales-L0"])
def test_plain_k11_actions_are_jax_folded_actor_on_the_chain(kw):
    jp, tp = _params(**kw)
    actor = _actor(tp)
    n = 512
    _, acts, dems = tek.sample_policy_streams_debug_im(tp, actor, 99, n, device=CPU)
    acts, dems = acts[:, 0].numpy(), dems[:, 0].numpy()
    obs_all, _, _ = _replay_chain(jp, acts, dems)
    Ws, bs = actor
    jactor = (tuple(jnp.asarray(W.numpy()) for W in Ws), tuple(jnp.asarray(b.numpy()) for b in bs))
    want = np.stack([np.asarray(jek.apply_folded_actor(
        jactor, jnp.asarray(np.asarray(obs_all)[t]), jnp.zeros(tp.m1),
        jnp.asarray(tp.c, jnp.float32), True)) for t in range(STEPS)])   # (T, n, m1)
    agree = (want.transpose(0, 2, 1) == acts).all(axis=(0, 1))
    assert agree.mean() >= 0.999, agree.mean()
    assert len(np.unique(acts)) > 10   # the actor moves the actions


@pytest.mark.parametrize("backlog", [True, False], ids=["backlog", "lost_sales"])
def test_stochastic_k11_episode_0_is_k10(backlog):
    _, tp = _params(backlog=backlog)
    actor = _actor(tp)
    ret, acts, dems = tek.sample_policy_streams_debug_im(tp, actor, 2024, 64,
                                                         episodes_per_lane=3,
                                                         log_std=LOG_STD, device=CPU)
    tr = tek.rollout_traj_im(tp, actor, LOG_STD, 2024, 64, device=CPU)
    assert torch.equal(dems[:, 0], tr["demand"]) and torch.equal(acts[:, 0], tr["actions"])
    assert torch.equal(ret[0], functools.reduce(torch.add, tr["reward"]))
    assert not torch.equal(ret[1], ret[0])   # episodes draw their own words


def test_policy_episode_returns_runs_plain_k11():
    _, tp = _params()
    actor = _actor(tp)
    for det, log_std in ((True, None), (False, LOG_STD)):
        out = tfe.policy_episode_returns(tp, actor, torch.Generator().manual_seed(5), 16,
                                         episodes_per_lane=2, deterministic=det,
                                         log_std=log_std, device=CPU)
        seed = tfe.kernel_seed(torch.Generator().manual_seed(5))
        ref = tek.episode_returns_im_policy(tp, actor, seed, 16, episodes_per_lane=2,
                                            log_std=None if det else log_std, device=CPU)
        assert out.shape == (32,) and torch.equal(out, ref.reshape(-1))
    # deterministic ignores a log_std it is given
    det = tfe.policy_episode_returns(tp, actor, torch.Generator().manual_seed(5), 16,
                                     episodes_per_lane=2, log_std=LOG_STD, device=CPU)
    assert torch.equal(det, tek.episode_returns_im_policy(
        tp, actor, seed, 16, episodes_per_lane=2, device=CPU).reshape(-1))
    with pytest.raises(ValueError, match="log_std"):
        tfe.policy_episode_returns(tp, actor, torch.Generator(), 4, deterministic=False,
                                   device=CPU)
    wide = tim.default_params(periods=STEPS, dist_param={"mu": 50_000})
    with pytest.raises(NotImplementedError, match="cap"):
        tfe.policy_episode_returns(wide, actor, torch.Generator(), 4, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfe.policy_episode_returns(tp, actor, torch.Generator(), 4)


def test_policy_wrappers_check_inputs_and_count_no_launches_on_cpu():
    _, tp = _params()
    actor = _actor(tp)
    wrappers = (tek.episode_returns_im_policy, tek.sample_policy_streams_debug_im)
    counts = [w.launches for w in wrappers]
    tek.episode_returns_im_policy(tp, actor, 1, 8, device=CPU)
    tek.sample_policy_streams_debug_im(tp, actor, 1, 8, log_std=LOG_STD, device=CPU)
    assert counts == [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="episodes_per_lane"):
        tek.episode_returns_im_policy(tp, actor, 1, 8, episodes_per_lane=0, device=CPU)
    Ws, bs = actor
    with pytest.raises(ValueError, match="obs_dim"):
        tek.episode_returns_im_policy(tp, (Ws[1:], bs[1:]), 1, 4, device=CPU)
    # a NaN std: NaN raws cast to 0, as JAX's cast gives them
    _, acts, _ = tek.sample_policy_streams_debug_im(tp, actor, 1, 8,
                                                    log_std=torch.full((3,), float("nan")),
                                                    device=CPU)
    assert int(acts.abs().max()) == 0


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backlog", [True, False])
def test_k11_k12_match_plain_on_cuda(backlog, cuda):
    _, tp = _params(backlog=backlog, periods=30)
    b, E = 3000, 3   # not a multiple of the block: the tail is masked
    actor = tuple(tuple(a.to(cuda) for a in x) for x in _actor(tp))
    for log_std in (None, LOG_STD.to(cuda)):
        std = None if log_std is None else tek.clipped_std(log_std)
        ret, acts, dems = tek.sample_policy_streams_debug_im(
            tp, actor, 9, b, episodes_per_lane=E, log_std=log_std, device=cuda)
        want, _, want_d = tek._im_policy_plain(tp, actor, std, 9, b, E, cuda, True)
        assert torch.equal(dems, want_d)   # the demand words do not depend on the policy
        ok = (ret.double() - want.double()).abs() <= 1e-2 + 1e-4 * want.double().abs()
        assert float(ok.double().mean()) >= 0.99
        k11 = tek.episode_returns_im_policy(tp, actor, 9, b, episodes_per_lane=E,
                                            log_std=log_std, device=cuda)
        torch.testing.assert_close(k11, ret, rtol=0, atol=0)
