"""The last two NetInvMgmt sites of the JAX package, K25 ``batched_step``
(and ``rollout_transposed``, which calls it once a period) and K26
``episode_returns_random_policy``, in their plain PyTorch versions against
the JAX package; and the NetInvMgmt policy wrappers' CPU path with an actor
wider than the kernels take.

The JAX side runs as tests/test_pallas_net_step.py runs it: the Pallas
kernels in interpret mode. Tolerances: the state ``rtol=1e-5, atol=1e-3``
and the reward ``rtol=1e-5, atol=1e-2`` (f32 sums in another order; alpha^t
as a double rounded to f32 against JAX's f32 power); returns ``rtol=1e-5,
atol=1e-3``; plain K26 on plain K3's demand against plain K2 exactly (the
same words, the same arithmetic).

The kernels against their plain versions need the card: marked ``cuda``,
they skip without one (chip_smoke.py phases 30-31 make the checks at 65,536
lanes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import topology as jtopo
from or_gym_inventory_tpu.ops import pallas_net_step as pns

CPU = "cpu"
B = 8


def _carry(jp):
    return interop.net_params_from_numpy(dataclasses.asdict(jp.topology), jp.num_periods,
                                         jp.backlog, jp.alpha)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("backlog,topology_fn", [
    (True, jtopo.default_topology), (False, jtopo.default_topology),
    (True, jtopo.custom_topology)], ids=["default-backlog", "default-lost", "custom"])
def test_plain_k25_matches_jax_batched_step(backlog, topology_fn):
    """tests/test_pallas_net_step.py:14's chain: each period both steps take
    the JAX state; X', Y', U', RH' and the reward agree."""
    T = topology_fn(12)
    jp = jnet.NetInvParams(topology=T, num_periods=12, backlog=backlog, alpha=0.97)
    tp = _carry(jp)
    X, Y, U, RH = pns.init_transposed(jp, B)
    key = jax.random.PRNGKey(0)
    step = jax.jit(lambda *a: pns.batched_step(jp, *a, block=B, interpret=True))
    for t in range(6):
        akey, dkey = jax.random.split(jax.random.fold_in(key, t))
        action = jax.random.uniform(akey, (T.n_reorder, B), minval=0.0, maxval=200.0)
        demand = jax.random.poisson(dkey, 20.0, (T.n_retail, B)).astype(jnp.float32)
        got = tns.batched_step(tp, *(_t(x) for x in (X, Y, U, RH, action, demand)), t)
        X, Y, U, RH, rew = step(X, Y, U, RH, action, demand, jnp.asarray(t, jnp.int32))
        for name, a, b in zip(("X", "Y", "U", "RH"), got, (X, Y, U, RH)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3,
                                       err_msg=f"{name} t={t}")
        np.testing.assert_allclose(got[4].numpy(), np.asarray(rew)[0], rtol=1e-5, atol=1e-2)
    assert tns.batched_step.launches == 0


def test_k25_refuses_what_the_kernel_does_not_take():
    tp = tnet.default_params(num_periods=5)
    X, Y, U, RH = tns.init_transposed(tp, 4, CPU)
    T = tp.topology
    act = torch.zeros(T.n_reorder, 4)
    dem = torch.zeros(T.n_retail, 4)
    with pytest.raises(TypeError, match="float32"):
        tns.batched_step(tp, X, Y, U, RH, act.double(), dem, 0)
    with pytest.raises(ValueError, match="RH"):
        tns.batched_step(tp, X, Y, U, RH[:-1], act, dem, 0)
    with pytest.raises(ValueError, match="demand"):
        tns.batched_step(tp, X, Y, U, RH, act, dem[:, :3], 0)


def test_rollout_transposed_with_action_value_matches_jax():
    """A USER demand path makes the demand the same on both sides; with a
    constant action the two rollouts' summed rewards agree."""
    steps = 6
    user = {(1, 0): [float(v) for v in (12, 25, 7, 31, 18, 22)]}
    jp = jnet.default_params(num_periods=steps, user_D=user)
    tp = tnet.default_params(num_periods=steps, user_D=user)
    assert tp.topology.rt_demand == jp.topology.rt_demand
    want = pns.rollout_transposed(jp, jax.random.PRNGKey(1), batch=B, num_steps=steps,
                                  action_value=40.0, block=B, interpret=True)
    got = tns.rollout_transposed(tp, torch.Generator().manual_seed(5), B, steps,
                                 action_value=40.0, device=CPU)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_rollout_transposed_draws_from_its_generator():
    """Random actions on [0, 2 * order_cap_heuristic) and the env's demand:
    the same generator seed gives the same total, which is the plain step
    chain's on the same draws."""
    tp = tnet.default_params(num_periods=5)
    T = tp.topology
    totals = [tns.rollout_transposed(tp, torch.Generator().manual_seed(3), 16, 5, device=CPU)
              for _ in range(2)]
    assert torch.equal(totals[0], totals[1]) and torch.isfinite(totals[0])
    g = torch.Generator().manual_seed(3)
    X, Y, U, RH = tns.init_transposed(tp, 16, CPU)
    want = 0.0
    for t in range(5):
        action = torch.rand((T.n_reorder, 16), generator=g) * float(T.order_cap_heuristic * 2)
        demand = tnet.sample_demand(tp, g, t, 16, device=CPU).T.contiguous()
        X, Y, U, RH, rew = tns.batched_step(tp, X, Y, U, RH, action, demand, t)
        want += float(rew.sum())
    np.testing.assert_allclose(float(totals[0]), want, rtol=1e-6)


def test_plain_k26_on_replayed_words_matches_jax_episode_returns():
    """K26's actions are K2's action words of episode 0 (key (seed, 0), the
    period's first n_ro words): replayed through ops/rng.py and handed with
    the demand to JAX's stream-in kernel, they give K26's returns."""
    steps, seed, act_hi = 10, 77, 1700.0
    jp = jnet.default_params(num_periods=steps, alpha=0.95)
    tp = _carry(jp)
    n_ro, n_rt = jp.topology.n_reorder, jp.topology.n_retail
    dems = np.random.default_rng(0).poisson(20.0, (steps, n_rt, B)).astype(np.float32)
    got = tns.episode_returns_random_policy(tp, torch.from_numpy(dems), seed, act_hi)
    lanes = torch.arange(B)
    scale = np.float32(act_hi / float(1 << 24))
    acts = np.stack([np.stack([(w >> 8).numpy().astype(np.float32) * scale
                               for w in rng.period_words(seed, lanes, 0, t, n_ro)])
                     for t in range(steps)])
    assert acts.min() >= 0.0 and acts.max() < act_hi
    want = pns.episode_returns(jp, jnp.asarray(acts), jnp.asarray(dems), block=B,
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)
    assert got.shape == (B,) and tns.episode_returns_random_policy.launches == 0


@pytest.mark.parametrize("seed", [0, 2024])
def test_plain_k26_on_k3_demand_gives_k2_returns(seed):
    tp = tnet.default_params(num_periods=12)
    hi = float(tp.topology.order_cap_heuristic * 2)
    _, dems = tns.sample_streams_debug(tp, seed, hi, 32, device=CPU)
    k26 = tns.episode_returns_random_policy(tp, dems, seed, hi)
    k2 = tns.episode_returns_fully_fused(tp, seed, hi, 32, device=CPU)
    assert torch.equal(k26, k2)


def test_k26_refuses_what_the_kernel_does_not_take():
    tp = tnet.default_params(num_periods=4)
    with pytest.raises(TypeError, match="float32"):
        tns.episode_returns_random_policy(tp, torch.zeros(4, 1, 8, dtype=torch.float64), 0, 10.0)
    with pytest.raises(ValueError, match="demands"):
        tns.episode_returns_random_policy(tp, torch.zeros(4, 2, 8), 0, 10.0)


# ------------------------------------- C1: the policy wrappers on the CPU

def _wide_actor(T, width, seed=0):
    rng_np = np.random.default_rng(seed)
    dims = [T.obs_dim, width, T.n_reorder]
    Ws = tuple(torch.from_numpy(rng_np.normal(size=(a, b)).astype(np.float32) / np.sqrt(a))
               for a, b in zip(dims, dims[1:]))
    bs = tuple(torch.zeros(b) for b in dims[1:])
    return Ws, bs


def test_net_policy_wrappers_take_a_wider_actor_on_the_cpu():
    """The NetInvMgmt wrappers pack the CUDA actor only on the card, so with
    device="cpu" a 300-wide actor (the tile takes 256) runs as JAX runs it:
    K5's deterministic returns are JAX's stream-in kernel on K6's dumped
    streams, and K4 and K29 run. The cap stays on the card."""
    steps = 10
    jp = jnet.default_params(num_periods=steps)
    tp = _carry(jp)
    T = tp.topology
    actor = _wide_actor(T, 300)
    ret = tns.episode_returns_net_policy(tp, actor, 5, B, device=CPU)
    ret6, acts, dems = tns.sample_policy_streams_debug_net(tp, actor, 5, B, device=CPU)
    assert torch.equal(ret, ret6.reshape(ret.shape))
    want = pns.episode_returns(jp, jnp.asarray(acts[:, 0].numpy()),
                               jnp.asarray(dems[:, 0].numpy()), block=B, interpret=True)
    np.testing.assert_allclose(ret.numpy()[None], np.asarray(want)[None], rtol=1e-5, atol=1e-3)
    log_std = torch.zeros(T.n_reorder)
    tr = tns.rollout_traj_net(tp, actor, log_std, 5, B, device=CPU)
    assert torch.isfinite(tr["reward"]).all() and tr["raw"].shape == (steps, T.n_reorder, B)
    tr = tns.rollout_traj_net(tp, actor, log_std, 5, B, "det", "relu", CPU)
    assert float(tr["raw"].abs().max()) <= 1.0
    st, _ = tns._pack_net_tile_actor(T, actor, None, CPU)   # the general class on the card
    assert isinstance(st, tek._MlpTileG) and st.ws_floats == 0
    with pytest.raises(ValueError, match="obs_dim"):
        tns.episode_returns_net_policy(tp, ((actor[0][0][1:], actor[0][1]), actor[1]), 5, B,
                                       device=CPU)


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_b6_kernels_match_plain_on_cuda():
    """K25 on chained periods and K26 on K3's demand against their plain
    versions (rtol=1e-5, atol=1e-3), and K26 against K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    tp = tnet.default_params(num_periods=12)
    T = tp.topology
    hi = float(T.order_cap_heuristic * 2)
    n = 4099                                    # a ragged tail
    g = torch.Generator(device=dev).manual_seed(0)
    X, Y, U, RH = (x.contiguous() for x in tns.init_transposed(tp, n, dev))
    for t in range(12):
        action = torch.rand((T.n_reorder, n), generator=g, device=dev) * hi
        demand = tnet.sample_demand(tp, g, t, n, device=dev).T.contiguous()
        got = tns.batched_step(tp, X, Y, U, RH, action, demand, t)
        want = tns._batched_step_plain(tp, X, Y, U, RH, action, demand, t)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
        X, Y, U, RH = got[:4]
    _, dems = tns.sample_streams_debug(tp, 9, hi, n, device=dev)
    k26 = tns.episode_returns_random_policy(tp, dems, 9, hi)
    torch.testing.assert_close(k26, tns._episode_returns_random_policy_plain(tp, dems, 9, hi),
                               rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(k26, tns.episode_returns_fully_fused(tp, 9, hi, n, device=dev),
                               rtol=1e-5, atol=1e-3)
