"""The off-policy heads of the three trajectory kernels (K27-K29) in their
plain PyTorch versions, against the JAX package.

- ``mlp_forward`` with a relu (and tanh) trunk against the JAX package's
  ``mlp_forward`` called on plain arrays (it only indexes ``[...]``):
  ``rtol=1e-5, atol=1e-6`` (f32 sums in another order); a NaN keeps to its
  lane in both.
- ``traj_policy``'s four heads against pallas_episode_kernels.py
  :1062-1080 transcribed in numpy, on injected normals: ``rtol=1e-5,
  atol=1e-6`` (tanh/exp ulps).
- ``fold_offpolicy_actor`` against the JAX fold on carried parameters:
  ``rtol=1e-5, atol=1e-6``.
- The plain K27-K29 trajectories replayed through the JAX env chains: the
  InvManagement state exactly, the float families' rewards by the share of
  lanes (>= 99% within ``rtol=1e-3, atol=2.0``, the pin of
  tests/test_kernel_collect.py:317), the observations that both
  ``assemble_obs_from_streams`` rebuild from the streams exactly, and the
  demand bit for bit against the PPO kernels' plain versions on the same
  seed (the stream layout of ops/rng.py).

The kernels against their plain versions need the card: marked ``cuda``,
they skip without one (chip_smoke.py phase 32 makes the checks at 65,536
lanes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import off_policy as top
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.agents import off_policy as jop
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ("det", "sac", "uniform")
B = 64


def _actor(obs_dim, act_dim, stochastic, seed=0, arch=(32, 32)):
    """A seeded port ``_Actor`` with obs statistics (mean ~40, std ~15)
    folded in, as (Ws, bs), and the det head's log(0.1)."""
    g = torch.Generator().manual_seed(seed)
    actor = top._Actor(obs_dim, act_dim, arch, stochastic, g)
    rms = tppo.RunningMeanStd.create(obs_dim, CPU).update(
        40.0 + 15.0 * torch.randn(256, obs_dim, generator=g))
    return (tek.fold_offpolicy_actor(arch, actor, rms, stochastic),
            torch.full((act_dim,), float(np.log(np.float32(0.1)))))


# -------------------------------------------------------- trunk and heads

@pytest.mark.parametrize("act_name", ["relu", "tanh"])
def test_mlp_forward_matches_jax(act_name):
    rng_np = np.random.default_rng(0)
    dims = [7, 16, 12, 4]
    Ws = [rng_np.normal(size=(a, b)).astype(np.float32) / np.sqrt(a)
          for a, b in zip(dims, dims[1:])]
    bs = [rng_np.normal(size=(b,)).astype(np.float32) for b in dims[1:]]
    obs = rng_np.normal(size=(dims[0], 40)).astype(np.float32) * 2.0
    obs[3, 5] = np.nan                       # one lane's NaN stays in that lane
    layers = tek.kernel_layers((Ws, bs), CPU)
    got = tek.mlp_forward(layers, act_name, [torch.from_numpy(r) for r in obs])
    want = jek.mlp_forward([jnp.asarray(W.T) for W in Ws],
                           [jnp.asarray(b.reshape(-1, 1)) for b in bs], act_name, None,
                           [jnp.asarray(r) for r in obs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isnan(got.numpy()[:, 5]).all() and np.isfinite(np.delete(got.numpy(), 5, 1)).all()


def _np_heads(mode, H, std, z, act_dim):
    """pallas_episode_kernels.traj_policy :1062-1080 in numpy (float32)."""
    f32 = np.float32
    if mode == "uniform":
        a = f32(2.0) * z - f32(1.0)
        return a, a
    if mode == "ppo":
        raw = H + std * z
        return raw, np.tanh(raw)
    if mode == "det":
        a = np.clip(np.tanh(H) + std * z, f32(-1.0), f32(1.0))
        return a, a
    mean, ls = H[:act_dim], H[act_dim:]
    a = np.tanh(mean + np.exp(np.clip(ls, f32(-10.0), f32(2.0))) * z)
    return a, a


@pytest.mark.parametrize("mode", ["ppo", "det", "sac", "uniform"])
def test_traj_policy_heads_match_the_reference_math(mode):
    rng_np = np.random.default_rng(1)
    A, n = 3, 50
    out = 2 * A if mode == "sac" else A
    dims = [6, 16, out]
    Ws = [rng_np.normal(size=(a, b)).astype(np.float32) for a, b in zip(dims, dims[1:])]
    bs = [rng_np.normal(size=(b,)).astype(np.float32) for b in dims[1:]]
    obs = rng_np.normal(size=(6, n)).astype(np.float32)
    z = (rng_np.random((A, n)) if mode == "uniform"
         else rng_np.normal(size=(A, n))).astype(np.float32)
    std = np.array([[0.1], [0.5], [2.0]], np.float32)
    layers = tek.kernel_layers((Ws, bs), CPU)
    store, a_norm = tek.traj_policy(mode, "relu", A, layers, torch.from_numpy(std),
                                    [torch.from_numpy(r) for r in obs], torch.from_numpy(z))
    H = np.asarray(jek.mlp_forward([jnp.asarray(W.T) for W in Ws],
                                   [jnp.asarray(b.reshape(-1, 1)) for b in bs], "relu", None,
                                   [jnp.asarray(r) for r in obs]))
    want_store, want_a = _np_heads(mode, H, std, z, A)
    np.testing.assert_allclose(store.numpy(), want_store, **TOL)
    np.testing.assert_allclose(a_norm.numpy(), want_a, **TOL)
    if mode != "ppo":
        assert float(a_norm.min()) >= -1.0 and float(a_norm.max()) <= 1.0
        assert torch.equal(store, a_norm)


def test_traj_policy_refusals():
    layers = tek.kernel_layers(([np.ones((2, 3), np.float32)], [np.zeros(3, np.float32)]), CPU)
    obs = [torch.zeros(4), torch.zeros(4)]
    with pytest.raises(ValueError, match="unknown traj_policy mode"):
        tek.traj_policy("bogus", "relu", 3, layers, None, obs, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="act_name"):
        tek.traj_policy("det", "gelu", 3, layers, torch.ones(3, 1), obs, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="outputs"):     # sac needs 2 * act_dim
        tek.traj_policy("sac", "relu", 3, layers, None, obs, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="act_name"):
        tek.mlp_forward(layers, "elu", obs)
    p = tim.default_params(periods=3)
    actor, log_std = _actor(33, 3, False)
    for fn, args in ((tek.rollout_traj_im, (p,)), (tek.rollout_traj_im_offpolicy, (p,)),
                     (tek.rollout_traj_nv, (tnv.default_params(step_limit=3),)),
                     (tns.rollout_traj_net, (tnet.default_params(num_periods=3),))):
        with pytest.raises(ValueError, match="unknown traj_policy mode"):
            fn(*args, actor, log_std, 1, 4, "random", "relu", CPU)
        with pytest.raises(ValueError, match="act_name"):
            fn(*args, actor, log_std, 1, 4, "det", "sigmoid", CPU)
    with pytest.raises(ValueError, match="log_std is required"):
        tek.rollout_traj_im_offpolicy(p, actor, None, 1, 4, "det", "relu", CPU)
    with pytest.raises(ValueError, match="obs_dim"):    # the mean head alone for sac
        tek.rollout_traj_im_offpolicy(p, actor, None, 1, 4, "sac", "relu", CPU)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("with_rms", [True, False])
def test_fold_offpolicy_actor_matches_jax(stochastic, with_rms):
    """tests/test_kernel_collect.py:125 on carried parameters: the folds
    agree, and the fold's relu chain on raw obs is _Actor on normalised obs
    (the log_std rows before their clip)."""
    D, A, arch = 6, 3, (16, 8)
    jactor = jop._Actor(action_dim=A, arch=arch, stochastic=stochastic)
    jparams = jactor.init(jax.random.PRNGKey(0), jnp.zeros((1, D)))
    jrms = jop.RunningMeanStd.create(D).update(
        10.0 + 5.0 * jax.random.normal(jax.random.PRNGKey(1), (128, D))) if with_rms else None
    want = jek.fold_offpolicy_actor(arch, jparams, jrms, stochastic)
    actor = top._Actor(D, A, arch, stochastic)
    a_sd, _ = interop.offpolicy_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams),
        {"params": {"QNetwork_0": {"Dense_0": {"kernel": np.zeros((1, 1)), "bias": np.zeros(1)}}}},
        stochastic, device=CPU)
    actor.load_state_dict(a_sd)
    trms = interop.rms_from_numpy(jrms.mean, jrms.var, jrms.count, device=CPU) if with_rms \
        else None
    Ws, bs = tek.fold_offpolicy_actor(arch, actor, trms, stochastic)
    assert len(Ws) == len(want[0]) == len(arch) + 1
    assert Ws[-1].shape[-1] == (2 * A if stochastic else A)
    for got, ref in zip(Ws + bs, want[0] + want[1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    obs = np.random.default_rng(2).normal(size=(32, D)).astype(np.float32) * 8.0 + 3.0
    H = torch.from_numpy(obs)
    for i, (W, b) in enumerate(zip(Ws, bs)):
        H = H @ W + b
        if i < len(Ws) - 1:
            H = torch.relu(H)
    nobs = trms.normalize(torch.from_numpy(obs)) if with_rms else torch.from_numpy(obs)
    with torch.no_grad():
        mean, ls = actor(nobs)
    np.testing.assert_allclose(H[:, :A].numpy(), mean.numpy(), rtol=1e-4, atol=1e-5)
    if stochastic:
        np.testing.assert_allclose(torch.clamp(H[:, A:], -10, 2).numpy(), ls.numpy(),
                                   rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="trunk layers"):
        tek.fold_offpolicy_actor((16,), actor, None, stochastic)


def test_pack_wide_actor_layout():
    """The wide kernels' buffer (csrc/wide_mlp.cuh): each layer W^T (in,
    out8) then b (out8), zero-padded to 8 outputs; then the std for the
    heads that take one; the struct's widths, head and factors."""
    actor, log_std = _actor(33, 3, False, arch=(20, 12))
    std = tek.clipped_std(log_std)
    st, flat = tek._pack_wide_actor(actor, std, 33, 3, "det", [1.0, 2.0, 3.0], CPU)
    Ws, bs = actor
    assert st.n_layers == 3 and list(st.dims[:4]) == [33, 20, 12, 3]
    assert st.rows == 33 and st.act == 3 and st.head == tek.HEADS["det"]
    assert list(st.half_hi[:3]) == [1.0, 2.0, 3.0]
    off = 0
    for W, b in zip(Ws, bs):
        n_in, n_out = W.shape
        n8 = -(-n_out // 8) * 8
        Wp = flat[off:off + n_in * n8].reshape(n_in, n8)
        assert torch.equal(Wp[:, :n_out], W) and not Wp[:, n_out:].any()
        off += n_in * n8
        assert torch.equal(flat[off:off + n_out], b) and not flat[off + n_out:off + n8].any()
        off += n8
    assert st.std == off and torch.equal(flat[off:], std.reshape(-1))
    sac_actor, _ = _actor(33, 3, True, arch=(256, 256))
    st, flat = tek._pack_wide_actor(sac_actor, None, 33, 3, "sac", [1.0] * 3, CPU)
    assert st.std == -1 and st.rows == 256 and flat.numel() == 33 * 256 + 256 + 256 * 256 \
        + 256 + 256 * 8 + 8
    wide = ([torch.zeros(33, 1000), torch.zeros(1000, 3)], [torch.zeros(1000), torch.zeros(3)])
    with pytest.raises(ValueError, match="shared memory"):
        tek._pack_wide_actor(wide, None, 33, 3, "uniform", [1.0] * 3, CPU)
    deep = ([torch.zeros(33, 8)] + [torch.zeros(8, 8)] * 8 + [torch.zeros(8, 3)],
            [torch.zeros(8)] * 9 + [torch.zeros(3)])
    with pytest.raises(ValueError, match="at most"):
        tek._pack_wide_actor(deep, None, 33, 3, "uniform", [1.0] * 3, CPU)


# ------------------------------------------- InvManagement (K27) replays

def _im_params(periods=12):
    jp = jim.default_params(periods=periods)
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


@pytest.mark.parametrize("mode", MODES)
def test_plain_k27_replays_through_the_jax_chain(mode):
    """tests/test_kernel_collect.py:205 on the plain K27: its actions and
    demand through the JAX step chain give its inv exactly and its rewards;
    a_norm in [-1, 1] rescales to its int actions; both packages rebuild the
    same observations from its streams; its demand is plain K10's."""
    from test_kernel_rollout import _replay_chain
    jp, tp = _im_params()
    actor, log_std = _actor(33, 3, mode == "sac")
    tr = tek.rollout_traj_im(tp, actor, log_std, 31, B, mode, "relu", CPU)
    assert tek.rollout_traj_im_offpolicy.launches == 0
    acts, dems = tr["actions"].numpy(), tr["demand"].numpy()
    obs_all, rew, final_inv = _replay_chain(jp, acts, dems)
    inv = tr["inv"].numpy()
    np.testing.assert_array_equal(inv[-1], np.asarray(final_inv))
    np.testing.assert_array_equal(inv[:-1], np.asarray(obs_all)[:-1, :, :3].transpose(0, 2, 1))
    np.testing.assert_allclose(tr["reward"].numpy(), np.asarray(rew), rtol=1e-5, atol=1e-2)
    a_norm = tr["raw"].numpy()
    assert a_norm.min() >= -1.0 and a_norm.max() <= 1.0
    half_c = np.array(tek._half_c(tp), np.float32)[None, :, None]
    np.testing.assert_array_equal(((a_norm + np.float32(1.0)) * half_c).astype(np.int32), acts)
    t_obs = tim.assemble_obs_from_streams(tp, tr["inv"], tr["actions"])
    j_obs = jim.assemble_obs_from_streams(jp, jnp.asarray(inv), jnp.asarray(acts))
    np.testing.assert_array_equal(t_obs.numpy(), np.asarray(j_obs))
    np.testing.assert_array_equal(t_obs.numpy(), np.asarray(obs_all))
    assert acts.std(axis=-1).mean() > 0
    ppo_actor, ppo_log_std = _actor(33, 3, False, seed=4)
    ppo = tek.rollout_traj_im(tp, ppo_actor, ppo_log_std, 31, B, device=CPU)
    assert torch.equal(tr["demand"], ppo["demand"])
    if mode == "uniform":
        lanes = torch.arange(B)
        for t in range(tp.periods):
            words = rng.period_words(31, lanes, 0, t, 4, key1=rng.POLICY_KEY)
            np.testing.assert_array_equal(
                a_norm[t], (2.0 * rng.uniform01(torch.stack(words[1:])) - 1.0).numpy())


def test_k27_dispatch_and_the_ppo_head_on_a_relu_trunk():
    """``rollout_traj_im(policy, act_name)`` hands every pair but ("ppo",
    "tanh") to K27; K27's "ppo" head stores the pre-squash sample as K10
    does, so a tanh-trunk "ppo" through the off-policy wrapper is K10."""
    _, tp = _im_params(6)
    actor, log_std = _actor(33, 3, False)
    a = tek.rollout_traj_im(tp, actor, log_std, 3, 16, "det", "tanh", CPU)
    b = tek.rollout_traj_im_offpolicy(tp, actor, log_std, 3, 16, "det", "tanh", CPU)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    k10 = tek.rollout_traj_im(tp, actor, log_std, 3, 16, device=CPU)
    k27 = tek.rollout_traj_im_offpolicy(tp, actor, log_std, 3, 16, "ppo", "tanh", CPU)
    for k in k10:
        assert torch.equal(k10[k], k27[k]), k
    relu = tek.rollout_traj_im(tp, actor, log_std, 3, 16, "ppo", "relu", CPU)
    assert torch.equal(relu["demand"], k10["demand"])
    assert not torch.equal(relu["raw"], k10["raw"])


# ------------------------------------------- Newsvendor (K28) replays

@pytest.mark.parametrize("mode", MODES)
def test_plain_k28_replays_through_the_jax_chain(mode):
    """tests/test_kernel_collect.py:246 on the plain K28: the econ and the
    demand replayed through JAX's step_with_demand from reset_with_econ give
    its capped orders and rewards; both packages rebuild the same
    observations; its econ and demand are plain K18's."""
    jp = jnv.default_params(step_limit=10)
    tp = tnv.NewsvendorParams(**dataclasses.asdict(jp))
    actor, log_std = _actor(tp.obs_dim, 1, mode == "sac")
    tr = tek.rollout_traj_nv(tp, actor, log_std, 77, B, mode, "relu", CPU)
    a_norm = tr["raw"].numpy()[:, 0]
    assert a_norm.min() >= -1.0 and a_norm.max() <= 1.0
    half = np.float32(tek._nv_half_hi(tp)[0])
    requests = (a_norm + np.float32(1.0)) * half

    @jax.jit
    def run(econ, acts, dems):
        def one(e, a, d):
            state, _ = jnv.reset_with_econ(jp, e)

            def body(state, ad):
                state, ts = jnv.step_with_demand(jp, state, ad[0], ad[1])
                return state, (ts.reward, state.pipeline[-1])

            _, out = jax.lax.scan(body, state, (a, d))
            return out
        return jax.vmap(one, in_axes=(1, 1, 1), out_axes=1)(econ, acts, dems)

    rew, last = run(jnp.asarray(tr["econ"].numpy()), jnp.asarray(requests),
                    jnp.asarray(tr["demand"].numpy()))
    frac = np.isclose(tr["reward"].numpy(), np.asarray(rew), rtol=1e-3, atol=2.0).mean()
    assert frac > 0.99
    np.testing.assert_allclose(tr["orders"].numpy(), np.asarray(last), rtol=1e-5, atol=1e-3)
    t_obs = tnv.assemble_obs_from_streams(tp, tr["econ"], tr["orders"])
    j_obs = jnv.assemble_obs_from_streams(jp, jnp.asarray(tr["econ"].numpy()),
                                          jnp.asarray(tr["orders"].numpy()))
    np.testing.assert_array_equal(t_obs.numpy(), np.asarray(j_obs))
    ppo_actor, ppo_log_std = _actor(tp.obs_dim, 1, False, seed=4)
    ppo = tek.rollout_traj_nv(tp, ppo_actor, ppo_log_std, 77, B, device=CPU)
    assert torch.equal(tr["econ"], ppo["econ"]) and torch.equal(tr["demand"], ppo["demand"])


# ------------------------------------------- NetInvMgmt (K29) replays

@pytest.mark.parametrize("mode", MODES)
def test_plain_k29_replays_through_the_jax_chain(mode):
    """tests/test_kernel_collect.py:277 on the plain K29: its a_norm
    rescaled to orders and its demand through the JAX step_with_demand
    chain give its rewards and fulfilled orders; both packages rebuild the
    same observations; its demand is plain K4's."""
    jp = jnet.default_params(num_periods=10)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), 10, jp.backlog,
                                       jp.alpha)
    T_ = tp.topology
    actor, log_std = _actor(T_.obs_dim, T_.n_reorder, mode == "sac", seed=5)
    tr = tns.rollout_traj_net(tp, actor, log_std, 53, B, mode, "relu", CPU)
    a_norm = tr["raw"].numpy()
    assert a_norm.min() >= -1.0 and a_norm.max() <= 1.0
    acts = ((a_norm + np.float32(1.0)) * np.float32(tns._half_hi(T_))).transpose(0, 2, 1)

    @jax.jit
    def run(acts, dems):
        state = jax.vmap(lambda _: jnet.reset(jp)[0])(jnp.arange(B))

        def body(state, inp):
            a, d = inp
            state, ts = jax.vmap(jnet.step_with_demand, in_axes=(None, 0, 0, 1))(
                jp, state, a, d)
            return state, ts.reward

        return jax.lax.scan(body, state, (acts, dems))[1]

    rew = run(jnp.asarray(acts), jnp.asarray(tr["demand"].numpy()))
    frac = np.isclose(tr["reward"].numpy(), np.asarray(rew), rtol=1e-3, atol=2.0).mean()
    assert frac > 0.99
    t_obs = tnet.assemble_obs_from_streams(tp, tr["x"], tr["u"], tr["r"])
    j_obs = jnet.assemble_obs_from_streams(jp, *(jnp.asarray(tr[k].numpy())
                                                 for k in ("x", "u", "r")))
    np.testing.assert_array_equal(t_obs.numpy(), np.asarray(j_obs))
    assert acts.std(axis=1).mean() > 0
    ppo_actor, ppo_log_std = _actor(T_.obs_dim, T_.n_reorder, False, seed=6)
    ppo = tns.rollout_traj_net(tp, ppo_actor, ppo_log_std, 53, B, device=CPU)
    assert torch.equal(tr["demand"], ppo["demand"])


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_offpolicy_kernels_match_plain_on_cuda(mode):
    """K27-K29 against their plain versions on the card, the SB3-default
    (256, 256) relu actor: demand bit for bit; a_norm on >= 99% of lanes
    within rtol=1e-4 atol=1e-4 (bit for bit for uniform)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cases = [(tek.rollout_traj_im_offpolicy, tek._rollout_traj_im_plain,
              tim.default_params(periods=12), 33, 3),
             (tek.rollout_traj_nv_offpolicy, tek._rollout_traj_nv_plain,
              tnv.default_params(step_limit=10), 10, 1),
             (tns.rollout_traj_net_offpolicy, tns._rollout_traj_plain,
              tnet.default_params(num_periods=10), 68, 11)]
    for kernel, plain, params, obs_dim, act_dim in cases:
        (Ws, bs), log_std = _actor(obs_dim, act_dim, mode == "sac", arch=(256, 256))
        actor = (tuple(W.to(dev) for W in Ws), tuple(b.to(dev) for b in bs))
        got = kernel(params, actor, log_std.to(dev), 7, 4096, mode, "relu", dev)
        std = tek.clipped_std(log_std).to(dev) if mode == "det" else None
        want = plain(params, actor, std, 7, 4096, dev, mode, "relu")
        torch.cuda.synchronize()
        assert torch.equal(got["demand"], want["demand"])
        if mode == "uniform":
            assert torch.equal(got["raw"], want["raw"])
        ok = torch.isclose(got["raw"], want["raw"], rtol=1e-4, atol=1e-4)
        assert float(ok.reshape(-1, 4096).all(0).double().mean()) >= 0.99
