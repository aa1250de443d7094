"""The off-policy step-interleaved iteration (``OffPolicyConfig(collect=
"xla")``, agents/off_policy.py) against the JAX package's jitted
``make_offpolicy(...)[1]`` on the same parameters and streams.

Both packages read the same NumPy env streams, made from a seed: each
step's demand (``vecenv.batch_step`` patched in both to the family's
``step_with_demand``) and each Newsvendor reset's economics
(``vecenv.batch_reset`` patched to ``reset_with_econ``); JAX's jitted
update reads them through ordered ``io_callback``s (tests/test_torch_ppo_xla.py's
``_patch``, its Gaussian sampler put back: this learner's normals come from
its keys). The port's iteration takes the action normals and warmup
uniforms, the minibatch rows and the normals that JAX derives from the
iteration's key (``update.iterate`` on given draws). The flax parameters are
carried with ``utils.interop.offpolicy_params_from_numpy`` and the
statistics with ``rms_from_numpy``.

Each case runs three iterations of 8 envs on a horizon of 2, so that the
envs reset after the second: the first iteration is the uniform warmup
(``start_steps`` 8), the second and third act from the actor, with two
updates an iteration. After each iteration the actor, critics and targets,
``log_alpha``, the statistics, the buffer's rows and pointer, the window,
``last_obs`` and the metrics are held at ``rtol=1e-4, atol=1e-5`` (Adam
steps over f32 losses summed in another order), the buffer's done flags,
pointer and fill exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import off_policy as top
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.agents import networks as jnetworks
from or_gym_inventory_tpu.agents import off_policy as jop
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import newsvendor as jnv
from test_torch_off_policy import _load, _np_tree
from test_torch_ppo_xla import ENVS, _patch, _Streams

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-5)
HORIZON, ITERS, UPDATES, BATCH = 2, 3, 2, 16
ARCH = (16, 16)


def _family(name):
    """(JAX module, port module, JAX params, port params, retail links) at
    a horizon of 2."""
    if name == "newsvendor":
        jp = jnv.default_params(step_limit=HORIZON)
        return jnv, tnv, jp, tnv.NewsvendorParams(**dataclasses.asdict(jp)), 0
    if name == "inv_management":
        jp = jim.default_params(periods=HORIZON)
        return jim, tim, jp, interop.im_params_from_numpy(dataclasses.asdict(jp)), 0
    jp = jnet.default_params(num_periods=HORIZON)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), HORIZON, jp.backlog,
                                       jp.alpha)
    return jnet, tnet, jp, tp, tp.topology.n_retail


def _patch_env(monkeypatch, family, jmod, tmod, js, ts):
    """_patch's env streams, without its Gaussian sampler."""
    jsample, tsample = jnetworks.gaussian_sample, tnetworks.gaussian_sample
    _patch(monkeypatch, family, jmod, tmod, js, ts)
    monkeypatch.setattr(jnetworks, "gaussian_sample", jsample)
    monkeypatch.setattr(tnetworks, "gaussian_sample", tsample)


def _jax_draws(key, jnew, cfg, act_dim):
    """The draws of JAX's update from ``key`` (off_policy.py:385-407,
    :457, :488-530): the action normals and warmup uniforms, then each
    update's minibatch rows (over the rows filled after the insert) and
    normals."""
    akey, _, _, _, ukey = jax.random.split(key, 5)
    shape = (cfg.num_envs, act_dim)
    a_z = np.array(jax.random.normal(akey, shape))
    a_u = np.array(jax.random.uniform(jax.random.fold_in(akey, 1), shape, minval=-1.0,
                                      maxval=1.0))
    filled = jnp.maximum(jnew.buffer.filled, 1)
    idx, zs = [], []
    for uk in jax.random.split(ukey, cfg.updates_per_iter):
        idx.append(np.asarray(jax.random.randint(uk, (cfg.batch_size,), 0, filled)))
        zn = jax.random.normal(jax.random.fold_in(uk, 0 if cfg.algo == "sac" else 1),
                               (cfg.batch_size, act_dim))
        zp = jax.random.normal(jax.random.fold_in(uk, 2), (cfg.batch_size, act_dim))
        zs.append(np.stack([np.asarray(zn), np.asarray(zp)]))
    return (torch.from_numpy(a_z), torch.from_numpy(a_u),
            torch.from_numpy(np.stack(idx).astype(np.int64)), torch.from_numpy(np.stack(zs)))


def _close(got, want, label):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=label, **TOL)


def _assert_iteration_matches(tstate, tmetrics, jstate, jmetrics, stochastic, label):
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
            _close(got[k].detach().numpy(), want[k].numpy(), f"{label} {name} {k}")
    _close(float(tstate.log_alpha), float(jstate.log_alpha), f"{label} log_alpha")
    want_rms = interop.rms_from_numpy(jstate.rms.mean, jstate.rms.var, jstate.rms.count,
                                      device=CPU)
    for f in ("mean", "var", "count"):
        _close(getattr(tstate.rms, f).numpy(), getattr(want_rms, f).numpy(), f"{label} rms.{f}")
    tbuf, jbuf = tstate.buffer, jstate.buffer
    assert (tbuf.ptr, tbuf.filled) == (int(jbuf.ptr), int(jbuf.filled)), label
    for f in top.ReplayBuffer.FIELDS:
        if f == "done":
            np.testing.assert_array_equal(tbuf.done.numpy(), np.asarray(jbuf.done), label)
        else:
            _close(getattr(tbuf, f).numpy(), np.asarray(getattr(jbuf, f)), f"{label} buffer.{f}")
    for f in ("obs", "action", "reward", "next_obs"):
        _close(tstate.window[f].numpy(), np.asarray(jstate.window[f]), f"{label} window.{f}")
    np.testing.assert_array_equal(tstate.window["done"].numpy(), np.asarray(jstate.window["done"]))
    _close(tstate.last_obs.numpy(), np.asarray(jstate.last_obs), f"{label} last_obs")
    assert tstate.step_idx == int(jstate.step_idx)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        _close(float(tmetrics[k]), float(jmetrics[k]), f"{label} {k}")


CASES = {   # algo, family, n_step, buffer_size (12: the row scatter wraps; 24: chunks)
    "sac_im_n1": ("sac", "inv_management", 1, 12),
    "td3_nv_n1": ("td3", "newsvendor", 1, 24),
    "ddpg_net_n1": ("ddpg", "net_inv_management", 1, 12),
    "sac_nv_n3": ("sac", "newsvendor", 3, 24),
    "td3_net_n3": ("td3", "net_inv_management", 3, 12),
    "ddpg_im_n3": ("ddpg", "inv_management", 3, 24),
}


@pytest.mark.parametrize("case", list(CASES))
def test_xla_iterations_match_jax(monkeypatch, case):
    algo, family, n_step, buffer_size = CASES[case]
    jmod, tmod, jp, tp, n_retail = _family(family)
    kw = dict(algo=algo, num_envs=ENVS, buffer_size=buffer_size, batch_size=BATCH,
              start_steps=ENVS, updates_per_iter=UPDATES, n_step=n_step, pi_arch=ARCH,
              q_arch=ARCH)
    jcfg, tcfg = jop.OffPolicyConfig(**kw), top.OffPolicyConfig(**kw)
    assert tcfg.collect == "xla" and tmod.ENV.horizon(tp) == HORIZON
    stochastic = algo == "sac"
    act_dim = int(np.prod(tmod.ENV.action_space(tp).shape))
    js, ts = (_Streams(family, tp, act_dim, n_retail) for _ in range(2))
    _patch_env(monkeypatch, family, jmod, tmod, js, ts)

    jinit, jupdate, _ = jop.make_offpolicy(jmod.ENV, jp, jcfg)
    jstate = jax.jit(jinit)(jax.random.PRNGKey(0))
    jupdate = jax.jit(jupdate)
    tinit, tupdate, _ = top.make_offpolicy(tmod.ENV, tp, tcfg, device=CPU)
    tstate = tinit(torch.Generator().manual_seed(0))
    _load(tstate, jstate, stochastic)
    _close(tstate.last_obs.numpy(), np.asarray(jstate.last_obs), f"{case} reset obs")
    assert tstate.buffer.size == buffer_size

    prev_mu = None
    for it in range(ITERS):
        key = jax.random.PRNGKey(100 + it)
        jnew, jmetrics = jupdate(jstate, key)
        a_z, a_u, idx, z = _jax_draws(key, jnew, jcfg, act_dim)
        tstate, tmetrics = tupdate.iterate(tstate, None, a_z, a_u, idx, z)
        _assert_iteration_matches(tstate, tmetrics, jnew, jmetrics, stochastic,
                                  f"{case} iteration {it + 1}")
        # no zero-initialised window row enters the buffer
        assert tstate.buffer.filled == min(max(0, it + 2 - n_step) * ENVS, buffer_size)
        rows = tstate.buffer.obs[:tstate.buffer.filled]
        assert bool((rows.abs().sum(dim=1) > 0).all()), f"{case}: a zero row in the buffer"
        # TD3's delay counts iterations: at an odd step_idx every update steps
        # Adam on zero actor gradients, so its first moment only decays
        mu = [m.clone() for m in tstate.actor_opt.mu]
        if algo == "td3" and it % 2 == 1:
            for m, p in zip(mu, prev_mu):
                np.testing.assert_allclose(m.numpy(), (0.9 ** UPDATES) * p.numpy(), rtol=1e-6,
                                           atol=1e-12)
        prev_mu = mu
        jstate = jnew
    assert ts.at["demand"] == ITERS and js.at["demand"] == ITERS


FAMILIES = {
    "inv_management": (tim.ENV, lambda: tim.default_params()),
    "newsvendor": (tnv.ENV, lambda: tnv.default_params()),
    "net_inv_management": (tnet.ENV, lambda: tnet.default_params()),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_default_config_on_cpu(family):
    """``train`` at ``OffPolicyConfig()`` (collect="xla", SAC, 128 envs, the
    (256, 256) networks) runs exactly total_timesteps // num_envs
    iterations, warming up inside them, and evaluates inside the box."""
    env, make_params = FAMILIES[family]
    params = make_params()
    cfg = top.OffPolicyConfig()
    assert cfg.collect == "xla" and cfg.algo == "sac"
    total = 2 * cfg.num_envs + 5
    state, eval_policy, metrics = top.train(env, params, cfg, torch.Generator().manual_seed(0),
                                            total, log_every=1, device=CPU)
    np.testing.assert_array_equal(metrics["timesteps"], [cfg.num_envs, 2 * cfg.num_envs])
    assert np.isfinite(metrics["mean_step_reward"]).all()
    assert state.step_idx == 2 and state.buffer.filled == 2 * cfg.num_envs
    assert state.buffer.size == cfg.buffer_size and state.window["obs"].shape[0] == 1
    space = env.action_space(params)
    obs = state.last_obs[:6]
    a = eval_policy((state.actor_params, state.rms), obs, None, 0)
    assert a.shape == (6,) + tuple(space.shape) and torch.isfinite(a.float()).all()
    assert (a >= torch.as_tensor(space.low)).all() and (a <= torch.as_tensor(space.high)).all()
