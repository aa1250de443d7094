"""PPO's fused policy+env update (``rollout="xla"``, agents/ppo.py) against
the JAX package's ``make_update_fn`` on the same parameters and streams.

Both packages read the same NumPy streams, made from a seed: the policy's
normals (``networks.gaussian_sample`` patched in both), each step's demand
(``vecenv.batch_step`` patched in both to the family's
``step_with_demand``) and each Newsvendor reset's economics
(``vecenv.batch_reset`` patched to ``reset_with_econ``; the other families'
resets draw nothing). JAX's jitted update reads them through ordered
``io_callback``s, so each scan step takes the next row at run time, as the
port's loop does; nothing in the JAX package changes. The
flax parameters are carried into the port with
``utils.interop.ppo_params_from_numpy``.

Each case runs two updates of ``rollout_steps`` 8 on an env whose horizon
(10 or 12) it does not divide, so that the second update's episodes end
mid-rollout: the envs reset there, the bootstrap comes from the pre-reset
obs and the return accumulator is zeroed after it is recorded. After each
update the parameters, ``rms``, ``ret_rms``, ``ret_accum``, ``last_obs``
and the metrics are held at ``rtol=1e-4, atol=1e-5``, the tolerance
``test_kernel_update_matches_jax`` uses (Adam or RMSprop steps over f32
losses summed in another order). PPO's minibatches are env-sliced
(``shuffle_minibatches=False``); A2C's one minibatch needs no permutation.

The Newsvendor PPO case starts both learners from the obs statistics of a
random-policy rollout (``RandomAgent.device_policy`` through the port's
``vecenv.rollout``), as every update after a learner's first one does. From
unit statistics its raw obs (orders up to 2,000) drive tanh units past
x = 8, where XLA's CPU tanh is exactly 1 and torch's is not until x = 9, so
1 - tanh^2 differs by up to 100% and Adam's first steps carry that into the
value trunk at 1e-3 relative. The Newsvendor A2C case (RMSprop) runs from
unit statistics within the tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import io_callback
import pytest
import torch

from or_gym_inventory_torch.agents import a2c as ta2c
from or_gym_inventory_torch.agents.base import RandomAgent
from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import vecenv as tvecenv
from or_gym_inventory_tpu.agents import a2c as ja2c
from or_gym_inventory_tpu.agents import networks as jnetworks
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.vector import vecenv as jvecenv

CPU = "cpu"
ENVS, STEPS, UPDATES = 8, 8, 2
TOL = dict(rtol=1e-4, atol=1e-5)
NET = dict(num_envs=ENVS, rollout_steps=STEPS, pi_arch=(16, 16), vf_arch=(16, 16))
PPO = dict(NET, num_minibatches=4, update_epochs=2, shuffle_minibatches=False)


def _family(name):
    """(JAX module, port module, JAX params, port params, retail links)."""
    if name == "newsvendor":
        jp = jnv.default_params(step_limit=12)
        return jnv, tnv, jp, tnv.NewsvendorParams(**dataclasses.asdict(jp)), 0
    if name == "inv_management":
        jp = jim.default_params(periods=10)
        return jim, tim, jp, interop.im_params_from_numpy(dataclasses.asdict(jp)), 0
    jp = jnet.default_params(num_periods=10)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), 10, jp.backlog,
                                       jp.alpha)
    return jnet, tnet, jp, tp, tp.topology.n_retail


class _Streams:
    """The NumPy draws of a run, handed out in the order a package asks for
    them: a step's normals, a step's demand, a reset's economics."""

    def __init__(self, family, tp, act_dim, n_retail, seed=0):
        r = np.random.default_rng(seed)
        S = UPDATES * STEPS
        self.noise = r.standard_normal((S, ENVS, act_dim)).astype(np.float32)
        if family == "newsvendor":
            self.demand = r.poisson(60.0, (S, ENVS)).astype(np.float32)
        elif family == "inv_management":
            self.demand = r.poisson(20.0, (S, ENVS)).astype(np.int32)
        else:
            self.demand = r.poisson(20.0, (S, ENVS, n_retail)).astype(np.float32)
        if family == "newsvendor":
            u = torch.from_numpy(r.random((S + 1, 5, ENVS)).astype(np.float32))
            self.econ = np.stack([torch.stack(tnv.econ_from_uniforms(tp, u[i])).T.numpy()
                                  for i in range(S + 1)])      # (S + 1, ENVS, 5)
        self.at = {"noise": 0, "demand": 0, "econ": 0}

    def next(self, what):
        i = self.at[what]
        self.at[what] += 1
        return getattr(self, what)[i]


def _patch(monkeypatch, family, jmod, tmod, js, ts):
    jreset, treset = jvecenv.batch_reset, tvecenv.batch_reset

    def j_draw(what):
        """The next ``what`` of js, read at run time in program order (an
        ordered io_callback, so once a step inside JAX's jitted scans)."""
        row = getattr(js, what)[0]
        return io_callback(lambda: js.next(what), jax.ShapeDtypeStruct(row.shape, row.dtype),
                           ordered=True)

    def j_sample(_key, mean, log_std):
        return mean + jnp.exp(jnp.clip(log_std, -10.0, 2.0)) * j_draw("noise")

    def j_step(env, params, state, action, _key, _n):
        return jax.vmap(env.step_with_demand, in_axes=(None, 0, 0, 0))(
            params, state, action, j_draw("demand"))

    def j_reset(env, params, key, num_envs):
        if family != "newsvendor":
            return jreset(env, params, key, num_envs)
        return jax.vmap(jnv.reset_with_econ, in_axes=(None, 0))(params, j_draw("econ"))

    def t_sample(_generator, mean, log_std):
        return mean + torch.exp(torch.clamp(log_std, -10.0, 2.0)) * torch.from_numpy(
            ts.next("noise"))

    def t_step(env, params, state, action, _generator):
        return env.step_with_demand(params, state, action, torch.from_numpy(ts.next("demand")))

    def t_reset(env, params, generator, num_envs, device=None):
        if family != "newsvendor":
            return treset(env, params, generator, num_envs, device=device)
        return tnv.reset_with_econ(params, torch.from_numpy(ts.next("econ")))

    for mod, name, fn in ((jnetworks, "gaussian_sample", j_sample),
                          (jvecenv, "batch_step", j_step), (jvecenv, "batch_reset", j_reset),
                          (tnetworks, "gaussian_sample", t_sample),
                          (tvecenv, "batch_step", t_step), (tvecenv, "batch_reset", t_reset)):
        monkeypatch.setattr(mod, name, fn)


def _rollout_rms(tmod, tp):
    """The obs statistics of one random-policy episode of ENVS envs."""
    policy = RandomAgent().device_policy(tmod.ENV, tp)
    _, traj = tvecenv.rollout(tmod.ENV, tp, policy, None, torch.Generator().manual_seed(5),
                              ENVS, tmod.ENV.horizon(tp), device=CPU)
    return tppo.RunningMeanStd.create(traj.obs.shape[-1], CPU).update(traj.obs)


def _assert_states_match(tstate, tmetrics, jstate, jmetrics, label):
    want = interop.ppo_params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.params),
                                         device=CPU)
    got = tstate.params.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=f"{label} {k}",
                                   **TOL)
    for name in ("rms", "ret_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(getattr(tstate, name), f).numpy(),
                                       np.asarray(getattr(getattr(jstate, name), f)),
                                       err_msg=f"{label} {name}.{f}", **TOL)
    for f in ("ret_accum", "last_obs"):
        np.testing.assert_allclose(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                   err_msg=f"{label} {f}", **TOL)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   err_msg=f"{label} {k}", **TOL)


CASES = {
    "nv_ppo": ("newsvendor", "ppo", {}),       # from a rollout's obs statistics
    "im_ppo": ("inv_management", "ppo", {}),
    "net_ppo": ("net_inv_management", "ppo", {}),
    "net_ppo_unnormalised": ("net_inv_management", "ppo",
                             dict(normalize_obs=False, normalize_reward=False)),
    "nv_a2c": ("newsvendor", "a2c", {}),
    "im_a2c": ("inv_management", "a2c", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_xla_updates_match_jax(monkeypatch, case):
    family, algo, extra = CASES[case]
    jmod, tmod, jp, tp, n_retail = _family(family)
    if algo == "ppo":
        jcfg, tcfg = jppo.PPOConfig(**PPO, **extra), tppo.PPOConfig(**PPO, **extra)
    else:
        jcfg, tcfg = ja2c.A2CConfig(**NET, **extra), ta2c.A2CConfig(**NET, **extra)
    assert tcfg.rollout == "xla" and tmod.ENV.horizon(tp) % STEPS
    act_dim = int(np.prod(tmod.ENV.action_space(tp).shape))
    rms = _rollout_rms(tmod, tp) if case == "nv_ppo" else None
    js, ts = (_Streams(family, tp, act_dim, n_retail) for _ in range(2))
    _patch(monkeypatch, family, jmod, tmod, js, ts)
    jstate = jppo.init_train_state(jmod.ENV, jp, jcfg, jax.random.PRNGKey(0), UPDATES)
    jupdate = jax.jit(jppo.make_update_fn(jmod.ENV, jp, jcfg, UPDATES))
    tstate = tppo.init_train_state(tmod.ENV, tp, tcfg, torch.Generator().manual_seed(0),
                                   UPDATES, device=CPU)
    tstate.params.load_state_dict(interop.ppo_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), device=CPU))
    if rms is not None:
        tstate = dataclasses.replace(tstate, rms=rms)
        jstate = jstate.replace(rms=jppo.RunningMeanStd(
            mean=jnp.asarray(rms.mean.numpy()), var=jnp.asarray(rms.var.numpy()),
            count=jnp.asarray(rms.count.numpy())))
    np.testing.assert_array_equal(tstate.last_obs.numpy(), np.asarray(jstate.last_obs))
    tupdate = tppo.make_update_fn(tmod.ENV, tp, tcfg, UPDATES, device=CPU)
    gen = torch.Generator().manual_seed(1)
    for u in range(UPDATES):
        jstate, jmetrics = jupdate(jstate, jax.random.PRNGKey(10 + u))
        tstate, tmetrics = tupdate(tstate, gen)
        _assert_states_match(tstate, tmetrics, jstate, jmetrics, f"{case}, update {u + 1}")
    # the second update ran past the horizon: episodes ended mid-rollout
    assert int(tmetrics["episodes"]) == ENVS
    assert tstate.update_idx == UPDATES
    assert js.at == ts.at and ts.at["noise"] == UPDATES * STEPS


def test_xla_refuses_compute_dtype():
    _, tmod, _, tp, _ = _family("newsvendor")
    with pytest.raises(ValueError, match="compute_dtype"):
        tppo.make_update_fn(tmod.ENV, tp, tppo.PPOConfig(compute_dtype="bfloat16"), 1,
                            device=CPU)
