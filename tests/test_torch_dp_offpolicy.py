"""Two data-parallel iterations of the port's SAC, TD3 and DDPG
(``update_kernel``) on two gloo ranks against the JAX package's
``shard_map`` update on two of the conftest's CPU devices.

The ranks run once for the module (``torch_ranks.start("offpolicy", ...)``,
processes that import the port alone). As tests/test_torch_off_policy.py
does for one device: JAX's initial networks (its sharded init) are loaded
into the port; each shard gets its own trajectory, made by the port's
plain K27 on the CPU (seeds 9 and 10), which JAX's patched rollout picks by
``axis_index``; each rank takes the minibatch rows and normals that its
shard's JAX key draws. ``jax.default_backend`` answers "tpu" only while
JAX builds its functions.

Checked after each of two iterations (2 x 1,024 envs, one period, one
gradient step each, TD3's delayed actor skipped at the second): networks,
targets, temperature, statistics and metrics within ``rtol=1e-4,
atol=1e-5``; each rank's buffer slice, its pointer and fill exactly; rank
0's and rank 1's networks bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
from or_gym_inventory_torch.agents import off_policy as top
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.agents import off_policy as jop
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek
from test_torch_dp_updates import (CPU, LOCAL, TOL, WORLD, _as_tpu, _close_rms, _im,
                                   _jax_sharded_init, _jmesh, _np, _shard_pick)
from test_torch_off_policy import _jax_draws

ALGOS = ("sac", "td3", "ddpg")
OFF_BATCH, OFF_ITERS = 32, 2


def _off_recipe(algo):
    return dict(algo=algo, collect="kernel", num_envs=WORLD * LOCAL,
                buffer_size=2 * WORLD * LOCAL, batch_size=OFF_BATCH, pi_arch=(16, 16),
                q_arch=(16, 16), start_steps=0)


def _off_spec():
    return jop.OffPolicyState(
        actor_params=P(), q_params=P(), target_q_params=P(), target_actor_params=P(),
        log_alpha=P(), actor_opt=P(), q_opt=P(), alpha_opt=P(), rms=P(),
        buffer=jop.ReplayBuffer(obs=P("env"), action=P("env"), reward=P("env"),
                                next_obs=P("env"), done=P("env"), disc=P("env"), ptr=P(),
                                filled=P()),
        env_state=P("env"), last_obs=P("env"), step_idx=P(), window=P(None, "env"))


def _off_keys(it):
    return [jax.random.PRNGKey(10 + it), jax.random.PRNGKey(20 + it)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs of the three learners, written for the ranks, JAX's
    initial sharded states, and ``wait()`` for the ranks' outputs."""
    spec = {}
    jp, tp = _im(1)
    spec["offpolicy"] = {}
    jstates = {}
    for algo in ALGOS:
        jcfg = jop.OffPolicyConfig(**_off_recipe(algo))
        jinit, _, _ = _as_tpu(lambda: jop.make_offpolicy(jim.ENV, jp, jcfg, axis_name="env",
                                                         local_envs=LOCAL))
        jstate = _jax_sharded_init(jinit, _off_spec())
        jstates[algo] = jstate
        stochastic = algo == "sac"
        a_sd, q_sd = interop.offpolicy_params_from_numpy(
            _np(jstate.actor_params), _np(jstate.q_params), stochastic, device=CPU)
        modules = dict(actor_params=a_sd, q_params=q_sd, target_actor_params=a_sd,
                       target_q_params=q_sd)
        tcfg = top.OffPolicyConfig(**_off_recipe(algo))
        tinit, _, _ = top.make_offpolicy(tim.ENV, tp, tcfg, local_envs=LOCAL, device=CPU)
        tstate = tinit(torch.Generator().manual_seed(0))
        tstate.actor_params.load_state_dict(a_sd)
        actor_f = tek.fold_offpolicy_actor((16, 16), tstate.actor_params, None, stochastic)
        log_std = torch.full((3,), float(np.log(np.float32(0.1))))
        mode = "sac" if stochastic else "det"
        draws = [[_jax_draws(_off_keys(it)[r], 1, OFF_BATCH, 3,
                             min((it + 1) * LOCAL, 2 * LOCAL), algo) for it in range(OFF_ITERS)]
                 for r in range(WORLD)]
        spec["offpolicy"][algo] = dict(
            recipe=_off_recipe(algo), params=tp, modules=modules, draws=draws, traj=[
                tek.rollout_traj_im_offpolicy(tp, actor_f, log_std, 9 + r, LOCAL, mode, "relu",
                                              CPU) for r in range(WORLD)])

    tmp = tmp_path_factory.mktemp("offpolicy")
    torch.save(spec, tmp / "inputs.pt")
    return spec, jstates, torch_ranks.start("offpolicy", tmp, WORLD)


@pytest.mark.parametrize("algo", ALGOS)
def test_offpolicy_iterations_match_shard_map(setup, monkeypatch, algo):
    spec, jstates, wait = setup
    jp, _ = _im(1)
    jcfg = jop.OffPolicyConfig(**_off_recipe(algo))
    monkeypatch.setattr(jek, "rollout_traj_im", _shard_pick(spec["offpolicy"][algo]["traj"]))
    _, jupdate, _ = _as_tpu(lambda: jop.make_offpolicy(jim.ENV, jp, jcfg, axis_name="env",
                                                       local_envs=LOCAL))
    jstate = jstates[algo]
    fn = jax.jit(jax.shard_map(lambda s, ks: jupdate(s, ks[0]), mesh=_jmesh(),
                               in_specs=(_off_spec(), P("env")), out_specs=(_off_spec(), P()),
                               check_vma=False))
    stochastic = algo == "sac"
    ranks = None
    for it in range(OFF_ITERS):
        jstate, jmetrics = fn(jstate, jnp.stack(_off_keys(it)))
        ranks = ranks or wait()
        a_sd, q_sd = interop.offpolicy_params_from_numpy(
            _np(jstate.actor_params), _np(jstate.q_params), stochastic, device=CPU)
        ta_sd, tq_sd = interop.offpolicy_params_from_numpy(
            _np(jstate.target_actor_params), _np(jstate.target_q_params), stochastic, device=CPU)
        want = dict(actor_params=a_sd, q_params=q_sd, target_actor_params=ta_sd,
                    target_q_params=tq_sd)
        for r, out in enumerate(ranks):
            got = out[algo][it]
            for name, sd in want.items():
                for k in sd:
                    np.testing.assert_allclose(got["modules"][name][k].numpy(), sd[k].numpy(),
                                               err_msg=f"it {it} {name} {k}", **TOL)
            np.testing.assert_allclose(float(got["log_alpha"]), float(jstate.log_alpha), **TOL)
            _close_rms(got["rms"], jstate.rms, name=f"it {it} rms")
            for f in top.ReplayBuffer.FIELDS:
                block = np.asarray(getattr(jstate.buffer, f)).reshape(
                    (WORLD, -1) + got["buffer"][f].shape[1:])[r]
                np.testing.assert_array_equal(got["buffer"][f].numpy(), block, f"{f} rank {r}")
            assert got["ptr"] == int(jstate.buffer.ptr)
            assert got["filled"] == int(jstate.buffer.filled) == min((it + 1) * LOCAL, 2 * LOCAL)
            for k in jmetrics:
                np.testing.assert_allclose(got["metrics"][k], float(jmetrics[k]),
                                           err_msg=k, **TOL)
        for name in want:
            for k, v in ranks[0][algo][it]["modules"][name].items():
                assert torch.equal(v, ranks[1][algo][it]["modules"][name][k]), (it, name, k)
