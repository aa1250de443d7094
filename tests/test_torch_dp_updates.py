"""One data-parallel update of the port's PPO and recurrent PPO on two gloo
ranks against the JAX package's ``shard_map`` update on two of the
conftest's CPU devices (SAC, TD3 and DDPG: tests/test_torch_dp_offpolicy.py).

The ranks run once for the module (``torch_ranks.start("updates", ...)``,
processes that import the port alone). Each learner's inputs are made here
and handed to both sides, as the single-device tests hand them
(tests/test_torch_ppo.py, test_torch_recurrent_ppo.py): the initial
parameters from JAX's init, and for each shard its own trajectory, made by
the port's plain kernel on the CPU (seeds 5 and 6). JAX's rollout is
patched to pick the shard's trajectory by ``axis_index``; the port's by its
rank. ``jax.default_backend`` answers "tpu" only while JAX builds its
functions.

Checked: PPO (kernel path, ``tests/test_torch_ppo.py``'s recipe at 2 x
1,024 envs) and recurrent PPO (kernel path, 2 x 1,024 envs): parameters,
both running statistics and the metrics within ``rtol=1e-4, atol=1e-5``;
rank 0's and rank 1's parameters bit for bit. The running statistics
alone, summed over the ranks, within ``rtol=1e-6, atol=1e-6`` of
``update(batch, axis_name)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_ranks
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.agents import recurrent_ppo as trppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.agents import recurrent_ppo as jrppo
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek
from or_gym_inventory_tpu.ops import pallas_net_step as pns

CPU = "cpu"
WORLD, LOCAL, STEPS = 2, 1024, 6
TOL = dict(rtol=1e-4, atol=1e-5)
PPO_RECIPE = dict(num_envs=WORLD * LOCAL, rollout_steps=STEPS, num_minibatches=4,
                  update_epochs=2, pi_arch=(16, 16), vf_arch=(16, 16), rollout="kernel",
                  shuffle_minibatches=False)
RPPO_RECIPE = dict(num_envs=WORLD * LOCAL, rollout_steps=STEPS, num_minibatches=1,
                   update_epochs=2, hidden=16, encoder=(8,), rollout="kernel")
def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jmesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("env",))


def _as_tpu(build):
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        return build()


def _shard_pick(trajs):
    """A patched JAX rollout returning the calling shard's trajectory."""
    stacked = {k: jnp.stack([jnp.asarray(t[k].numpy()) for t in trajs]) for k in trajs[0]}
    return lambda *a, **k: {n: v[jax.lax.axis_index("env")] for n, v in stacked.items()}


def _im(periods):
    jp = jim.default_params(periods=periods)
    return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))


def _net():
    jp = jnet.default_params(num_periods=STEPS)
    return jp, interop.net_params_from_numpy(dataclasses.asdict(jp.topology), STEPS,
                                             jp.backlog, jp.alpha)


def _jax_ppo_state():
    jp, tp = _net()
    jcfg = jppo.PPOConfig(**PPO_RECIPE)
    return jp, tp, jcfg, jppo.init_train_state(jnet.ENV, jp, jcfg, jax.random.PRNGKey(0), 3,
                                               local_envs=LOCAL)


def _jax_sharded_init(init, state_spec):
    return jax.jit(jax.shard_map(init, mesh=_jmesh(), in_specs=P(), out_specs=state_spec,
                                 check_vma=False))(jax.random.PRNGKey(0))


def _rppo_spec():
    return jrppo.RPPOTrainState(params=P(), opt_state=P(), rms=P(), ret_rms=P(),
                                ret_accum=P("env"), env_state=P("env"), last_obs=P("env"),
                                last_done=P("env"), carry=P("env"), update_idx=P())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs of both learners, written for the ranks, JAX's initial
    recurrent state, and ``wait()`` for the ranks' outputs (the ranks run
    while the cases compute JAX's side)."""
    spec = {"rms_batches": torch.from_numpy(np.stack([
        np.random.default_rng(k).normal(0.5 * k, 1.0 + k, (WORLD, 257, 5))
        for k in range(3)]).astype(np.float32))}

    jp, tp, jcfg, jstate = _jax_ppo_state()
    tcfg = tppo.PPOConfig(**PPO_RECIPE)
    tstate = tppo.init_train_state(tnet.ENV, tp, tcfg, torch.Generator().manual_seed(0), 3,
                                   device=CPU, local_envs=LOCAL)
    model = interop.ppo_params_from_numpy(_np(jstate.params), device=CPU)
    tstate.params.load_state_dict(model)
    actor = tek.fold_actor_params(tcfg, tstate.params, tstate.rms)
    spec["ppo"] = dict(recipe=PPO_RECIPE, params=tp, model=model, traj=[
        tns.rollout_traj_net(tp, actor, tstate.params.log_std.detach(), 5 + r, LOCAL,
                             device=CPU) for r in range(WORLD)])

    jp, tp = _im(STEPS)
    jcfg = jrppo.RecurrentPPOConfig(**RPPO_RECIPE)
    jinit, _, _ = _as_tpu(lambda: jrppo.make_train_fns(jim.ENV, jp, jcfg, 3, axis_name="env",
                                                       local_envs=LOCAL))
    jstate = _jax_sharded_init(jinit, _rppo_spec())
    tcfg = trppo.RecurrentPPOConfig(**RPPO_RECIPE)
    tinit, _, _ = trppo.make_train_fns(tim.ENV, tp, tcfg, 3, device=CPU, local_envs=LOCAL)
    tstate = tinit(torch.Generator().manual_seed(0))
    model = interop.lstm_params_from_numpy(_np(jstate.params), device=CPU)
    tstate.params.load_state_dict(model)
    actor = tek.fold_lstm_actor(tcfg, tstate.params, tstate.rms)
    spec["rppo"] = dict(recipe=RPPO_RECIPE, params=tp, model=model, jstate=jstate, traj=[
        tek.rollout_traj_im_lstm(tp, actor, tstate.params.log_std.detach(), 5 + r, LOCAL,
                                 device=CPU) for r in range(WORLD)])

    jstates = {"rppo": spec["rppo"].pop("jstate")}
    tmp = tmp_path_factory.mktemp("updates")
    torch.save(spec, tmp / "inputs.pt")
    return spec, jstates, torch_ranks.start("updates", tmp, WORLD)


def _close_rms(got, want, tol=TOL, name=""):
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(np.asarray(got[f]), np.asarray(getattr(want, f)),
                                   err_msg=f"{name}.{f}", **tol)


def _ranks_equal(ranks, key, get):
    for out in ranks[1:]:
        a, b = get(ranks[0][key]), get(out[key])
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), f"{key} {k}: the ranks differ"


def test_running_mean_std_sums_over_ranks(setup):
    spec, _, wait = setup
    batches = spec["rms_batches"].numpy()

    def upd(rms, x):
        return rms.update(x[0], "env")

    fn = jax.jit(jax.shard_map(upd, mesh=_jmesh(), in_specs=(P(), P("env")), out_specs=P(),
                               check_vma=False))
    j = jppo.RunningMeanStd.create(5)
    ranks = wait()
    for k, x in enumerate(batches):
        j = fn(j, jnp.asarray(x))
        for out in ranks:
            _close_rms(out["rms"][k], j, dict(rtol=1e-6, atol=1e-6), f"batch {k}")
    assert all(torch.equal(ranks[0]["rms"][-1][f], ranks[1]["rms"][-1][f])
               for f in ("mean", "var", "count"))


def test_ppo_kernel_update_matches_shard_map(setup, monkeypatch):
    spec, _, wait = setup
    jp, _, jcfg, jstate = _jax_ppo_state()
    monkeypatch.setattr(pns, "rollout_traj_net", _shard_pick(spec["ppo"]["traj"]))
    jupdate = _as_tpu(lambda: jppo.make_update_fn(jnet.ENV, jp, jcfg, 3, axis_name="env"))
    spec_ = jppo.PPOTrainState(params=P(), opt_state=P(), rms=P(), ret_rms=P(),
                               ret_accum=P("env"), env_state=P("env"), last_obs=P("env"),
                               update_idx=P())
    jglobal = dataclasses.replace(jstate, **{
        f: jax.tree_util.tree_map(lambda a: jnp.concatenate([a] * WORLD), getattr(jstate, f))
        for f in ("ret_accum", "env_state", "last_obs")})
    fn = jax.shard_map(lambda s, ks: jupdate(s, ks[0]), mesh=_jmesh(),
                       in_specs=(spec_, P("env")), out_specs=(spec_, P()), check_vma=False)
    jnew, jmetrics = jax.jit(fn)(jglobal, jax.random.split(jax.random.PRNGKey(1), WORLD))
    want = interop.ppo_params_from_numpy(_np(jnew.params), device=CPU)
    ranks = wait()
    got = ranks[0]["ppo"]
    for k in want:
        np.testing.assert_allclose(got["params"][k].numpy(), want[k].numpy(), err_msg=k, **TOL)
    _close_rms(got["rms"], jnew.rms, name="rms")
    _close_rms(got["ret_rms"], jnew.ret_rms, name="ret_rms")
    assert set(got["metrics"]) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(got["metrics"][k], float(jmetrics[k]), err_msg=k, **TOL)
    _ranks_equal(ranks, "ppo", lambda o: o["params"])
    assert ranks[0]["ppo"]["metrics"]["mean_step_reward"] == \
        ranks[1]["ppo"]["metrics"]["mean_step_reward"]


def test_recurrent_kernel_update_matches_shard_map(setup, monkeypatch):
    spec, jstates, wait = setup
    jp, _ = _im(STEPS)
    jcfg = jrppo.RecurrentPPOConfig(**RPPO_RECIPE)
    monkeypatch.setattr(jek, "rollout_traj_im_lstm", _shard_pick(spec["rppo"]["traj"]))
    _, jupdate, _ = _as_tpu(lambda: jrppo.make_train_fns(jim.ENV, jp, jcfg, 3, axis_name="env",
                                                         local_envs=LOCAL))
    fn = jax.shard_map(lambda s, ks: jupdate(s, ks[0]), mesh=_jmesh(),
                       in_specs=(_rppo_spec(), P("env")), out_specs=(_rppo_spec(), P()),
                       check_vma=False)
    jnew, jmetrics = jax.jit(fn)(jstates["rppo"], jax.random.split(jax.random.PRNGKey(1), WORLD))
    want = interop.lstm_params_from_numpy(_np(jnew.params), device=CPU)
    ranks = wait()
    got = ranks[0]["rppo"]
    for k in want:
        np.testing.assert_allclose(got["params"][k].numpy(), want[k].numpy(), err_msg=k, **TOL)
    _close_rms(got["rms"], jnew.rms, name="rms")
    _close_rms(got["ret_rms"], jnew.ret_rms, name="ret_rms")
    assert set(got["metrics"]) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(got["metrics"][k], float(jmetrics[k]), err_msg=k, **TOL)
    _ranks_equal(ranks, "rppo", lambda o: o["params"])
