"""Gloo ranks on the CPU for the port's data-parallel tests.

``spawn(job, tmp_path)`` runs ``python tests/torch_ranks.py <job> <rank>
<world> <tmp_path>`` once a rank, each in its own process that imports the
port and never JAX (``sys.modules["jax"]`` is blocked), joined through
``parallel.initialize_multihost`` on a ``FileStore`` in ``tmp_path`` with a
60 s collective timeout and one CPU thread. A rank reads the inputs the test
wrote to ``tmp_path / "inputs.pt"``, runs ``JOBS[job]`` and writes what it
returns to ``tmp_path / f"{job}_rank{rank}.pt"``; ``spawn`` returns those
dicts in rank order, or fails with the ranks' output.
"""

import copy
import dataclasses
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 60


def spawn(job: str, tmp_path, world: int = 2, timeout: float = 240) -> list:
    return start(job, tmp_path, world, timeout)()


def start(job: str, tmp_path, world: int = 2, timeout: float = 240):
    """Start the ranks of ``job``; returns ``wait()``, which waits for them
    (once) and returns their outputs in rank order."""
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r), str(world), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True) for r in range(world)]
    done = []

    def wait() -> list:
        if not done:
            done.append(_collect(job, procs, tmp_path, timeout))
        return done[0]
    return wait


def _collect(job, procs, tmp_path, timeout):
    import torch
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += f"\n[killed after {timeout} s]"
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {job} failed:\n{out[-4000:]}"
    return [torch.load(pathlib.Path(tmp_path) / f"{job}_rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


# ----------------------------------------------------------------- rank side

def _family_params():
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.envs import newsvendor as nv
    return {"net": (net.ENV, net.default_params(num_periods=4)),
            "im": (im.ENV, im.default_params(periods=4)),
            "nv": (nv.ENV, nv.default_params(step_limit=4))}


def policy_actor(env, params):
    """A seeded PPO actor of ``env`` folded for the policy kernels."""
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.ops import episode_kernels
    cfg = ppo.PPOConfig(pi_arch=(16,), vf_arch=(16,))
    model = ppo._make_model(env, params, cfg, torch.Generator().manual_seed(0))
    rms = ppo.RunningMeanStd.create(env.observation_space(params).shape[0], "cpu")
    return episode_kernels.fold_actor_params(cfg, model, rms)


MESH_LANES, MESH_EPISODES = 8, 2


def job_mesh(mesh, spec, tmp):
    """The sharded entry points and the collectives."""
    import torch

    from or_gym_inventory_torch.parallel import mesh as pm
    out = {}
    for fam, (env, params) in _family_params().items():
        out[f"random_{fam}"] = pm.sharded_random_episode_returns(
            params, torch.Generator().manual_seed(11), MESH_LANES, mesh,
            episodes_per_lane=MESH_EPISODES)
        out[f"policy_{fam}"] = pm.sharded_policy_episode_returns(
            params, policy_actor(env, params), torch.Generator().manual_seed(12), MESH_LANES,
            mesh, episodes_per_lane=MESH_EPISODES)
    env, params = _family_params()["nv"]
    space = env.action_space(params)

    def policy(_s, obs, g, _t):
        return space.sample(g, (obs.shape[0],), device=obs.device)

    traj, total = pm.sharded_rollout(env, params, policy, None, torch.Generator().manual_seed(5),
                                     8, 3, mesh)
    out["rollout"] = (traj._asdict(), total)
    out["evaluate"] = pm.sharded_evaluate(env, params, policy, None,
                                          torch.Generator().manual_seed(6), 8, mesh)
    r = float(mesh.rank + 1)
    out["sum"] = mesh.sum([torch.tensor([r, 2 * r]), torch.tensor(r)])
    out["mean"] = mesh.mean([torch.tensor([r, 2 * r])])
    out["gather"] = (mesh.gather(torch.full((2, 3), r)),
                     mesh.gather(torch.full((2, 3), r), dim=1),
                     mesh.gather(torch.tensor([mesh.rank == 0])))
    out["broadcast"] = mesh.broadcast_object({"from": mesh.rank})
    out["shard"] = pm.shard_batch({"x": torch.arange(8), "y": (torch.arange(4),)}, mesh)
    out["rank_seed"] = mesh.rank_seed(torch.Generator().manual_seed(3))
    return out


def job_updates(mesh, spec, tmp):
    """One data-parallel update of PPO and recurrent PPO (kernel paths) on
    the inputs the test made: the initial parameters and each rank's
    trajectory. Also the running statistics on each rank's half of a
    batch."""
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.agents import recurrent_ppo as rppo
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    r = mesh.rank
    out = {}

    rms = ppo.RunningMeanStd.create(spec["rms_batches"].shape[-1], "cpu")
    for x in spec["rms_batches"]:
        rms = rms.update(x[r], mesh)
        out.setdefault("rms", []).append(dataclasses.asdict(rms))

    s = spec["ppo"]
    cfg = ppo.PPOConfig(**s["recipe"])
    local = cfg.num_envs // mesh.size
    state = ppo.init_train_state(net.ENV, s["params"], cfg, torch.Generator().manual_seed(0), 3,
                                 device="cpu", local_envs=local)
    state.params.load_state_dict(s["model"])
    ns.rollout_traj_net = lambda *a, **k: s["traj"][r]
    update = ppo.make_update_fn(net.ENV, s["params"], cfg, 3, device="cpu", mesh=mesh)
    new, metrics = update(state, torch.Generator().manual_seed(1))
    out["ppo"] = dict(params=new.params.state_dict(), rms=dataclasses.asdict(new.rms),
                      ret_rms=dataclasses.asdict(new.ret_rms),
                      metrics={k: float(v) for k, v in metrics.items()})

    s = spec["rppo"]
    cfg = rppo.RecurrentPPOConfig(**s["recipe"])
    init, update, _ = rppo.make_train_fns(im.ENV, s["params"], cfg, 3, device="cpu", mesh=mesh,
                                          local_envs=cfg.num_envs // mesh.size)
    state = init(torch.Generator().manual_seed(0))
    state.params.load_state_dict(s["model"])
    ek.rollout_traj_im_lstm = lambda *a, **k: s["traj"][r]
    new, metrics = update(state, torch.Generator().manual_seed(1))
    out["rppo"] = dict(params=new.params.state_dict(), rms=dataclasses.asdict(new.rms),
                       ret_rms=dataclasses.asdict(new.ret_rms),
                       metrics={k: float(v) for k, v in metrics.items()})
    return out


def job_offpolicy(mesh, spec, tmp):
    """Two data-parallel iterations of SAC, TD3 and DDPG (``update_kernel``)
    on the inputs the test made: the initial networks, each rank's
    trajectory and each rank's minibatch rows and normals."""
    import torch

    from or_gym_inventory_torch.agents import off_policy as op
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    r = mesh.rank
    out = {}
    for algo, s in spec["offpolicy"].items():
        cfg = op.OffPolicyConfig(**s["recipe"])
        init, update, _ = op.make_offpolicy(im.ENV, s["params"], cfg, mesh=mesh, device="cpu")
        state = init(torch.Generator().manual_seed(0))
        for name, module in s["modules"].items():
            getattr(state, name).load_state_dict(module)
        ek.rollout_traj_im_offpolicy = lambda *a, _tr=s["traj"][r], **k: _tr
        its = []
        for idx, z in s["draws"][r]:
            state, metrics = update.iterate(state, 0, idx, z)
            its.append(dict(
                modules={n: copy.deepcopy(getattr(state, n).state_dict())
                         for n in s["modules"]},
                log_alpha=state.log_alpha.clone(), rms=dataclasses.asdict(state.rms),
                buffer={f: getattr(state.buffer, f).clone() for f in op.ReplayBuffer.FIELDS},
                ptr=state.buffer.ptr, filled=state.buffer.filled,
                metrics={k: float(v) for k, v in metrics.items()}))
        out[algo] = its
    return out


def _train_params(fam):
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.envs import newsvendor as nv
    return {"net": (net.ENV, net.default_params(num_periods=8)),
            "im": (im.ENV, im.default_params(periods=8)),
            "nv": (nv.ENV, nv.default_params(step_limit=8))}[fam]


def train_cases() -> dict:
    """__graft_entry__.dryrun_multichip's roster at 2 ranks, on both paths
    (the kernel paths at rollout_steps = the horizon, recurrent PPO's on
    InvManagement), and tests/test_off_policy.py:143-160's n-step run:
    {label: (learner, family, config, total_timesteps, log_every)}."""
    from or_gym_inventory_torch.agents import a2c
    from or_gym_inventory_torch.agents import off_policy as op
    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.agents import recurrent_ppo as rppo
    cases = {}
    for label, cfg in (("ppo", ppo.PPOConfig(num_envs=8, rollout_steps=4, num_minibatches=2,
                                             update_epochs=2, pi_arch=(16,), vf_arch=(16,))),
                       ("a2c", a2c.A2CConfig(num_envs=8, rollout_steps=4, pi_arch=(16,),
                                             vf_arch=(16,)))):
        cases[f"{label}-xla"] = ("ppo", "net", cfg, 8 * 4, None)
        cases[f"{label}-kernel"] = ("ppo", "net", cfg.replace(rollout="kernel", rollout_steps=8),
                                    8 * 8, None)
    for label, cfg in (("rppo", rppo.RecurrentPPOConfig(num_envs=4, rollout_steps=4,
                                                        num_minibatches=2, update_epochs=1,
                                                        hidden=8, encoder=(8,))),
                       ("a2c_lstm", rppo.A2CLSTMConfig(num_envs=4, rollout_steps=4, hidden=8,
                                                       encoder=(8,)))):
        cases[f"{label}-xla"] = ("rppo", "net", cfg, 4 * 4, None)
        cases[f"{label}-kernel"] = ("rppo", "im", cfg.replace(rollout="kernel", rollout_steps=8),
                                    4 * 8, None)
    for algo in ("sac", "td3", "ddpg"):
        cfg = op.OffPolicyConfig(algo=algo, num_envs=4, buffer_size=64, batch_size=16,
                                 start_steps=0, pi_arch=(16,), q_arch=(16,))
        cases[f"{algo}-xla"] = ("off", "net", cfg, 4 * 4, 4)
        cases[f"{algo}-kernel"] = ("off", "net", cfg.replace(collect="kernel"), 4 * 8 * 2, 4)
    cases["sac-nstep"] = ("off", "nv", op.OffPolicyConfig(
        algo="sac", num_envs=4, buffer_size=1024, batch_size=16, n_step=3, start_steps=0,
        pi_arch=(16,), q_arch=(16,)), 4 * 20, 20)
    return cases


AGENT_CASES = (("PPO", "Newsvendor-v0", dict(num_envs=8, rollout_steps=4), 32),
               ("A2C", "InvManagementBacklog-v0", dict(num_envs=8, rollout_steps=4), 32),
               ("SAC", "NetInvMgmtBacklog-v0", dict(num_envs=4, buffer_size=64, batch_size=16,
                                                    start_steps=0), 16),
               ("TD3", "InvManagementBacklog-v0", dict(num_envs=4, buffer_size=64,
                                                       batch_size=16, start_steps=0), 16),
               ("DDPG", "Newsvendor-v0", dict(num_envs=4, buffer_size=64, batch_size=16,
                                              start_steps=0), 16),
               ("PPO_LSTM", "InvManagementBacklog-v0", dict(num_envs=4, rollout_steps=4,
                                                            num_minibatches=2, hidden=8), 16),
               ("A2C_LSTM", "NetInvMgmtBacklog-v0", dict(num_envs=4, rollout_steps=4,
                                                         hidden=8), 16))


def _modules_of(state) -> dict:
    """Every parameter tensor of a learner's state, by module and name."""
    names = ("params",) if hasattr(state, "params") else (
        "actor_params", "q_params", "target_actor_params", "target_q_params")
    return {f"{n}.{k}": v.detach().clone() for n in names
            for k, v in getattr(state, n).state_dict().items()}


def job_train(mesh, spec, tmp):
    """Every learner's ``train(mesh=)``, then ``make_agent``'s seven names
    with ``mesh=``: trained, saved by rank 0 alone, and skipped on a second
    ``train`` on every rank."""
    import contextlib
    import io

    import torch

    from or_gym_inventory_torch.agents import make_agent
    from or_gym_inventory_torch.agents import off_policy as op
    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.agents import recurrent_ppo as rppo
    out = {}
    for label, (learner, fam, cfg, total, log_every) in train_cases().items():
        env, params = _train_params(fam)
        gen = torch.Generator().manual_seed(3)
        if learner == "ppo":
            state, metrics = ppo.train(env, params, cfg, gen, total, mesh=mesh)
        elif learner == "rppo":
            state, _, metrics = rppo.train(env, params, cfg, gen, total, mesh=mesh)
        else:
            state, _, metrics = op.train(env, params, cfg, gen, total, log_every=log_every,
                                         mesh=mesh)
        out[label] = dict(modules=_modules_of(state), metrics=metrics,
                          local_envs=state.last_obs.shape[0],
                          filled=state.buffer.filled if learner == "off" else None,
                          device=str(state.last_obs.device))
    for name, env_id, updates, budget in AGENT_CASES:
        kw = dict(model_dir=str(tmp / "models" / name), log_dir=str(tmp / "logs" / name),
                  mesh=mesh)
        agent = make_agent(name, env_id, config_updates=updates, **kw)
        saves = []
        real_save = agent.save
        agent.save = lambda *a, **k: saves.append(mesh.rank) or real_save(*a, **k)
        agent.train({}, budget)
        state = agent.train_state if hasattr(agent, "train_state") else agent.state
        written = os.path.exists(agent._ckpt_path())
        again = make_agent(name, env_id, config_updates=updates, **kw)
        with contextlib.redirect_stdout(io.StringIO()) as said:
            again.train({}, budget)
        out[name] = dict(modules=_modules_of(state), saves=saves, written=written,
                         skipped="Loading existing model" in said.getvalue(),
                         time=again.get_training_time(), type=type(agent).__name__)
    return out


def ckpt_tree(state, generator):
    """A PPO train state and its rank generator as ``OrbaxCheckpointer``'s
    tree: the replicated parameters, optimizer state and statistics, and this
    rank's envs, obs, return accumulator and generator under ``PerRank``."""
    from or_gym_inventory_torch.utils import checkpoint
    return checkpoint.to_tree({
        "params": state.params, "opt": state.opt_state, "rms": state.rms,
        "ret_rms": state.ret_rms, "update_idx": state.update_idx,
        "rank": checkpoint.PerRank({"env_state": state.env_state, "last_obs": state.last_obs,
                                    "ret_accum": state.ret_accum, "generator": generator}),
        "shared_obs": state.last_obs})


def job_ckpt(mesh, spec, tmp):
    """A two-update PPO run (xla path, Newsvendor, episodes that span the
    updates) against one saved after its first update and resumed from a
    fresh state on the restored checkpoint; the save runs while the resumed
    run's collectives do."""
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.utils import checkpoint
    params = nv.default_params(step_limit=8)
    cfg = ppo.PPOConfig(num_envs=8, rollout_steps=5, num_minibatches=2, update_epochs=1,
                        pi_arch=(16,), vf_arch=(16,))
    update = ppo.make_update_fn(nv.ENV, params, cfg, 2, device="cpu", mesh=mesh)

    def fresh(seed):
        g = torch.Generator().manual_seed(seed)
        rank_gen = mesh.rank_generator(g)
        return ppo.init_train_state(nv.ENV, params, cfg, g, 2, device="cpu", local_envs=4,
                                    env_generator=rank_gen), rank_gen

    state, gen = fresh(0)
    state, _ = update(state, gen)
    after1 = ckpt_tree(state, gen)
    state, _ = update(state, gen)
    out = {"uninterrupted": _modules_of(state), "after1": after1}

    ck = checkpoint.OrbaxCheckpointer(str(tmp / "ckpt"), max_to_keep=1)
    state, gen = fresh(0)
    state, _ = update(state, gen)
    ck.save(1, ckpt_tree(state, gen))
    state, _ = update(state, gen)        # runs while the save does
    ck.save(2, ckpt_tree(state, gen))
    ck.wait()
    out["steps"] = ck.all_steps()
    state2, gen2 = fresh(1)
    out["latest_update_idx"] = ck.restore(template=ckpt_tree(state2, gen2))["update_idx"]

    ck1 = checkpoint.OrbaxCheckpointer(str(tmp / "ckpt1"))
    state, gen = fresh(0)
    state, _ = update(state, gen)
    ck1.save(1, ckpt_tree(state, gen))
    ck1.wait()
    state2, gen2 = fresh(1)
    tree = ck1.restore(template=ckpt_tree(state2, gen2))
    out["restored"] = tree
    out["untemplated"] = ck1.restore(1)
    resumed = ppo.PPOTrainState(
        params=checkpoint.restore(state2.params, tree["params"]),
        opt_state=checkpoint.restore(state2.opt_state, tree["opt"]),
        rms=checkpoint.restore(state2.rms, tree["rms"]),
        ret_rms=checkpoint.restore(state2.ret_rms, tree["ret_rms"]),
        ret_accum=tree["rank"]["ret_accum"],
        env_state=checkpoint.restore(state2.env_state, tree["rank"]["env_state"]),
        last_obs=tree["rank"]["last_obs"], update_idx=tree["update_idx"])
    checkpoint.restore(gen2, tree["rank"]["generator"])
    resumed, _ = update(resumed, gen2)
    out["resumed"] = _modules_of(resumed)
    return out


JOBS = {"mesh": job_mesh, "updates": job_updates, "offpolicy": job_offpolicy,
        "train": job_train, "ckpt": job_ckpt}


def main():
    sys.modules["jax"] = None   # a rank imports the port alone
    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        pathlib.Path(sys.argv[4])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from or_gym_inventory_torch.parallel import initialize_multihost, make_mesh
    initialize_multihost(f"file://{tmp / (job + '.store')}", world, rank, backend="gloo",
                         timeout=RANK_TIMEOUT_S)
    inputs = tmp / "inputs.pt"
    spec = torch.load(inputs, weights_only=False) if inputs.exists() else {}
    out = JOBS[job](make_mesh("cpu"), spec, tmp)
    torch.save(out, tmp / f"{job}_rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
