"""PPO on the kernel path (agents/ppo.py, agents/a2c.py) against the JAX
package: the running statistics, the optimizer step for step against optax,
one whole kernel-path update against JAX's ``update_kernel``, and the
gradient accumulation of ``minibatch_chunks``.

The update is compared on one trajectory, made by the port's plain K4 on the
CPU and handed to both sides: ``pallas_net_step.rollout_traj_net`` and the
port's ``net_step.rollout_traj_net`` are patched to return it, and
``jax.default_backend`` answers "tpu" only while JAX builds its update.
Nothing in the JAX package changes. Tolerances: ``rtol=1e-5, atol=1e-5`` for
the statistics and the optimizer (f32, sums in another order);
``rtol=1e-4, atol=1e-5`` for the update's new parameters, statistics and
metrics (eight Adam steps over f32 losses summed in another order);
``atol=1e-6`` for chunked against unchunked gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from or_gym_inventory_torch.agents import a2c as ta2c
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.parallel import make_mesh
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.agents import a2c as ja2c
from or_gym_inventory_tpu.agents import ppo as jppo
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.ops import pallas_net_step as pns

CPU = "cpu"
STEPS, ENVS = 6, 1024
RECIPE = dict(num_envs=ENVS, rollout_steps=STEPS, num_minibatches=4, update_epochs=2,
              pi_arch=(16, 16), vf_arch=(16, 16), rollout="kernel",
              shuffle_minibatches=False)


def test_running_mean_std_matches_jax():
    r = np.random.default_rng(0)
    j = jppo.RunningMeanStd.create(5)
    t = tppo.RunningMeanStd.create(5, CPU)
    for k in range(3):
        x = r.normal(10.0 * k, 3.0 + k, (257, 5)).astype(np.float32)
        j = j.update(jnp.asarray(x))
        t = t.update(torch.from_numpy(x))
        for a, b in ((t.mean, j.mean), (t.var, j.var), (t.count, j.count)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(j.normalize(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("optimizer,anneal", [("adam", True), ("adam", False),
                                              ("rmsprop", True), ("rmsprop", False)])
def test_optimizer_matches_optax(optimizer, anneal):
    """Three steps on fixed gradients; the second one's norm is far above
    max_grad_norm, so the clip triggers there."""
    fields = dict(optimizer=optimizer, anneal_lr=anneal, update_epochs=1,
                  num_minibatches=2, lr=1e-2, max_grad_norm=0.5)
    tx = jppo._optimizer(jppo.PPOConfig(**fields), 3)
    opt = tppo.Optimizer(tppo.PPOConfig(**fields), 3)
    r = np.random.default_rng(1)
    jparams = {"a": jnp.asarray(r.normal(0, 1, (3, 4)), jnp.float32),
               "b": jnp.asarray(r.normal(0, 1, (5,)), jnp.float32)}
    tparams = [torch.from_numpy(np.array(jparams[k])) for k in ("a", "b")]
    jstate, tstate = tx.init(jparams), opt.init(tparams)
    for scale in (0.01, 50.0, 0.1):
        g = {"a": r.normal(0, scale, (3, 4)).astype(np.float32),
             "b": r.normal(0, scale, (5,)).astype(np.float32)}
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = opt.step(tparams, [torch.from_numpy(g["a"]), torch.from_numpy(g["b"])],
                          tstate)
        for k, p in zip(("a", "b"), tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-5)
    assert tstate.count == 3


def _net_params():
    jp = jnet.default_params(num_periods=STEPS)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), STEPS,
                                       jp.backlog, jp.alpha)
    return jp, tp


def _states(jp, tp, jcfg, tcfg):
    jstate = jppo.init_train_state(jnet.ENV, jp, jcfg, jax.random.PRNGKey(0), 3)
    tstate = tppo.init_train_state(tnet.ENV, tp, tcfg, torch.Generator().manual_seed(0),
                                   3, device=CPU)
    tstate.params.load_state_dict(interop.ppo_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params), device=CPU))
    return jstate, tstate


def _trajectory(tp, tcfg, tstate):
    actor = tek.fold_actor_params(tcfg, tstate.params, tstate.rms)
    return tns.rollout_traj_net(tp, actor, tstate.params.log_std.detach(), 5, ENVS,
                                device=CPU)


def test_kernel_update_matches_jax(monkeypatch):
    jp, tp = _net_params()
    jcfg, tcfg = jppo.PPOConfig(**RECIPE), tppo.PPOConfig(**RECIPE)
    jstate, tstate = _states(jp, tp, jcfg, tcfg)
    tr = _trajectory(tp, tcfg, tstate)
    jtr = {k: jnp.asarray(v.numpy()) for k, v in tr.items()}
    monkeypatch.setattr(pns, "rollout_traj_net", lambda *a, **k: jtr)
    monkeypatch.setattr(tns, "rollout_traj_net", lambda *a, **k: tr)
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        jupdate = jppo.make_update_fn(jnet.ENV, jp, jcfg, 3)
    jnew, jmetrics = jax.jit(jupdate)(jstate, jax.random.PRNGKey(1))
    before = {k: v.clone() for k, v in tstate.params.state_dict().items()}
    tupdate = tppo.make_update_fn(tnet.ENV, tp, tcfg, 3, device=CPU)
    tnew, tmetrics = tupdate(tstate, torch.Generator().manual_seed(1))

    tol = dict(rtol=1e-4, atol=1e-5)
    want = interop.ppo_params_from_numpy(jax.tree_util.tree_map(np.asarray, jnew.params),
                                         device=CPU)
    got = tnew.params.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)
    for name in ("rms", "ret_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(getattr(tnew, name), f).numpy(),
                                       np.asarray(getattr(getattr(jnew, name), f)),
                                       err_msg=f"{name}.{f}", **tol)
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), err_msg=k,
                                   **tol)
    assert tnew.update_idx == 1 and tnew.opt_state.count == 8
    assert not torch.equal(got["value.weight"], before["value.weight"])


def test_minibatch_chunks_equal_the_unchunked_update(monkeypatch):
    _, tp = _net_params()
    results = []
    for chunks in (1, 4):
        cfg = tppo.PPOConfig(**dict(RECIPE, minibatch_chunks=chunks))
        state = tppo.init_train_state(tnet.ENV, tp, cfg, torch.Generator().manual_seed(0),
                                      3, device=CPU)
        tr = _trajectory(tp, cfg, state)
        monkeypatch.setattr(tns, "rollout_traj_net", lambda *a, _tr=tr, **k: _tr)
        update = tppo.make_update_fn(tnet.ENV, tp, cfg, 3, device=CPU)
        new, metrics = update(state, torch.Generator().manual_seed(1))
        results.append((new.params.state_dict(), metrics))
    (p1, m1), (p4, m4) = results
    assert tppo._chunk_count(tppo.PPOConfig(minibatch_chunks=4), 1536) == 4
    for k in p1:
        torch.testing.assert_close(p4[k], p1[k], rtol=0, atol=1e-6)
    for k in m1:
        np.testing.assert_allclose(float(m4[k]), float(m1[k]), rtol=1e-5, atol=1e-6)


def test_gae_matches_a_numpy_loop():
    r = np.random.default_rng(3)
    T, n = 7, 5
    reward, values, nxt = (r.normal(0, 1, (T, n)).astype(np.float32) for _ in range(3))
    done = r.uniform(size=(T, n)) < 0.2
    cfg = tppo.PPOConfig(gamma=0.9, gae_lambda=0.8)
    got = tppo.gae_advantages(cfg, *(torch.from_numpy(a) for a in (reward, done, values,
                                                                     nxt))).numpy()
    adv, want = np.zeros(n), np.zeros((T, n))
    for t in range(T - 1, -1, -1):
        delta = reward[t] + 0.9 * nxt[t] - values[t]
        adv = delta + 0.9 * 0.8 * (1.0 - done[t]) * adv
        want[t] = adv
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_configs_mirror_jax():
    for cfg_t, cfg_j in ((tppo.PPOConfig(), jppo.PPOConfig()),
                         (ta2c.A2CConfig(), ja2c.A2CConfig()),
                         (ta2c.A2CConfig(num_minibatches=8), ja2c.A2CConfig(num_minibatches=8))):
        for f in dataclasses.fields(cfg_t):
            assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
    cfg = tppo.PPOConfig(num_envs=256, rollout_steps=30)
    assert cfg.replace(lr=1.0).lr == 1.0 and cfg.lr == 3e-4
    assert cfg.num_updates(256 * 30 * 5 + 7) == 5 and cfg.num_updates(1) == 1
    for n in (1024, 16384, 16388, 65536):
        assert cfg.resolved_shuffle(n) == jppo.PPOConfig().resolved_shuffle(n)
    assert ta2c.A2CConfig().optimizer == "rmsprop"


def test_train_on_cpu_and_what_is_not_ported():
    _, tp = _net_params()
    cfg = tppo.PPOConfig(**dict(RECIPE, num_envs=100, shuffle_minibatches=None))
    seen = []
    state, metrics = tppo.train(tnet.ENV, tp, cfg, torch.Generator().manual_seed(0),
                                2 * 100 * STEPS, device=CPU,
                                progress=lambda m, s: seen.append(m["update"]))
    assert seen == [1, 2] and state.update_idx == 2
    assert set(metrics) == {"mean_step_reward", "episodes", "pg_loss", "v_loss",
                            "entropy", "update", "timesteps"}
    assert all(np.isfinite(v).all() and v.shape == (2,) for v in metrics.values())
    assert list(metrics["timesteps"]) == [600, 1200]
    gen = torch.Generator()
    # the fused policy+env update (rollout="xla", the default) trains too
    xla_state, xla_metrics = tppo.train(tnet.ENV, tp, cfg.replace(rollout="xla"), gen, 600,
                                        device=CPU)
    assert xla_state.update_idx == 1 and set(xla_metrics) == set(metrics)
    assert all(np.isfinite(v).all() and v.shape == (1,) for v in xla_metrics.values())
    # a one-rank mesh (two ranks: tests/test_torch_dp_train.py): train forks
    # the rank generator, then initialises the model from the replicated one;
    # the collectives change nothing, so the update equals the single-process
    # update on the same rank generator bit for bit
    mesh = make_mesh(CPU)
    meshed, _ = tppo.train(tnet.ENV, tp, cfg, torch.Generator().manual_seed(7), 600, mesh=mesh)
    g = torch.Generator().manual_seed(7)
    rank_gen = mesh.rank_generator(g)
    plain = tppo.init_train_state(tnet.ENV, tp, cfg, g, 1, device=CPU, env_generator=rank_gen)
    plain, _ = tppo.make_update_fn(tnet.ENV, tp, cfg, 1, device=CPU)(plain, rank_gen)
    for k, v in plain.params.state_dict().items():
        assert torch.equal(meshed.params.state_dict()[k], v), k
    assert torch.equal(meshed.rms.var, plain.rms.var) and meshed.update_idx == 1
    with pytest.raises(ValueError, match="horizon"):
        tppo.train(tnet.ENV, tp, cfg.replace(rollout_steps=5), gen, 600, device=CPU)
    with pytest.raises(NotImplementedError, match="families"):
        tppo.train(dataclasses.replace(tnet.ENV, name="unported_family"), tp, cfg, gen, 600,
                   device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tppo.train(tnet.ENV, tp, cfg, gen, 600)


@pytest.mark.parametrize("deterministic", [True, False])
def test_make_eval_policy(deterministic):
    from or_gym_inventory_torch.vector import vecenv
    _, tp = _net_params()
    cfg = tppo.PPOConfig(pi_arch=(16,), vf_arch=(16,))
    model = tppo._make_model(tnet.ENV, tp, cfg, torch.Generator().manual_seed(0))
    rms = tppo.RunningMeanStd.create(tp.obs_dim, CPU)
    policy = tppo.make_eval_policy(tnet.ENV, tp, cfg, deterministic=deterministic)
    totals, traj = vecenv.evaluate_episodes(tnet.ENV, tp, policy, (model, rms),
                                            torch.Generator().manual_seed(1), 8, device=CPU)
    assert totals.shape == (8,) and torch.isfinite(totals).all()
    a = traj.action
    assert float(a.min()) >= 0 and float(a.max()) <= 1700.0
    if deterministic:   # every env sees the same states under the same policy
        assert torch.equal(a[0, 0], a[0, 1])


@pytest.mark.parametrize("chunks,device_type,want", [(0, "cpu", 8), (0, "cuda", 1),
                                                     (8, "cuda", 8), (1, "cpu", 1)])
def test_automatic_chunk_count(chunks, device_type, want):
    """At the 65,536 x 30 / 8-minibatch shape (245,760 samples per
    minibatch): the JAX package's rule off the card, one pass on it."""
    cfg = tppo.PPOConfig(minibatch_chunks=chunks)
    assert tppo._chunk_count(cfg, 245_760, device_type) == want
