"""NetInvMgmt on graphs past the first design's struct maxima, and demand
laws past the inversion table's cap, against the JAX package on the CPU.

The two graphs (``envs/topology.py`` ``repeated_regions``), compiled by
each package's ``compile_graph`` from the same nodes and edges:

- ``default_regions(8)``: the default graph's nodes 1-8 eight times under
  one market: 48 main nodes, 88 reorder links, 8 retail links, lead times
  summing to 488, obs 544;
- ``custom_regions(6)``: the custom graph's nodes 1-6 six times: 30 main
  nodes, 30 reorder links, 18 retail links, lead times summing to 24, obs
  72, 30 actions.

On both, the port's env chain against JAX's ``step_with_demand`` chain (the
fraction-closeness rule: >= 99% of the (period, lane) rewards and every
obs within ``rtol=1e-5, atol=1e-3``, CLAUDE.md), plain K1 and K25 against
JAX (the interpret-mode kernels on custom_regions(6); JAX's step chain on
default_regions(8), where interpret mode takes 8 s for two periods of K1
and 16 s for one of K25: ``rtol=1e-5`` and ``atol=1e-2`` on the sums of
~1e4-sized terms in another f32 order, ``atol=1e-3`` on the state), and
plain K2 equal to plain K1 on plain K3's streams bit for bit. On
custom_regions(6), plain K4 and K5/K6 under a folded 64x64 actor against
the JAX step chain and folded actor on their own streams (as
test_torch_net_policy.py holds them on the default graph). The plans: each
wrapper's block size on each graph and the refusal past the shared memory
of a block, which names the words. The wide-law route of the three returns
entry points: (E B,) returns whose mean agrees with the JAX package's XLA
fallback at the same params within 5 combined standard errors at 4,096
lanes.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import recurrent_ppo as trppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import episode_kernels as tek
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import topology as jtopo
from or_gym_inventory_tpu.ops import pallas_episode_kernels as jek
from or_gym_inventory_tpu.ops import pallas_net_step as pns
from or_gym_inventory_tpu.vector import fast_episodes as jfe

CPU = "cpu"
STEPS, B = 10, 8
GRAPHS = {"default_regions_8": (ttopo.DEFAULT_GRAPH, 8, (48, 88, 8, 488), 544),
          "custom_regions_6": (ttopo.CUSTOM_GRAPH, 6, (30, 30, 18, 24), 72)}
TOL = dict(rtol=1e-5, atol=1e-3)
SUM_TOL = dict(rtol=1e-5, atol=1e-2)


def _graph(name, steps=STEPS):
    """(JAX params, the port's params carried across by interop) of graph
    ``name``, each compiled by its own package."""
    base, copies, _, _ = GRAPHS[name]
    nodes, edges = ttopo.repeated_regions(base, copies)
    jp = jnet.NetInvParams(topology=jtopo.compile_graph(nodes, edges, steps), num_periods=steps)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology), steps, jp.backlog,
                                       jp.alpha)
    return jp, tp


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    """(name, JAX params, the port's params, JAX's step chain compiled once)."""
    jp, tp = _graph(request.param)
    return request.param, jp, tp, _jax_chain(jp)


def _streams(T, seed, steps=STEPS, b=B):
    r = np.random.default_rng(seed)
    acts = r.uniform(0.0, 2 * float(T.order_cap_heuristic), (steps, T.n_reorder, b))
    dems = r.poisson(20.0, (steps, T.n_retail, b))
    return acts.astype(np.float32), dems.astype(np.float32)


def _jax_chain(jp):
    """JAX's step chain over (T, rows, B) streams: per period the obs
    before the step, the fulfilled orders and the reward."""
    @jax.jit
    def run(actions, demands):
        def one_env(acts, dems):
            state, _ = jnet.reset(jp)

            def body(state, ad):
                obs = jnet._obs(jp, state)
                state, ts = jnet.step_with_demand(jp, state, ad[0], ad[1])
                return state, (obs, ts.info["fulfilled_orders"], ts.reward)

            _, outs = jax.lax.scan(body, state, (acts, dems))
            return outs

        return jax.vmap(one_env, in_axes=(2, 2), out_axes=-1)(actions, demands)

    return run


def test_both_packages_compile_the_same_graphs(graph):
    name, jp, tp, _ = graph
    _, _, counts, obs = GRAPHS[name]
    T = tp.topology
    assert (T.n_main, T.n_reorder, T.n_retail, sum(T.ro_L)) == counts
    assert T.obs_dim == jp.topology.obs_dim == obs
    base, copies, _, _ = GRAPHS[name]
    assert T == ttopo.compile_graph(*ttopo.repeated_regions(base, copies), STEPS)
    # and the JAX env steps it
    state, ts = jnet.reset(jp)
    acts, dems = _streams(T, 0, 1, 1)
    state, ts = jnet.step_with_demand(jp, state, jnp.asarray(acts[0, :, 0]),
                                      jnp.asarray(dems[0, :, 0]))
    assert np.isfinite(float(ts.reward))


def test_env_chain_matches_jax(graph):
    """The port's env, reset and ``step_with_demand`` on a (B, rows) batch,
    against JAX's chain on the same streams."""
    _, jp, tp, chain = graph
    acts, dems = _streams(tp.topology, 1)
    obs_j, r_j, rew_j = (np.asarray(x) for x in chain(jnp.asarray(acts), jnp.asarray(dems)))
    state, ts = tnet.reset(tp, batch=B, device=CPU)
    rewards = []
    for t in range(STEPS):
        np.testing.assert_allclose(ts.obs.numpy(), obs_j[t].T, **TOL)
        state, ts = tnet.step_with_demand(tp, state, torch.from_numpy(acts[t].T),
                                          torch.from_numpy(dems[t].T))
        np.testing.assert_allclose(ts.info["fulfilled_orders"].numpy(), r_j[t].T, **TOL)
        rewards.append(ts.reward.numpy())
    close = np.isclose(np.stack(rewards), rew_j, **TOL)
    assert close.mean() >= 0.99


def test_plain_k1_matches_jax(graph):
    name, jp, tp, chain = graph
    T = tp.topology
    acts, dems = _streams(T, 2)
    mine = tns.episode_returns(tp, torch.from_numpy(acts), torch.from_numpy(dems)).numpy()
    ref = np.asarray(chain(jnp.asarray(acts), jnp.asarray(dems))[2]).sum(0)
    np.testing.assert_allclose(mine, ref, **SUM_TOL)
    if name == "custom_regions_6":   # JAX's interpret kernel, two periods
        jp2, tp2 = _graph(name, 2)
        kern = pns.episode_returns(jp2, jnp.asarray(acts[:2]), jnp.asarray(dems[:2]), block=B,
                                   interpret=True)
        mine2 = tns.episode_returns(tp2, torch.from_numpy(acts[:2]),
                                    torch.from_numpy(dems[:2])).numpy()
        np.testing.assert_allclose(mine2, np.asarray(kern), **SUM_TOL)


def test_plain_k25_matches_jax(graph):
    """Chained periods of plain K25 from the reset against JAX's step chain
    (both graphs), and one period past the lead times against JAX's
    interpret ``batched_step`` (custom_regions(6))."""
    name, jp, tp, chain = graph
    T = tp.topology
    acts, dems = _streams(T, 3)
    _, r_j, rew_j = (np.asarray(x) for x in chain(jnp.asarray(acts), jnp.asarray(dems)))
    X, Y, U, RH = tns.init_transposed(tp, B, CPU)
    for t in range(STEPS):
        X, Y, U, RH, rew = tns.batched_step(tp, X, Y, U, RH, torch.from_numpy(acts[t]),
                                            torch.from_numpy(dems[t]), t)
        np.testing.assert_allclose(RH[:T.n_reorder].numpy(), r_j[t], **TOL)
        np.testing.assert_allclose(rew.numpy(), rew_j[t], **SUM_TOL)
    if name == "custom_regions_6":
        ins = [jnp.asarray(x.numpy()) for x in (X, Y, U, RH)]
        want = pns.batched_step(jp, *ins, jnp.asarray(acts[0]), jnp.asarray(dems[0]),
                                jnp.int32(STEPS), block=B, interpret=True)
        got = tns.batched_step(tp, X, Y, U, RH, torch.from_numpy(acts[0]),
                               torch.from_numpy(dems[0]), STEPS)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape), **SUM_TOL)


def test_plain_k2_is_plain_k1_on_plain_k3_streams(graph):
    _, _, tp, _ = graph
    hi = float(tp.topology.order_cap_heuristic * 2)
    ret = tns.episode_returns_fully_fused(tp, 11, hi, B, episodes_per_lane=2, device=CPU)
    acts, dems = tns.sample_streams_debug(tp, 11, hi, B, episodes_per_lane=2, device=CPU)
    for e in range(2):
        assert torch.equal(ret[e], tns.episode_returns(tp, acts[:, e].contiguous(),
                                                       dems[:, e].contiguous()))
    # K26 on episode 0's demand draws K2's actions
    assert torch.equal(ret[0], tns.episode_returns_random_policy(
        tp, dems[:, 0].contiguous(), 11, hi))


@pytest.fixture(scope="module")
def custom():
    """custom_regions(6) and a folded 64x64 actor with obs statistics of
    mean ~50 and std ~20, its mean head scaled so that the actions move."""
    jp, tp = _graph("custom_regions_6")
    T = tp.topology
    g = torch.Generator().manual_seed(4)
    model = tnetworks.MLPActorCritic(T.obs_dim, T.n_reorder, generator=g)
    with torch.no_grad():
        model.mean.weight.mul_(30.0)
    r = np.random.default_rng(4)
    rms = interop.rms_from_numpy(50.0 + r.normal(0, 5, T.obs_dim),
                                 (20.0 + r.uniform(0, 5, T.obs_dim)) ** 2, 1e3, device=CPU)

    class Cfg:
        activation, normalize_obs = "tanh", True
    actor = tek.fold_actor_params(Cfg, model, rms)
    jactor = (tuple(jnp.asarray(W.numpy()) for W in actor[0]),
              tuple(jnp.asarray(b.numpy()) for b in actor[1]))
    return jp, tp, actor, jactor, _jax_chain(jp)


def test_plain_k4_on_custom_regions_replays_through_jax(custom):
    """Plain K4's streams: JAX's step chain on its actions and demand gives
    its r and rewards, and JAX's folded actor on the obs assembled from its
    streams plus the plain normals gives its raws (atol=1e-4)."""
    jp, tp, actor, jactor, chain = custom
    T = tp.topology
    log_std = torch.full((T.n_reorder,), -0.5)
    k4 = tns.rollout_traj_net(tp, actor, log_std, 2024, B, device=CPU)
    acts = ((torch.tanh(k4["raw"]) + 1.0) * tns._half_hi(T)).numpy()
    _, r_j, rew_j = (np.asarray(x) for x in
                     chain(jnp.asarray(acts), jnp.asarray(k4["demand"].numpy())))
    np.testing.assert_allclose(k4["r"].numpy(), r_j, **TOL)
    np.testing.assert_allclose(k4["reward"].numpy(), rew_j, **SUM_TOL)
    obs = jnet.assemble_obs_from_streams(jp, *(jnp.asarray(k4[k].numpy())
                                               for k in ("x", "u", "r")))
    mean = np.asarray(jek.folded_actor_mean(jactor, obs))[:STEPS]
    lanes = torch.arange(B)
    z = []
    for t in range(STEPS):
        w = rng.period_words(2024, lanes, 0, t, T.n_retail + 2 * T.n_reorder,
                             key1=rng.POLICY_KEY)[T.n_retail:]
        z.append(rng.normal01(torch.stack(w[:T.n_reorder]), torch.stack(w[T.n_reorder:])))
    want = mean.transpose(0, 2, 1) + np.exp(-0.5) * torch.stack(z).numpy()
    np.testing.assert_allclose(k4["raw"].numpy(), want, rtol=0, atol=1e-4)


def test_plain_k5_on_custom_regions_matches_jax(custom):
    """Plain K6's actions are JAX's ``apply_folded_actor`` on JAX's chain
    driven by them (atol=1e-3 on actions up to ~2,600), its returns are
    plain K5's, and JAX's chain's rewards on its streams sum to them."""
    jp, tp, actor, jactor, chain = custom
    ret, acts, dems = tns.sample_policy_streams_debug_net(tp, actor, 7, B, device=CPU)
    assert torch.equal(ret, tns.episode_returns_net_policy(tp, actor, 7, B, device=CPU))
    a, d = acts[:, 0].numpy(), dems[:, 0].numpy()
    obs_j, _, rew_j = (np.asarray(x) for x in chain(jnp.asarray(a), jnp.asarray(d)))
    space = jnet.action_space(jp)
    for t in range(STEPS):
        want = jek.apply_folded_actor(jactor, jnp.asarray(obs_j[t].T), jnp.asarray(space.low),
                                      jnp.asarray(space.high), False)
        np.testing.assert_allclose(a[t], np.asarray(want).T, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ret.numpy(), rew_j.sum(0), **SUM_TOL)


# (graph, K2/K26's threads, K1's (threads, periods a buffer), K25's threads,
# K4-K6's tile lanes)
PLANS = {"default_regions_8": (64, (32, 4), 64, None),
         "custom_regions_6": (128, (64, 4), 128, 64)}


@pytest.mark.parametrize("name", list(PLANS))
def test_each_wrapper_plans_its_block_by_the_graph(name):
    k2, k1, k25, tile = PLANS[name]
    _, tp = _graph(name)
    T = tp.topology
    counts = (T.n_main, T.n_reorder, T.n_retail, sum(T.ro_L))
    topo = 8 * (T.n_main + T.n_reorder + T.n_retail)
    plan, _ = tns._shared_layout(T)
    assert (plan.threads, plan.topo_floats) == (k2, topo)
    assert plan.bytes == 4 * (plan.words * k2 + topo) <= tns.SMEM_PER_BLOCK
    assert 4 * (plan.words * 2 * k2 + topo) > tns.SMEM_PER_BLOCK or k2 == 128
    plan1 = tns._k1_plan(*counts)
    assert (plan1.threads, plan1.chunk) == k1
    assert tns._k25_plan(T.n_main, T.n_reorder, T.n_retail,
                         sum(L > 0 for L in T.ro_L)).threads == k25
    if tile is None:   # obs 544: past MlpTile's 256 inputs, the general class
        st, _ = tns._pack_net_tile_actor(T, ([torch.zeros(T.obs_dim, 64), torch.zeros(64, 88)],
                                             [torch.zeros(64), torch.zeros(88)]), None, CPU)
        words = tns._shared_layout(T, False)[0].words
        assert isinstance(st, tek._MlpTileG) and (st.lanes, st.ws_floats) == (32, 0)
        assert st.s_total == st.s_state + words * 32 + topo <= tek.SMEM_OPTIN_BYTES // 4
        return
    st, _ = tns._pack_net_tile_actor(T, ([torch.zeros(T.obs_dim, 64), torch.zeros(64, 64),
                                          torch.zeros(64, T.n_reorder)],
                                         [torch.zeros(64), torch.zeros(64),
                                          torch.zeros(T.n_reorder)]), None, CPU)
    words = tns._shared_layout(T, False)[0].words
    assert st.lanes == tile and st.s_total == st.s_state + words * tile + topo
    assert tns._net_cluster_layout(T).topo_floats == topo


def test_plans_refuse_past_the_shared_memory_of_a_block():
    """Lead times of 170 on the default graph (1,917 words of state a lane)
    fit no block of 32 threads: K2/K26's, K1's and K4-K6's plans raise,
    naming the words; lead times of 150 (1,697 words) fit a block of 32
    threads, but not K29's wide route beside its activations. On
    custom_regions(6) lead times of 90 (4 x 30 + 2 x 30 + 18 + 2,700 words)
    fit none beside the graph's 624 floats of records."""
    T = ttopo.default_regions(1, STEPS)
    wide = dataclasses.replace(T, ro_L=(170,) * T.n_reorder)
    words = 4 * 6 + 2 * 11 + 1 + 170 * 11
    with pytest.raises(ValueError, match=f"the state needs {words} words a lane beside the "
                                         f"topology's 0.*hold 1816 words a lane"):
        tns._shared_layout(wide)
    C = ttopo.custom_regions(6, STEPS)
    with pytest.raises(ValueError, match="the state needs 2898 words a lane beside the "
                                         "topology's 624.*hold 1796 words a lane"):
        tns._shared_layout(dataclasses.replace(C, ro_L=(90,) * C.n_reorder))
    with pytest.raises(ValueError, match="too large"):
        tns._k1_plan(6, 11, 1, 170 * 11)
    with pytest.raises(ValueError, match="too large"):
        tns._pack_net_tile_actor(wide, ([torch.zeros(wide.obs_dim, 11)],
                                        [torch.zeros(11)]), None, CPU)
    narrower = dataclasses.replace(T, ro_L=(150,) * T.n_reorder)
    assert tns._shared_layout(narrower)[0].threads == 32
    with pytest.raises(ValueError, match="too large for K29's wide route"):
        tns._net_wide_bytes(narrower, tek._WideMlp(rows=64))


def _se_close(got, want):
    """|mean difference| within 5 combined standard errors."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    se = np.sqrt(got.var(ddof=1) / got.size + want.var(ddof=1) / want.size)
    assert abs(got.mean() - want.mean()) < 5 * se, (got.mean(), want.mean(), se)


WIDE_LANES, WIDE_STEPS = 4_096, 6


def _wide_params(family):
    if family == "im":
        jp = jim.default_params(periods=WIDE_STEPS, dist_param={"mu": 50_000})
        return jp, interop.im_params_from_numpy(dataclasses.asdict(jp))
    T = dataclasses.replace(jtopo.default_topology(WIDE_STEPS), rt_demand=(("poisson", 50000.0),))
    jp = jnet.NetInvParams(topology=T, num_periods=WIDE_STEPS)
    return jp, interop.net_params_from_numpy(dataclasses.asdict(T), WIDE_STEPS, jp.backlog,
                                             jp.alpha)


def _obs_act(family, tp):
    if family == "im":
        return tim.observation_space(tp).shape[0], tp.m1
    return tp.topology.obs_dim, tp.topology.n_reorder


@pytest.mark.parametrize("family", ["im", "net"])
def test_wide_law_random_and_policy_returns_match_jax_fallback(family):
    jp, tp = _wide_params(family)
    obs_dim, act_dim = _obs_act(family, tp)
    with pytest.warns(RuntimeWarning, match="inversion-table cap"):
        got = tfe.random_episode_returns(tp, torch.Generator().manual_seed(0), WIDE_LANES // 2,
                                         episodes_per_lane=2, device=CPU)
    assert got.shape == (WIDE_LANES,)
    _se_close(got.numpy(), jfe.random_episode_returns(jp, jax.random.PRNGKey(0), WIDE_LANES))
    g = torch.Generator().manual_seed(1)
    model = tnetworks.MLPActorCritic(obs_dim, act_dim, generator=g)
    with torch.no_grad():
        model.mean.weight.mul_(10.0)
    rms = interop.rms_from_numpy(np.full(obs_dim, 50.0), np.full(obs_dim, 400.0), 1e3,
                                 device=CPU)

    class Cfg:
        activation, normalize_obs = "tanh", True
    actor = tek.fold_actor_params(Cfg, model, rms)
    jactor = (tuple(jnp.asarray(W.numpy()) for W in actor[0]),
              tuple(jnp.asarray(b.numpy()) for b in actor[1]))
    # deterministic on InvManagement, the stochastic head on NetInvMgmt
    det = family == "im"
    log_std = None if det else torch.full((act_dim,), -0.5)
    with pytest.warns(RuntimeWarning, match="policy kernel unavailable"):
        got = tfe.policy_episode_returns(tp, actor, torch.Generator().manual_seed(2), WIDE_LANES,
                                         deterministic=det, log_std=log_std, device=CPU)
    assert got.shape == (WIDE_LANES,)
    want = jfe.policy_episode_returns(jp, jactor, jax.random.PRNGKey(2), WIDE_LANES,
                                      deterministic=det,
                                      log_std=None if det else jnp.asarray(log_std.numpy()))
    _se_close(got.numpy(), want)
    # the kernels' plan refuses what the route runs
    with pytest.raises(NotImplementedError, match="cap"):
        if family == "im":
            tek._im_demand_spec(tp)
        else:
            tns._topology_link_specs(tp.topology, WIDE_STEPS)


@pytest.mark.parametrize("family", ["im", "net"])
def test_wide_law_lstm_returns_match_jax_fallback(family):
    jp, tp = _wide_params(family)
    obs_dim, act_dim = _obs_act(family, tp)
    g = torch.Generator().manual_seed(3)
    model = tnetworks.LSTMActorCritic(obs_dim, act_dim, hidden=16, encoder=(8,), generator=g)
    rms = interop.rms_from_numpy(np.full(obs_dim, 50.0), np.full(obs_dim, 400.0), 1e3,
                                 device=CPU)
    actor = tek.fold_lstm_actor(trppo.RecurrentPPOConfig(), model, rms)
    jactor = {k: ([(jnp.asarray(W.numpy()), jnp.asarray(b.numpy())) for W, b in v]
                  if k == "enc" else jnp.asarray(v.numpy())) for k, v in actor.items()}
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        got = tfe.lstm_policy_episode_returns(tp, actor, torch.Generator().manual_seed(4),
                                              WIDE_LANES, device=CPU)
    assert (family == "im") == any("LSTM policy kernel" in str(w.message) for w in record)
    assert got.shape == (WIDE_LANES,)
    _se_close(got.numpy(), jfe.lstm_policy_episode_returns(jp, jactor, jax.random.PRNGKey(4),
                                                           WIDE_LANES))


def test_hostfn_still_raises():
    T = dataclasses.replace(ttopo.default_topology(WIDE_STEPS),
                            rt_demand=(("hostfn", lambda rng_, t: 1.0),))
    params = tnet.NetInvParams(topology=T, num_periods=WIDE_STEPS)
    for call in (lambda: tfe.random_episode_returns(params, torch.Generator(), 4, device=CPU),
                 lambda: tfe.policy_episode_returns(params, None, torch.Generator(), 4,
                                                    device=CPU)):
        with pytest.raises(NotImplementedError, match="host"):
            call()
