"""The port's Gymnasium adapters (``envs/adapters.py``) against the JAX
package's, on the CPU.

- Every one of the 11 adapter classes against JAX's, bit for bit: the same
  seeds (42, 7, 5) and the same action sequence for a whole episode give
  equal obs, reward, terminated, truncated and info (values, dtypes and
  types), equal spaces, and for NetInvMgmt equal X/Y/R/S/D/U/P frames. The
  reference checkout is absent (tests/conftest.py:40-56), so JAX's adapters
  are the oracle, as they are the reference's bit for bit.
- The mirrors of tests/test_adapters.py:93 (fixed params), :104 and :127
  against the port's functional core: the adapter and ``step_with_demand``
  on the adapter's own demand stream (``core.parity``); obs exactly
  (InvManagement) or within atol 1e-2 (NetInvMgmt, float), rewards within
  1e-2, as the JAX tests hold JAX's core.
- ``assign_env_config``, the DiGraph copied, as JAX's does.
- ``core.gym_compat``'s stand-ins: ``np_random`` is gymnasium's seeding,
  ``HostBox`` gymnasium's Box, and every adapter class on the stand-ins (a
  process where gymnasium cannot be imported) steps the same trajectories
  bit for bit.
"""

import json
import os
import subprocess
import sys

import gymnasium
import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

from or_gym_inventory_torch.core import gym_compat, parity
from or_gym_inventory_torch.envs import adapters as tad
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_tpu.envs import adapters as jad

CLASSES = ["NewsvendorEnv", "CustomizableNewsvendorEnv", "InvManagementMasterEnv",
           "InvManagementBacklogEnv", "InvManagementLostSalesEnv", "NetInvMgmtMasterEnv",
           "NetInvMgmtBacklogEnv", "NetInvMgmtLostSalesEnv", "NetInvMgmtCustomMasterEnv",
           "NetInvMgmtCustomBacklogEnv", "NetInvMgmtCustomLostSalesEnv"]
SEEDS = (42, 7, 5)
FRAMES = ("X", "Y", "R", "S", "D", "U", "P")


def _actions(env, seed, n):
    """An action sequence past the bounds on both sides (Newsvendor orders
    above max_order_quantity, InvManagement negative and above capacity,
    NetInvMgmt fractional and negative), with runs of periods that order
    nothing, so that stock runs out and backlog builds."""
    rng = np.random.default_rng(seed + 1000)
    hi = np.asarray(env.action_space.high, np.float64)
    raw = rng.uniform(-0.2, 1.3, size=(n,) + env.action_space.shape) * np.minimum(hi, 3000)
    idle = (np.arange(n) // 4) % 3 == 1      # periods 4-7, 16-19, ...
    raw[idle] = 0
    return [a.astype(env.action_space.dtype) for a in raw]


def _same(a, b, where):
    """Equal values of equal types, recursively (dict, list, array, scalar)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, (where, a, b)


def _episode(env, actions, seed, options=None):
    out = [env.reset(seed=seed, options=options)]
    for a in actions:
        out.append(env.step(a))
        if out[-1][2] or out[-1][3]:
            break
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cls", CLASSES)
def test_adapter_equals_jax(cls, seed):
    t_env, j_env = getattr(tad, cls)(), getattr(jad, cls)()
    for space in ("observation_space", "action_space"):
        a, b = getattr(t_env, space), getattr(j_env, space)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), space
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    actions = _actions(j_env, seed, 60)
    options = ({"fixed_params": {"price": 50.0, "k": 5.0, "mu": 30.0}}
               if cls == "CustomizableNewsvendorEnv" and seed == 5 else None)
    t_run = _episode(t_env, actions, seed, options)
    j_run = _episode(j_env, actions, seed, options)
    assert len(t_run) == len(j_run) > 25
    assert t_run[-1][3] and not t_run[-1][2]          # truncated at the horizon
    for i, (x, y) in enumerate(zip(t_run, j_run)):
        _same(tuple(x), tuple(y), f"{cls} seed {seed} step {i}")
    if cls.startswith("NetInvMgmt"):
        assert t_env.backlog is j_env.backlog is True    # QUIRKS.md #1, the LostSales ones too
        for name in FRAMES:
            pd.testing.assert_frame_equal(getattr(t_env, name), getattr(j_env, name))
    else:
        for name in ("I", "D", "S", "B", "P", "action_log") if cls.startswith("Inv") else ():
            _same(getattr(t_env, name), getattr(j_env, name), name)


def test_customizable_newsvendor_fixed_params():
    """tests/test_adapters.py:93 on the port's class."""
    env = tad.CustomizableNewsvendorEnv()
    fixed = {"price": 50.0, "cost": 25.0, "h": 2.0, "k": 5.0, "mu": 30.0}
    obs, info = env.reset(seed=0, options={"fixed_params": fixed})
    np.testing.assert_allclose(obs[:5], [50.0, 25.0, 2.0, 5.0, 30.0])
    assert info["fixed_params_used"] == fixed
    obs2, _ = env.reset(seed=0)   # randomized again without options
    assert abs(obs2[4] - 30.0) > 1e-6 or abs(obs2[0] - 50.0) > 1e-6


def test_adapter_matches_functional_core_inv():
    """tests/test_adapters.py:104: the adapter's NumPy dynamics and the
    port's ``step_with_demand`` on the adapter's own demand stream; obs
    exactly, the reward within 1e-2."""
    env = tad.InvManagementBacklogEnv(env_config={"periods": 15})
    env.reset(seed=33)
    params = tim.default_params(env_config={"periods": 15}, backlog=True)
    demands = parity.inv_management_demand_stream(parity.reference_rng(33), params.dist,
                                                  params.dist_param_dict, 15)
    state, ts = tim.reset(params, device="cpu")
    action = np.array([30, 40, 50], np.int64)
    for t in range(15):
        obs_a, r_a, _, _, _ = env.step(action)
        state, ts = tim.step_with_demand(params, state, torch.as_tensor(action[None], dtype=torch.int32),
                                         torch.as_tensor([demands[t]]))
        np.testing.assert_array_equal(obs_a, ts.obs[0].numpy())
        assert abs(r_a - float(ts.reward[0])) < 1e-2


def test_adapter_matches_functional_core_net():
    """tests/test_adapters.py:127 on the port: obs within atol 1e-2, the
    reward within 1e-2."""
    env = tad.NetInvMgmtBacklogEnv(num_periods=12)
    env.reset(seed=21)
    params = tnet.default_params(num_periods=12, backlog=True)
    demands = parity.net_inv_demand_stream(parity.reference_rng(21),
                                           params.topology.retail_dist_params(), 12)
    state, ts = tnet.reset(params, device="cpu")
    action = np.full(11, 25.0, np.float32)
    for t in range(12):
        obs_a, r_a, _, _, _ = env.step(action)
        state, ts = tnet.step_with_demand(params, state, torch.as_tensor(action[None]),
                                          torch.as_tensor(demands[t][None]))
        np.testing.assert_allclose(obs_a, ts.obs[0].numpy(), atol=1e-2)
        assert abs(r_a - float(ts.reward[0])) < 1e-2


def test_assign_env_config():
    """Every key set as an attribute, a DiGraph copied, as JAX's does."""
    class Holder:
        pass

    g = nx.DiGraph([(0, 1), (1, 2)])
    cfg = {"periods": 7, "graph": g, "alpha": 0.9}
    t_obj, j_obj = Holder(), Holder()
    tad.assign_env_config(t_obj, cfg)
    jad.assign_env_config(j_obj, cfg)
    assert t_obj.periods == j_obj.periods == 7 and t_obj.alpha == 0.9
    assert t_obj.graph is not g and list(t_obj.graph.edges) == list(g.edges)
    g.add_edge(2, 3)
    assert (2, 3) not in t_obj.graph.edges and (2, 3) not in j_obj.graph.edges


# ------------------------------------------------------------ the stand-ins

def test_np_random_is_gymnasiums_seeding():
    for seed in (0, 5, 2 ** 40):
        ours, entropy = gym_compat.np_random(seed)
        theirs, their_entropy = gymnasium.utils.seeding.np_random(seed)
        assert entropy == their_entropy
        np.testing.assert_array_equal(ours.random(16), theirs.random(16))
        np.testing.assert_array_equal(ours.poisson(20, 16), theirs.poisson(20, 16))
    env = gym_compat.HostEnv()
    env.reset(seed=42)
    np.testing.assert_array_equal(env.np_random.random(4), parity.reference_rng(42).random(4))
    with pytest.raises(ValueError):
        gym_compat.np_random(-1)


def test_host_box_is_gymnasiums_box():
    for low, high, dtype in (([0, 0, 0], [100, 200, 230], np.int64),
                             (np.zeros(4), np.full(4, 40.0), np.float32)):
        ours = gym_compat.HostBox(low=np.asarray(low), high=np.asarray(high), dtype=dtype)
        theirs = gymnasium.spaces.Box(low=np.asarray(low), high=np.asarray(high), dtype=dtype)
        assert (ours.shape, ours.dtype) == (theirs.shape, theirs.dtype)
        ours.seed(3)
        for _ in range(50):
            x = ours.sample()
            assert x.dtype == ours.dtype and theirs.contains(x) and ours.contains(x)
        assert not ours.contains(np.asarray(high) + 1)
        batched = gym_compat.host_batch_space(ours, 5)
        want = gymnasium.vector.utils.batch_space(theirs, 5)
        assert (batched.shape, batched.dtype) == (want.shape, want.dtype)
        np.testing.assert_array_equal(batched.low, want.low)
        np.testing.assert_array_equal(batched.high, want.high)
    ints = gym_compat.HostBox(low=np.zeros(3), high=np.full(3, 2), dtype=np.int32, seed=0)
    assert {int(v) for _ in range(200) for v in ints.sample()} == {0, 1, 2}   # inclusive


_STANDIN_RUN = r"""
import json, sys
import numpy as np
sys.modules["gymnasium"] = None      # import gymnasium raises ImportError
from or_gym_inventory_torch.core import gym_compat
from or_gym_inventory_torch.envs import adapters as ad
assert gym_compat.Env is gym_compat.HostEnv and gym_compat.Box is gym_compat.HostBox
out = {}
for cls, seed, actions in json.loads(sys.stdin.read()):
    env = getattr(ad, cls)()
    assert isinstance(env.action_space, gym_compat.HostBox)
    obs, _ = env.reset(seed=seed)
    rows = [np.asarray(obs, np.float64).tolist()]
    for a in actions:
        obs, r, te, tr, _ = env.step(np.asarray(a, env.action_space.dtype))
        rows.append(np.asarray(obs, np.float64).tolist() + [float(r)])
        if te or tr:
            break
    out[cls] = rows
print(json.dumps(out))
"""


def test_adapters_on_the_stand_ins():
    """Every class on ``core.gym_compat``'s stand-ins, in a process where
    gymnasium cannot be imported, steps the trajectories it steps on
    gymnasium's base, bit for bit."""
    jobs, want = [], {}
    for i, cls in enumerate(CLASSES):
        env = getattr(tad, cls)()
        assert isinstance(env, gymnasium.Env)
        seed = SEEDS[i % 3]
        actions = _actions(env, seed, 60)
        jobs.append((cls, seed, [a.tolist() for a in actions]))
        run = _episode(env, actions, seed)
        want[cls] = ([np.asarray(run[0][0], np.float64).tolist()]
                     + [np.asarray(o, np.float64).tolist() + [float(r)]
                        for o, r, *_ in run[1:]])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _STANDIN_RUN], input=json.dumps(jobs),
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for cls in CLASSES:
        assert got[cls] == want[cls], cls
