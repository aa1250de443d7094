"""``vector/gym_vector.BatchedGymVectorEnv`` on the CPU: the eight cases of
tests/test_gym_vector.py:13-186 on the port, and the port against the JAX
package's ``BatchedGymVectorEnv``.

The two draw from other streams (a ``torch.Generator`` against a JAX key),
so the cross-package cases run on user demand (InvManagement ``dist=5``,
NetInvMgmt per-link ``user`` specs), where every reset and step is
deterministic, with the same actions: obs and dones equal, rewards within
rtol 1e-6 (f32 sums in another order), the SAME_STEP masks and
``final_obs`` equal, in all three autoreset modes. Elsewhere the cases
hold the properties: spaces, autoreset masks, ``final_obs``, reproducible
``reset(seed)``, external gymnasium wrappers. JAX's NEXT_STEP case pins a
``lax.cond`` in its lowered program; the port's form of that pin counts
the reset batches a step draws (none on a step where no env is pending).
The last case runs the vector env on ``core.gym_compat``'s stand-ins in a
process where gymnasium cannot be imported.
"""

import dataclasses
import json
import os
import subprocess
import sys

import gymnasium
import numpy as np
import pytest
from gymnasium.vector import AutoresetMode

from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as nv
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.vector import vecenv
from or_gym_inventory_torch.vector.gym_vector import BatchedGymVectorEnv
from or_gym_inventory_tpu.envs import inv_management as jim
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import topology as jtopo
from or_gym_inventory_tpu.vector.gym_vector import BatchedGymVectorEnv as JaxVectorEnv

CPU = "cpu"


def _venv(env, params, n, **kw):
    return BatchedGymVectorEnv(env, params, num_envs=n, device=CPU, **kw)


def test_batched_gym_vector_env():
    params = im.default_params(periods=5)
    venv = _venv(im.ENV, params, 16, seed=0)
    obs, info = venv.reset()
    assert obs.shape == (16, params.pipeline_length)
    a = np.tile(np.array([10, 10, 10], np.int32), (16, 1))
    for t in range(5):
        obs, rew, term, trunc, info = venv.step(a)
        assert rew.shape == (16,)
    assert trunc.all()  # lockstep horizon
    # autoreset: next obs is the fresh-episode obs
    np.testing.assert_array_equal(obs[:, 0], np.full(16, params.I0[0]))
    # SAME_STEP convention: terminal obs rides in info
    assert info["final_obs"].shape == obs.shape


def test_vector_env_conformance():
    """A real gymnasium.vector.VectorEnv: subclass, batched spaces via
    batch_space, declared autoreset mode, spaces contain what reset/step
    produce and accept what action_space samples."""
    from gymnasium.vector.utils import batch_space

    params = im.default_params(periods=4)
    venv = _venv(im.ENV, params, 8, seed=1)
    assert isinstance(venv, gymnasium.vector.VectorEnv)
    assert venv.metadata["autoreset_mode"] is AutoresetMode.SAME_STEP
    assert venv.observation_space == batch_space(venv.single_observation_space, 8)
    assert venv.action_space == batch_space(venv.single_action_space, 8)

    obs, _ = venv.reset(seed=7)
    assert venv.observation_space.contains(obs.astype(venv.observation_space.dtype))
    act = venv.action_space.sample()
    assert act.shape[0] == 8
    obs, rew, term, trunc, info = venv.step(act)
    assert venv.observation_space.contains(obs.astype(venv.observation_space.dtype))
    assert rew.shape == term.shape == trunc.shape == (8,)
    assert isinstance(info, dict)
    venv.close()
    assert venv.closed


def test_external_consumer_record_episode_statistics():
    """A stock gymnasium vector wrapper (RecordEpisodeStatistics) drives the
    env end to end and reads per-episode returns off its step stream."""
    from gymnasium.wrappers.vector import RecordEpisodeStatistics

    params = nv.default_params(step_limit=6)
    wrapped = RecordEpisodeStatistics(_venv(nv.ENV, params, 4, seed=3))
    obs, _ = wrapped.reset(seed=11)
    assert obs.shape == (4, params.obs_dim)
    got_episode_stats = False
    for t in range(6):
        obs, rew, term, trunc, info = wrapped.step(wrapped.action_space.sample())
        if "episode" in info:
            got_episode_stats = True
            assert np.asarray(info["episode"]["r"]).shape == (4,)
            assert np.isfinite(np.asarray(info["episode"]["r"])).all()
    assert got_episode_stats
    wrapped.close()


def test_next_step_autoreset_mode():
    """NEXT_STEP: the terminal step returns the terminal obs; the following
    step resets (action ignored, reward 0, done False); a stateful wrapper
    that requires NEXT_STEP (NormalizeObservation) drives it."""
    params = im.default_params(periods=3)
    venv = _venv(im.ENV, params, 8, seed=2, autoreset_mode=AutoresetMode.NEXT_STEP)
    assert venv.metadata["autoreset_mode"] is AutoresetMode.NEXT_STEP
    venv.reset(seed=9)
    a = np.tile(np.array([5, 5, 5], np.int32), (8, 1))
    for t in range(3):
        obs, rew, term, trunc, info = venv.step(a)
    assert trunc.all()          # terminal obs returned, not reset obs
    obs2, rew2, term2, trunc2, _ = venv.step(a)  # deferred reset fires
    assert not trunc2.any() and not term2.any()
    np.testing.assert_array_equal(rew2, np.zeros(8, np.float32))
    np.testing.assert_array_equal(obs2[:, 0], np.full(8, params.I0[0]))

    from gymnasium.wrappers.vector import NormalizeObservation

    w = NormalizeObservation(_venv(im.ENV, params, 8, seed=3, autoreset_mode="NextStep"))
    w.reset(seed=1)
    for t in range(7):
        obs, *_ = w.step(a)
    assert np.isfinite(obs).all()
    w.close()


def test_same_step_final_mask_keys():
    """SAME_STEP's ``_final_obs``/``_final_info`` masks flag which envs
    ended this step."""
    params = im.default_params(periods=2)
    venv = _venv(im.ENV, params, 4, seed=0)
    venv.reset()
    a = np.tile(np.array([5, 5, 5], np.int32), (4, 1))
    _, _, term, trunc, info = venv.step(a)
    assert info["_final_obs"].dtype == bool
    np.testing.assert_array_equal(info["_final_obs"], term | trunc)
    np.testing.assert_array_equal(info["_final_info"], term | trunc)
    assert not info["_final_obs"].any()
    _, _, term, trunc, info = venv.step(a)       # horizon reached
    assert info["_final_obs"].all() and info["_final_info"].all()


def test_next_step_nonterminal_cost_matches_plain_step(monkeypatch):
    """NEXT_STEP's deferred reset runs only on a step where some env is
    pending (JAX pins a ``lax.cond`` in its lowered program; the port pins
    the reset batches a step draws): a non-terminal step draws none and
    does a DISABLED-mode plain step's work, its outputs equal bit for bit.
    Timed on the card by no test; a CPU timing under several test workers
    measures the workers."""
    params = im.default_params(periods=100000)  # never terminal in the window
    n = 2048
    venv = _venv(im.ENV, params, n, seed=0, autoreset_mode=AutoresetMode.NEXT_STEP)
    plain = _venv(im.ENV, params, n, seed=0, autoreset_mode=AutoresetMode.DISABLED)
    venv.reset()
    plain.reset()
    a = np.tile(np.array([5, 5, 5], np.int32), (n, 1))

    resets = []
    real_reset = vecenv.batch_reset
    monkeypatch.setattr(vecenv, "batch_reset",
                        lambda *args, **kw: resets.append(1) or real_reset(*args, **kw))
    for _ in range(4):
        got, want = venv.step(a), plain.step(a)
        for x, y in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(x, y)
    assert not resets, "a non-terminal NEXT_STEP step drew a reset batch"


def test_disabled_autoreset_mode():
    params = im.default_params(periods=2)
    venv = _venv(im.ENV, params, 4, seed=0, autoreset_mode=AutoresetMode.DISABLED)
    venv.reset()
    a = np.tile(np.array([5, 5, 5], np.int32), (4, 1))
    _, _, _, trunc, _ = venv.step(a)
    _, _, _, trunc, _ = venv.step(a)
    assert trunc.all()  # stays done until the caller resets
    obs, _ = venv.reset()
    np.testing.assert_array_equal(obs[:, 0], np.full(4, params.I0[0]))


def test_reset_seed_reproducible():
    params = nv.default_params(step_limit=4)
    venv = _venv(nv.ENV, params, 4, seed=0)
    o1, _ = venv.reset(seed=42)
    o2, _ = venv.reset(seed=42)
    np.testing.assert_array_equal(o1, o2)
    o3, _ = _venv(nv.ENV, params, 4, seed=42).reset()
    np.testing.assert_array_equal(o1, o3)        # the constructor's seed is reset's


# ------------------------------------------------- against the JAX package

USER_D = (17, 23, 20, 25, 14, 22)


def _im_pair():
    kw = dict(periods=len(USER_D), dist=5, user_D=USER_D)
    return (im.ENV, im.default_params(**kw)), (jim.ENV, jim.default_params(**kw))


def _net_pair():
    periods = 5
    user = [tuple(float(10 + 3 * j + t) for t in range(periods)) for j in range(4)]

    def with_user(mod):
        T = mod.default_topology(periods)
        return dataclasses.replace(T, rt_demand=tuple(("user", u) for u in user[:T.n_retail]))
    return ((tnet.ENV, tnet.default_params(topology=with_user(ttopo), num_periods=periods)),
            (jnet.ENV, jnet.default_params(topology=with_user(jtopo), num_periods=periods)))


@pytest.mark.parametrize("case", ["im-SameStep", "im-NextStep", "im-Disabled", "net-SameStep"])
def test_port_equals_jax_on_user_demand(case):
    family, mode = case.split("-")
    (tenv, tp), (jenv, jp) = _im_pair() if family == "im" else _net_pair()
    n, horizon = 6, tenv.horizon(tp)
    port = _venv(tenv, tp, n, seed=0, autoreset_mode=mode)
    ref = JaxVectorEnv(jenv, jp, num_envs=n, seed=0, autoreset_mode=mode)
    np.testing.assert_array_equal(port.reset(seed=1)[0], ref.reset(seed=1)[0])
    rng = np.random.default_rng(0)
    for t in range(2 * horizon + 1):
        actions = ref.action_space.sample() if family == "net" else \
            rng.integers(0, 60, size=(n, 3)).astype(np.int32)
        got, want = port.step(actions), ref.step(actions)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"obs, step {t}")
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, err_msg=f"reward, step {t}")
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
        assert sorted(got[4]) == sorted(want[4])
        for key in ("final_obs", "_final_obs", "_final_info"):
            if key in want[4]:
                np.testing.assert_array_equal(got[4][key], want[4][key], err_msg=key)
        if mode == "Disabled" and got[3].all():
            np.testing.assert_array_equal(port.reset()[0], ref.reset()[0])


_STANDIN_RUN = r"""
import json, sys
import numpy as np
sys.modules["gymnasium"] = None      # import gymnasium raises ImportError
from or_gym_inventory_torch.core import gym_compat
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.vector.gym_vector import BatchedGymVectorEnv
out = {}
for mode in ("SameStep", "NextStep"):
    venv = BatchedGymVectorEnv(im.ENV, im.default_params(periods=3), 4, seed=5,
                               autoreset_mode=mode, device="cpu")
    assert isinstance(venv, gym_compat.HostVectorEnv)
    assert venv.metadata["autoreset_mode"] is gym_compat.HostAutoresetMode(mode)
    assert venv.observation_space == gym_compat.host_batch_space(venv.single_observation_space, 4)
    assert venv.action_space.shape == (4, 3) and venv.action_space.contains(venv.action_space.sample())
    rows = [venv.reset(seed=2)[0].tolist()]
    for t in range(5):
        obs, rew, term, trunc, info = venv.step(np.full((4, 3), 9, np.int32))
        rows.append([obs.tolist(), rew.tolist(), trunc.tolist(),
                     info["final_obs"].tolist() if info else None])
    venv.close()
    assert venv.closed
    out[mode] = rows
print(json.dumps(out))
"""


def test_vector_env_on_the_stand_ins():
    """On ``core.gym_compat``'s stand-ins, in a process where gymnasium
    cannot be imported, the vector env steps what it steps on gymnasium's
    base, SAME_STEP and NEXT_STEP."""
    want = {}
    for mode in ("SameStep", "NextStep"):
        venv = _venv(im.ENV, im.default_params(periods=3), 4, seed=5, autoreset_mode=mode)
        rows = [venv.reset(seed=2)[0].tolist()]
        for t in range(5):
            obs, rew, term, trunc, info = venv.step(np.full((4, 3), 9, np.int32))
            rows.append([obs.tolist(), rew.tolist(), trunc.tolist(),
                         info["final_obs"].tolist() if info else None])
        want[mode] = rows
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _STANDIN_RUN], capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == want
