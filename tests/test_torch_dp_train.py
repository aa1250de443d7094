"""Every learner's ``train(mesh=)`` and ``make_agent``'s seven names with
``mesh=`` on two gloo ranks on the CPU (the port of
``__graft_entry__.dryrun_multichip``, which runs JAX's on a device mesh).

The ranks run once for the module (``torch_ranks.spawn("train", ...)``,
processes that import the port alone). Checked, for PPO, A2C, recurrent PPO
and A2C_LSTM on both rollout paths and SAC, TD3 and DDPG on both collection
paths: the replicas' parameters are bit for bit equal after training, each
rank held ``num_envs / 2`` envs on the mesh's device, the metrics are finite
and ``timesteps`` counts the global batch; the n-step run of
tests/test_off_policy.py:143-160 fills 36 rows a rank (20 iterations, the
first two skipped, 2 envs a rank). The agents: replicas equal, rank 0 alone
saved, the checkpoint was there on every rank when ``train`` returned, and a
second ``train`` at the same budget skipped on both ranks.
"""

import numpy as np
import pytest
import torch

import torch_ranks

WORLD = 2
CASES = torch_ranks.train_cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.spawn("train", tmp_path_factory.mktemp("train"), WORLD)


def _equal_replicas(outs, key):
    mods = [out[key]["modules"] for out in outs]
    assert mods[0] and set(mods[0]) == set(mods[1])
    for k, v in mods[0].items():
        assert torch.equal(v, mods[1][k]), f"{key} {k}: the replicas differ"


@pytest.mark.parametrize("label", [k for k in CASES if k != "sac-nstep"])
def test_train_with_a_mesh_keeps_replicas_equal(ranks, label):
    learner, _, cfg, total, _ = CASES[label]
    _equal_replicas(ranks, label)
    for out in ranks:
        got = out[label]
        assert got["local_envs"] == cfg.num_envs // WORLD and got["device"] == "cpu"
        assert all(np.isfinite(v).all() for v in got["metrics"].values())
        assert got["metrics"]["timesteps"][-1] == total
    m0, m1 = (out[label]["metrics"] for out in ranks)
    np.testing.assert_array_equal(m0["mean_step_reward"], m1["mean_step_reward"])


def test_nstep_buffers_fill_in_lockstep(ranks):
    for out in ranks:
        assert out["sac-nstep"]["filled"] == 18 * 2
    _equal_replicas(ranks, "sac-nstep")


@pytest.mark.parametrize("name", [c[0] for c in torch_ranks.AGENT_CASES])
def test_make_agent_with_a_mesh(ranks, name):
    _equal_replicas(ranks, name)
    assert [out[name]["saves"] for out in ranks] == [[0], []]
    for out in ranks:
        assert out[name]["written"] and out[name]["skipped"] and out[name]["time"] == 0.0
    assert ranks[0][name]["type"] == ranks[1][name]["type"]
