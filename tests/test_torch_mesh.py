"""``parallel/mesh`` of the port on two gloo ranks on the CPU, against the
JAX package's ``parallel/mesh`` on two of the conftest's CPU devices.

The ranks run once for the module (``torch_ranks.spawn("mesh", ...)``, one
process a rank that imports the port alone); each case reads its part:

- every rank's block of ``sharded_random_episode_returns`` and
  ``sharded_policy_episode_returns``, on all three families, equals the
  unsharded plain entry point (``fast_episodes.random_returns_on_seed`` /
  ``policy_returns_on_seed``) on that rank's seed, bit for bit; the scalar
  is the mean of the gathered returns; the two ranks' blocks differ;
- ``sharded_rollout`` and ``sharded_evaluate`` return JAX's shapes, the
  rollout's total is the sum of the gathered rewards, and the ranks' envs
  differ (tests/test_vector_parallel.py:116-127);
- the collectives: sums, means and rank-major gathers, equal on every rank.

``initialize_multihost`` also joins two OS processes over TCP, as
tests/test_multihost.py runs JAX's, on a free port. Tolerances: bit for bit
for the blocks and collectives; ``rtol=1e-6`` for a mean against NumPy's.
"""

import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.parallel import mesh as pm
from or_gym_inventory_torch.vector import fast_episodes
from or_gym_inventory_tpu.envs import newsvendor as jnv
from or_gym_inventory_tpu.parallel import mesh as jpm

CPU = "cpu"
WORLD = 2
FAMILIES = ("net", "im", "nv")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.spawn("mesh", tmp_path_factory.mktemp("mesh"), WORLD)


def _rank_seeds(seed):
    base = fast_episodes.kernel_seed(torch.Generator().manual_seed(seed))
    return [rng.rank_seed(base, r) for r in range(WORLD)]


@pytest.mark.parametrize("kind", ["random", "policy"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_rank_blocks_equal_the_unsharded_entry_point(ranks, kind, fam):
    env, params = torch_ranks._family_params()[fam]
    local = torch_ranks.MESH_LANES // WORLD
    rets, mean = ranks[0][f"{kind}_{fam}"]
    assert rets.shape == (torch_ranks.MESH_EPISODES * torch_ranks.MESH_LANES,)
    for other in ranks[1:]:
        assert torch.equal(other[f"{kind}_{fam}"][0], rets)
        assert torch.equal(other[f"{kind}_{fam}"][1], mean)
    blocks = rets.reshape(WORLD, -1)
    for r, seed in enumerate(_rank_seeds(11 if kind == "random" else 12)):
        if kind == "random":
            want = fast_episodes.random_returns_on_seed(params, seed, local,
                                                        torch_ranks.MESH_EPISODES, CPU)
        else:
            want = fast_episodes.policy_returns_on_seed(
                params, torch_ranks.policy_actor(env, params), seed, local,
                torch_ranks.MESH_EPISODES, device=CPU)
        assert torch.equal(blocks[r], want), r
    assert not torch.equal(blocks[0], blocks[1])
    np.testing.assert_allclose(float(mean), rets.double().mean().item(), rtol=1e-6)


def test_rank_seeds_are_philox_words_of_key_three(ranks):
    seeds = _rank_seeds(3)
    assert [out["rank_seed"] for out in ranks] == seeds
    assert len(set(seeds)) == WORLD and all(0 <= s < 2 ** 31 for s in seeds)
    w0 = rng.philox4x32_10(1, 0, 0, 0, 77, rng.RANK_KEY)[0]
    assert rng.rank_seed(77, 1) == int(w0) & 0x7FFFFFFF


def test_sharded_rollout_and_evaluate_have_jax_shapes(ranks):
    jmesh = jpm.make_mesh(jax.devices()[:WORLD])
    jp = jnv.default_params(step_limit=4)
    space = jnv.ENV.action_space(jp)

    def jpolicy(_s, obs, key, _t):
        return space.sample(key, (obs.shape[0],))

    jtraj, jtotal = jpm.sharded_rollout(jnv.ENV, jp, jpolicy, None, jax.random.PRNGKey(5),
                                        8, 3, mesh=jmesh)
    jtotals, jmean = jpm.sharded_evaluate(jnv.ENV, jp, jpolicy, None, jax.random.PRNGKey(6),
                                          8, mesh=jmesh)
    traj, total = ranks[0]["rollout"]
    for name in ("obs", "action", "reward", "done", "next_obs"):
        assert tuple(traj[name].shape) == tuple(getattr(jtraj, name).shape), name
        for other in ranks[1:]:
            assert torch.equal(other["rollout"][0][name], traj[name]), name
    assert total.shape == np.shape(jtotal)
    np.testing.assert_allclose(float(total), traj["reward"].double().sum().item(), rtol=1e-6)
    # each rank's envs draw their own demand: the two halves differ
    assert not torch.equal(traj["reward"][:, :4], traj["reward"][:, 4:])
    totals, mean = ranks[0]["evaluate"]
    assert totals.shape == jtotals.shape and mean.shape == np.shape(jmean)
    np.testing.assert_allclose(float(mean), totals.double().mean().item(), rtol=1e-6)
    assert not torch.equal(totals[:4], totals[4:])


def test_collectives(ranks):
    for r, out in enumerate(ranks):
        vec, scalar = out["sum"]
        assert torch.equal(vec, torch.tensor([3.0, 6.0])) and float(scalar) == 3.0
        assert torch.equal(out["mean"][0], torch.tensor([1.5, 3.0]))
        rows, cols, flags = out["gather"]
        assert torch.equal(rows, torch.tensor([[1.0] * 3] * 2 + [[2.0] * 3] * 2))
        assert torch.equal(cols, torch.tensor([[1.0] * 3 + [2.0] * 3] * 2))
        assert flags.dtype == torch.bool and flags.tolist() == [True, False]
        assert out["broadcast"] == {"from": 0}
        shard = out["shard"]
        assert shard["x"].tolist() == list(range(4 * r, 4 * r + 4))
        assert shard["y"][0].tolist() == [2 * r, 2 * r + 1]


def test_one_rank_mesh_without_a_process_group():
    """No process group: the mesh of this process, whose collectives change
    nothing, and the sharded returns of one rank on its rank seed."""
    mesh = pm.make_mesh(CPU)
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    x = torch.randn(5)
    assert mesh.sum([x])[0] is x and mesh.mean([x])[0] is x and mesh.gather(x) is x
    env, params = torch_ranks._family_params()["nv"]
    rets, mean = pm.sharded_random_episode_returns(params, torch.Generator().manual_seed(11),
                                                   6, mesh)
    want = fast_episodes.random_returns_on_seed(params, rng.rank_seed(
        fast_episodes.kernel_seed(torch.Generator().manual_seed(11)), 0), 6, 1, CPU)
    assert torch.equal(rets, want) and torch.equal(mean, torch.mean(want))
    with pytest.raises(ValueError, match="devices for a world"):
        pm.make_mesh([CPU, CPU])
    assert pm.make_mesh([CPU]).device.type == "cpu"


MULTIHOST = r"""
import sys
sys.modules["jax"] = None
import torch, torch.distributed as dist
from or_gym_inventory_torch.parallel import initialize_multihost, make_mesh
rank, port = int(sys.argv[1]), sys.argv[2]
initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout=60)
mesh = make_mesh("cpu")
total, = mesh.sum([torch.tensor(float(rank + 1))])
print(f"PROC{rank} WORLD {mesh.size} TOTAL {float(total)}", flush=True)
dist.destroy_process_group()
"""


def test_initialize_multihost_in_two_processes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(MULTIHOST)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(torch_ranks.os.environ, PYTHONPATH=str(torch_ranks.REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r}:\n{out[-3000:]}"
        assert f"PROC{r} WORLD 2 TOTAL 3.0" in out, out
