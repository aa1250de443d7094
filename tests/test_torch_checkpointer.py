"""The port's ``OrbaxCheckpointer`` (utils/checkpoint.py, on
``torch.distributed.checkpoint``): tests/test_utils.py:35-43's round trip of
an InvManagement state, ``max_to_keep``, ``restore()`` of an empty
directory, trees without a template, and on two gloo ranks
(``torch_ranks.spawn("ckpt", ...)``) a PPO run saved after its first
update and resumed from a fresh state that continues bit for bit as the run
that was not stopped, each rank with its own envs back. A tensor saved
under one key on both ranks comes back as one copy, the same on both: the
reason a rank's own state goes under ``PerRank``.
"""

import warnings

import pytest
import torch

import torch_ranks
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.utils import checkpoint as ckpt

WORLD = 2


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # DCP: "assuming ... a single process"
        yield


def test_orbax_checkpointer_roundtrip(tmp_path):
    params = im.default_params(periods=5)
    state, _ = im.reset(params, torch.Generator().manual_seed(0), device="cpu")
    mgr = ckpt.OrbaxCheckpointer(str(tmp_path / "orbax"))
    mgr.save(0, {"inv": state.inv, "period": state.period})
    mgr.wait()
    restored = mgr.restore(template={"inv": torch.zeros_like(state.inv),
                                     "period": torch.zeros_like(state.period)})
    assert torch.equal(restored["inv"], state.inv)
    assert torch.equal(restored["period"], state.period)


def test_restore_of_an_empty_directory_is_none(tmp_path):
    assert ckpt.OrbaxCheckpointer(str(tmp_path / "empty")).restore() is None


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_max_to_keep(tmp_path, keep):
    mgr = ckpt.OrbaxCheckpointer(str(tmp_path / "keep"), max_to_keep=keep)
    for step in range(4):
        mgr.save(step, {"x": torch.full((3,), float(step))})
    mgr.wait()
    assert mgr.all_steps() == list(range(4))[-keep:] and mgr.latest_step() == 3
    assert torch.equal(mgr.restore()["x"], torch.full((3,), 3.0))


def test_trees_without_a_template(tmp_path):
    """Dicts (int keys too), lists, tuples, numbers, strings, None and a
    generator's state come back as saved; a PerRank subtree unmarked."""
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2, dtype=torch.int32), 5, "x", None],
            "t": (torch.zeros(1), 2.5), 7: {"k": 1},
            "mine": ckpt.PerRank({"g": torch.Generator().manual_seed(3).get_state()})}
    mgr = ckpt.OrbaxCheckpointer(str(tmp_path / "tree"))
    mgr.save(5, tree)
    tree["a"] += 1          # the save copied the tensors when it started
    got = mgr.restore(5)
    assert torch.equal(got["a"], torch.arange(3.0)) and got["b"][1:] == [5, "x", None]
    assert got["b"][0].dtype == torch.int32 and isinstance(got["t"], tuple)
    assert got["t"][1] == 2.5 and got[7] == {"k": 1}
    assert torch.equal(got["mine"]["g"], tree["mine"].tree["g"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.spawn("ckpt", tmp_path_factory.mktemp("ckpt"), WORLD)


def test_two_rank_resume_continues_exactly(ranks):
    for r, out in enumerate(ranks):
        for k, v in out["uninterrupted"].items():
            assert torch.equal(out["resumed"][k], v), (r, k)
        mine, want = out["restored"]["rank"], out["after1"]["rank"].tree
        for k in ("last_obs", "ret_accum", "generator"):
            assert torch.equal(mine[k], want[k]), (r, k)
        for k, v in want["env_state"].items():
            assert torch.equal(mine["env_state"][k], v), (r, k)
        assert out["untemplated"]["rank"]["last_obs"].shape == want["last_obs"].shape
    # each rank got its own envs back; they differ between the ranks
    assert not torch.equal(ranks[0]["restored"]["rank"]["last_obs"],
                           ranks[1]["restored"]["rank"]["last_obs"])


def test_a_shared_key_keeps_one_copy(ranks):
    got = [out["restored"]["shared_obs"] for out in ranks]
    saved = [out["after1"]["shared_obs"] for out in ranks]
    assert torch.equal(got[0], got[1])
    assert any(torch.equal(got[0], s) for s in saved)


def test_two_rank_max_to_keep_and_latest(ranks):
    for out in ranks:
        assert out["steps"] == [2] and out["latest_update_idx"] == 2
