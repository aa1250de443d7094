"""``vector.fast_episodes.random_episode_returns`` of the port against the
JAX package's XLA path.

The two draw from different generators, so they are compared as
distributions: the port's mean return must lie within 4 standard errors
(of the difference of the two means) of JAX's ``use_pallas=False`` mean at
2,048 episodes each. Shapes and the ``hostfn`` refusal are checked exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.vector import fast_episodes as tfe
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.vector import fast_episodes as jfe

CPU = "cpu"


@pytest.mark.parametrize("E", [1, 4])
def test_shape_and_kernel_plain_path(E):
    params = tnet.default_params(num_periods=10)
    g = torch.Generator().manual_seed(0)
    out = tfe.random_episode_returns(params, g, 32, episodes_per_lane=E, device=CPU)
    assert out.shape == (E * 32,) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    # the CPU path is K2's plain version, fed the seed drawn from the generator
    seed = tfe.kernel_seed(torch.Generator().manual_seed(0))
    ref = tns.episode_returns_fully_fused(params, seed, 1700.0, 32,
                                          episodes_per_lane=E, device=CPU)
    assert torch.equal(out, ref.reshape(-1))


def test_mean_matches_jax_xla_path():
    n = 2048
    mine = tfe.random_episode_returns(tnet.default_params(num_periods=30),
                                      torch.Generator().manual_seed(3), n,
                                      device=CPU).double().numpy()
    ref = np.asarray(jfe.random_episode_returns(
        jnet.default_params(num_periods=30), jax.random.PRNGKey(3), n,
        use_pallas=False), np.float64)
    se = np.sqrt(mine.var(ddof=1) / n + ref.var(ddof=1) / n)
    assert abs(mine.mean() - ref.mean()) < 4 * se, (mine.mean(), ref.mean(), se)


def test_hostfn_link_raises_before_any_launch():
    T = ttopo.default_topology(6)
    T = dataclasses.replace(T, rt_demand=(("hostfn", lambda **kw: 5, ()),))
    params = tnet.NetInvParams(topology=T, num_periods=6)
    g = torch.Generator().manual_seed(4)
    state = g.get_state()
    counts = tns.episode_returns_fully_fused.launches
    with pytest.raises(NotImplementedError, match="host callable"):
        tfe.random_episode_returns(params, g, 8, episodes_per_lane=2, device=CPU)
    # refused when the link specs are resolved: no seed drawn, nothing launched
    assert torch.equal(g.get_state(), state)
    assert tns.episode_returns_fully_fused.launches == counts


def test_user_demand_runs_in_the_kernel_path():
    T = ttopo.default_topology(6, user_D={(1, 0): [5.0, 0.0, 9.0, 1.0, 2.0, 7.0]})
    params = tnet.NetInvParams(topology=T, num_periods=6)
    out = tfe.random_episode_returns(params, torch.Generator().manual_seed(1), 16,
                                     device=CPU)
    assert out.shape == (16,) and torch.isfinite(out).all()


def test_other_families_and_devices_refuse():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfe.random_episode_returns(object(), torch.Generator(), 4, device=CPU)
    with pytest.raises(ValueError):
        tfe.random_episode_returns(tnet.default_params(), torch.Generator(), 4,
                                   episodes_per_lane=0, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfe.random_episode_returns(tnet.default_params(), torch.Generator(), 4)
