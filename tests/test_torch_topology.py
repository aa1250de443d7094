"""The port's copies of the topology compiler and the CDF tables against the
JAX package's originals.

Everything here is host NumPy/Python on both sides, so every comparison is
exact: Topology fields, inversion thresholds (already rounded to f32), the
per-link kernel plans, and the parameters carried across by
``utils.interop``.
"""

import dataclasses

import numpy as np
import pytest

from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import distributions as tdist
from or_gym_inventory_torch.ops import net_step as tns
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_tpu.envs import net_inv_management as jnet
from or_gym_inventory_tpu.envs import topology as jtopo
from or_gym_inventory_tpu.ops import distributions as jdist
from or_gym_inventory_tpu.ops import pallas_net_step as pns

# the named specs of tests/test_pallas_fused.py:87-102, plus edge cases
SPECS = [("poisson", 20.0), ("binomial", 40, 0.3), ("negbinomial", 5, 0.4),
         ("randint", 3, 11), ("geometric", 0.25), ("normal", 20.0, 4.0),
         ("poisson", 0.0), ("binomial", 10, 1.0), ("normal", 7.5, 0.0),
         ("negbinomial", 8000, 0.9)]

USER_D = {(1, 0): [float(v) for v in range(1, 13)]}


@pytest.mark.parametrize("name,kw", [
    ("default_topology", {}),
    ("custom_topology", {}),
    ("default_topology", {"user_D": USER_D}),
])
def test_topology_equals_jax_field_by_field(name, kw):
    mine = getattr(ttopo, name)(12, **kw)
    ref = getattr(jtopo, name)(12, **kw)
    for f in dataclasses.fields(ref):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    for prop in ("n_main", "n_reorder", "n_retail", "lt_max", "obs_dim",
                 "order_cap_heuristic"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    for a, b in zip(mine.retail_dist_params(), ref.retail_dist_params(),
                    strict=True):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}{s[1:]}")
def test_cdf_table_equals_jax(spec):
    assert tdist.cdf_table_for_spec(spec) == jdist.cdf_table_for_spec(spec)


def test_table_refusals_match_jax():
    for spec in (("hostfn", lambda **kw: 0, ()), ("normal", 1e5, 5e3)):
        for mod in (tdist, jdist):
            with pytest.raises(NotImplementedError):
                mod.cdf_table_for_spec(spec)
    assert tdist.cdf_table_for_spec(("user", (1.0,))) is None


@pytest.mark.parametrize("rt", SPECS[:6] + [("user", (3.0, 1.0, 4.0)), ("zero",)],
                         ids=lambda s: s[0])
def test_link_specs_equal_jax(rt):
    T = ttopo.default_topology(10)
    mine = tns._topology_link_specs(dataclasses.replace(T, rt_demand=(rt,)), 10)
    ref = pns._topology_link_specs(
        dataclasses.replace(jtopo.default_topology(10), rt_demand=(rt,)), 10)
    assert mine == ref


@pytest.mark.parametrize("lam", [0.0, 1.0, 5.0, 20.0, 300.0])
def test_poisson_cdf_table_equals_jax(lam):
    assert tns._poisson_cdf_table(lam) == pns._poisson_cdf_table(lam)


@pytest.mark.parametrize("backlog,alpha", [(True, 1.0), (False, 0.9)])
def test_interop_params_round_trip(backlog, alpha):
    jp = jnet.default_params(topology=jtopo.custom_topology(20), num_periods=20,
                             backlog=backlog, alpha=alpha)
    tp = interop.net_params_from_numpy(dataclasses.asdict(jp.topology),
                                       jp.num_periods, jp.backlog, jp.alpha)
    assert tp == tnet.default_params(topology=ttopo.custom_topology(20),
                                     num_periods=20, backlog=backlog, alpha=alpha)
    assert tp.obs_dim == jp.obs_dim


def test_pack_topology_refuses_oversized_graph():
    T = ttopo.default_topology(10)
    wide = dataclasses.replace(T, ro_L=(40,) * T.n_reorder)
    with pytest.raises(ValueError, match="too large"):
        tns._pack_topology(tnet.NetInvParams(topology=wide, num_periods=10))
    tp, tables = tns._pack_topology(tnet.default_params(num_periods=10),
                                    tns._topology_link_specs(T, 10))
    assert tp.n_ro == 11 and tp.rt_len[0] == len(tables) == 49
    assert list(tp.ro_ring)[:11] == list(np.cumsum((0,) + T.ro_L[:-1]))
