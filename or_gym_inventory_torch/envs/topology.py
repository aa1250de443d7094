"""Graph→tensor topology compiler for the network inventory environment.

A verbatim copy of ``or_gym_inventory_tpu/envs/topology.py`` (NumPy only):
importing that module would import the JAX package, so the PyTorch port
keeps its own copy, held field by field against the original by
tests/test_torch_topology.py.

The reference walks a live ``networkx.DiGraph`` inside ``step`` with pandas
``.loc`` scalar reads in triple-nested Python loops (network_management.py:
436-635) — measured at ~78 steps/s. Here the graph is compiled ONCE, at build
time, into static index/attribute tensors; the jitted step is then pure array
arithmetic with all topology constants folded by XLA.

Node/link classification mirrors network_management.py:146-195:
- market: no successors; rawmat: no predecessors; factory: has 'C';
- distrib: has 'I0', no 'C', not rawmat; retail: distrib with market successor;
- main_nodes = sorted(distrib + factory);
- reorder_links = sorted(edges with 'L'); retail_links = edges without 'L' in
  graph *declaration order* (that order fixes demand-draw order and the obs
  layout); network_links = sorted(all edges).

Demand sources per retail link follow network_management.py:240-267: a
``user_D`` array is used verbatim iff it is nonzero-sum and not
``sample_path``; otherwise the edge's distribution. The reference lets every
retail edge carry an arbitrary ``demand_dist_func`` callable + ``dist_param``
(default Poisson(lam=20)); here the same surface compiles to a NAMED demand
spec — poisson / binomial / negbinomial / randint / geometric / normal —
that samples on device (net_inv_management.sample_demand) and on host (the
Gymnasium adapter). Spec resolution per edge:

1. ``demand_dist`` (or a string ``demand_dist_func``): explicit name, with
   ``dist_param`` holding that distribution's numpy-Generator kwargs
   (poisson: lam; binomial/negbinomial: n, p; randint: low, high — numpy
   ``integers`` semantics, high EXCLUSIVE; geometric: p; normal: loc, scale
   — rounded half-even and clamped >= 0, as the reference wraps all demand
   in ``max(0, int(round(.)))``).
2. A callable ``demand_dist_func`` whose ``dist_param`` keys match a named
   spec ({lam} / {n,p} / {low,high} / {p} / {loc,scale}) is assumed to be
   the matching numpy sampler (exactly what the reference's default graph
   builds: ``lambda **p: self.np_random.poisson(**p)``). Pass an explicit
   ``demand_dist`` name if your callable shares kwargs with a different
   distribution.
3. A callable with unrecognizable kwargs compiles to a host-only
   ``("hostfn", ...)`` spec: the Gymnasium adapter calls it verbatim
   (full reference parity), while the device path raises with instructions
   to use a named spec.

Both reference topologies ship as built-ins: ``default_topology()``
(9 nodes / 12 edges, network_management.py:108-144) and
``custom_topology()`` (7 nodes / 8 edges, network_management_custom.py:108-139).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int]

# named demand specs: name -> ordered dist_param keys (numpy Generator kwargs;
# randint follows numpy `integers` semantics — high EXCLUSIVE)
_NAMED_SPECS = {
    "poisson": ("lam",),
    "binomial": ("n", "p"),
    "negbinomial": ("n", "p"),
    "randint": ("low", "high"),
    "geometric": ("p",),
    "normal": ("loc", "scale"),
}

# dist_param key-sets that identify a named spec when only a callable /
# bare dist_param is given (the reference default graph's
# ``lambda **p: self.np_random.poisson(**p)`` with {'lam': 20} resolves here)
_INFERABLE = {
    frozenset({"lam"}): "poisson",
    frozenset({"n", "p"}): "binomial",
    frozenset({"low", "high"}): "randint",
    frozenset({"p"}): "geometric",
    frozenset({"loc", "scale"}): "normal",
}


def _resolve_demand_spec(edge: Edge, attrs: Dict) -> Tuple:
    """Resolve one retail edge's distribution attrs into an rt_demand spec
    (the user_D-vs-distribution priority is handled by the caller, matching
    network_management.py:246-267)."""
    name = attrs.get("demand_dist")
    func = attrs.get("demand_dist_func")
    if name is None and isinstance(func, str):
        name = func
    dist_param = dict(attrs.get("dist_param", {}))
    if name is not None:
        if name not in _NAMED_SPECS:
            raise ValueError(
                f"Edge {edge}: unknown demand_dist {name!r}; known: "
                f"{sorted(_NAMED_SPECS)}")
        keys = _NAMED_SPECS[name]
        missing = [k for k in keys if k not in dist_param]
        if missing:
            raise ValueError(
                f"Edge {edge}: demand_dist {name!r} requires dist_param keys "
                f"{list(keys)}; missing {missing}")
        extra = sorted(set(dist_param) - set(keys))
        if extra:
            raise ValueError(
                f"Edge {edge}: demand_dist {name!r} takes dist_param keys "
                f"{list(keys)}; unexpected {extra}")
        return (name,) + tuple(float(dist_param[k]) for k in keys)
    inferred = _INFERABLE.get(frozenset(dist_param))
    if inferred is not None:
        keys = _NAMED_SPECS[inferred]
        return (inferred,) + tuple(float(dist_param[k]) for k in keys)
    if callable(func):
        # arbitrary host callable (reference demand_dist_func,
        # network_management.py:123-127): host adapter calls it verbatim;
        # the device path raises with instructions to use a named spec
        return ("hostfn", func,
                tuple(sorted(dist_param.items())))
    if dist_param or func is not None:
        raise ValueError(
            f"Edge {edge}: cannot resolve demand spec from "
            f"dist_param={sorted(dist_param)}; pass demand_dist=<name> from "
            f"{sorted(_NAMED_SPECS)}, a callable demand_dist_func, or user_D")
    return ("zero",)


@dataclasses.dataclass(frozen=True)
class Topology:
    """A compiled supply network. All fields are hashable statics; array-like
    fields are tuples so a Topology can parameterize jit specializations."""

    # node classification (original node ids)
    main_nodes: Tuple[int, ...]
    rawmat: Tuple[int, ...]
    market: Tuple[int, ...]
    factory: Tuple[int, ...]
    distrib: Tuple[int, ...]
    retail: Tuple[int, ...]

    # per-main-node attributes (aligned with main_nodes)
    I0: Tuple[float, ...]
    h: Tuple[float, ...]
    is_factory: Tuple[bool, ...]
    C: Tuple[float, ...]       # capacity (0 for non-factories)
    o: Tuple[float, ...]       # operating cost
    v: Tuple[float, ...]       # yield (1 for non-factories)

    # reorder links, sorted-edge order
    reorder_links: Tuple[Edge, ...]
    ro_sup_main: Tuple[int, ...]   # supplier index into main_nodes, -1 = rawmat
    ro_pur_main: Tuple[int, ...]   # purchaser index into main_nodes
    ro_L: Tuple[int, ...]
    ro_price: Tuple[float, ...]
    ro_g: Tuple[float, ...]

    # retail links, declaration order
    retail_links: Tuple[Edge, ...]
    rt_retailer_main: Tuple[int, ...]
    rt_price: Tuple[float, ...]
    rt_b: Tuple[float, ...]
    # demand spec per link (see module docstring):
    #   ("poisson", lam) | ("binomial", n, p) | ("negbinomial", n, p)
    #   | ("randint", low, high_exclusive) | ("geometric", p)
    #   | ("normal", loc, scale) | ("user", values-tuple)
    #   | ("hostfn", callable, ((key, val), ...)) | ("zero",)
    rt_demand: Tuple[Tuple, ...]

    @property
    def n_main(self) -> int:
        return len(self.main_nodes)

    @property
    def n_reorder(self) -> int:
        return len(self.reorder_links)

    @property
    def n_retail(self) -> int:
        return len(self.retail_links)

    @property
    def lt_max(self) -> int:
        return max(self.ro_L) if self.ro_L else 0

    @property
    def pipeline_obs_length(self) -> int:
        return int(sum(self.ro_L))

    @property
    def obs_dim(self) -> int:
        return self.n_retail + self.n_main + self.pipeline_obs_length

    @property
    def init_inv_max(self) -> float:
        return max(self.I0, default=100.0)

    @property
    def capacity_max(self) -> float:
        caps = [c for c, f in zip(self.C, self.is_factory) if f]
        return max(caps, default=100.0)

    @property
    def order_cap_heuristic(self) -> float:
        # network_management.py:195
        return self.init_inv_max + self.capacity_max * 5

    def retail_dist_params(self) -> Tuple[Dict, ...]:
        """Per-link demand spec dicts for the NumPy-parity stream generator
        (core/parity.net_inv_demand_stream)."""
        out = []
        for spec in self.rt_demand:
            if spec[0] == "user":
                out.append({"user_D": np.asarray(spec[1])})
            elif spec[0] == "zero":
                out.append({"user_D": np.zeros(1)})
            elif spec[0] == "hostfn":
                out.append({"dist": "hostfn", "func": spec[1],
                            **dict(spec[2])})
            else:
                keys = _NAMED_SPECS[spec[0]]
                out.append({"dist": spec[0],
                            **dict(zip(keys, spec[1:]))})
        return tuple(out)

    def validate(self):
        """Mirror of network_management.py:197-238 attribute checks."""
        for idx, j in enumerate(self.main_nodes):
            assert self.I0[idx] >= 0, f"Node {j}: Invalid or missing I0>=0"
            assert self.h[idx] >= 0, f"Node {j}: Invalid or missing h>=0"
            if self.is_factory[idx]:
                assert self.C[idx] > 0, f"Node {j}: Invalid or missing C>0"
                assert self.o[idx] >= 0, f"Node {j}: Invalid or missing o>=0"
                assert 0 < self.v[idx] <= 1, f"Node {j}: Invalid v in (0, 1]"
        for e, L, p, g in zip(self.reorder_links, self.ro_L, self.ro_price, self.ro_g):
            assert L >= 0, f"Edge {e}: Invalid or missing L>=0"
            assert p >= 0, f"Edge {e}: Invalid or missing p>=0"
            assert g >= 0, f"Edge {e}: Invalid or missing g>=0"
        for e, p, b in zip(self.retail_links, self.rt_price, self.rt_b):
            assert p >= 0, f"Edge {e}: Invalid or missing p>=0 (price)"
            assert b >= 0, f"Edge {e}: Invalid or missing b>=0 (backlog cost)"
        return self


def compile_graph(nodes: Dict[int, Dict], edges: Sequence[Tuple[int, int, Dict]],
                  num_periods: int,
                  user_D: Optional[Dict[Edge, Sequence[float]]] = None,
                  sample_path: Optional[Dict[Edge, bool]] = None) -> Topology:
    """Compile a node/edge description into a Topology.

    ``nodes`` maps node id -> attr dict ('I0', 'h', 'C', 'o', 'v'); ``edges``
    is a sequence of (u, v, attrs) with reorder attrs ('L','p','g') or retail
    attrs ('p','b', demand spec). Classification follows
    network_management.py:146-195.
    """
    user_D = dict(user_D or {})
    sample_path = dict(sample_path or {})

    succ: Dict[int, list] = {j: [] for j in nodes}
    pred: Dict[int, list] = {j: [] for j in nodes}
    edge_attrs: Dict[Edge, Dict] = {}
    for u, v, attrs in edges:
        succ[u].append(v)
        pred[v].append(u)
        edge_attrs[(u, v)] = dict(attrs)

    market = tuple(j for j in nodes if not succ[j])
    rawmat = tuple(j for j in nodes if not pred[j])
    factory = tuple(j for j in nodes if "C" in nodes[j])
    distrib = tuple(j for j in nodes
                    if "I0" in nodes[j] and "C" not in nodes[j] and j not in rawmat)
    retail = tuple(j for j in distrib if any(s in market for s in succ[j]))
    main_nodes = tuple(sorted(set(distrib) | set(factory)))
    main_index = {j: i for i, j in enumerate(main_nodes)}

    reorder_links = tuple(sorted(e for e in edge_attrs if "L" in edge_attrs[e]))
    retail_links = tuple(e for (u, v, _) in edges
                         if "L" not in edge_attrs[(u, v)] for e in [(u, v)])

    def _main_idx(j, role, edge):
        if j in main_index:
            return main_index[j]
        raise ValueError(f"Edge {edge}: {role} node {j} is not a main node")

    ro_sup, ro_pur, ro_L, ro_p, ro_g = [], [], [], [], []
    for e in reorder_links:
        u, v = e
        a = edge_attrs[e]
        ro_sup.append(main_index[u] if u in main_index else -1)
        if u not in main_index and u not in rawmat:
            raise ValueError(f"Edge {e}: supplier {u} neither main nor raw-material")
        ro_pur.append(_main_idx(v, "purchaser", e))
        ro_L.append(int(a["L"]))
        ro_p.append(float(a["p"]))
        ro_g.append(float(a["g"]))

    rt_ret, rt_p, rt_b, rt_d = [], [], [], []
    for e in retail_links:
        u, v = e
        a = edge_attrs[e]
        rt_ret.append(_main_idx(u, "retailer", e))
        rt_p.append(float(a["p"]))
        rt_b.append(float(a["b"]))
        # demand source resolution (network_management.py:246-267)
        ud = user_D.get(e, a.get("user_D"))
        sp = sample_path.get(e, a.get("sample_path", False))
        if ud is not None and np.sum(ud) > 0 and not sp:
            ud = np.asarray(ud, np.float64)
            if len(ud) != num_periods:
                raise AssertionError(
                    f"Edge {e}: user_D length {len(ud)} != num_periods {num_periods}")
            rt_d.append(("user", tuple(float(x) for x in ud)))
        else:
            rt_d.append(_resolve_demand_spec(e, a))

    def node_attr(name, default):
        return tuple(float(nodes[j].get(name, default)) for j in main_nodes)

    topo = Topology(
        main_nodes=main_nodes, rawmat=rawmat, market=market, factory=factory,
        distrib=distrib, retail=retail,
        I0=node_attr("I0", 0.0), h=node_attr("h", 0.0),
        is_factory=tuple(j in factory for j in main_nodes),
        C=node_attr("C", 0.0), o=node_attr("o", 0.0),
        v=tuple(float(nodes[j].get("v", 1.0)) for j in main_nodes),
        reorder_links=reorder_links,
        ro_sup_main=tuple(ro_sup), ro_pur_main=tuple(ro_pur),
        ro_L=tuple(ro_L), ro_price=tuple(ro_p), ro_g=tuple(ro_g),
        retail_links=retail_links,
        rt_retailer_main=tuple(rt_ret), rt_price=tuple(rt_p), rt_b=tuple(rt_b),
        rt_demand=tuple(rt_d),
    )
    return topo.validate()


def from_networkx(graph, num_periods: int,
                  user_D: Optional[Dict[Edge, Sequence[float]]] = None,
                  sample_path: Optional[Dict[Edge, bool]] = None) -> Topology:
    """Compile a ``networkx.DiGraph`` with reference-style attributes."""
    nodes = {j: dict(graph.nodes[j]) for j in graph.nodes()}
    edges = [(u, v, dict(a)) for u, v, a in graph.edges(data=True)]
    return compile_graph(nodes, edges, num_periods, user_D, sample_path)


def default_topology(num_periods: int = 30, **kw) -> Topology:
    """The reference default 9-node network (network_management.py:108-144)."""
    nodes = {
        0: {},                                                    # market
        1: dict(I0=100, h=0.030),                                 # retailer
        2: dict(I0=110, h=0.020),                                 # distributor
        3: dict(I0=80, h=0.015),                                  # distributor
        4: dict(I0=400, C=90, o=0.010, v=1.000, h=0.012),         # manufacturer
        5: dict(I0=350, C=90, o=0.015, v=1.000, h=0.013),         # manufacturer
        6: dict(I0=380, C=80, o=0.012, v=1.000, h=0.011),         # manufacturer
        7: {}, 8: {},                                             # raw materials
    }
    edges = [
        (1, 0, dict(p=2.000, b=0.100, dist_param=dict(lam=20))),
        (2, 1, dict(L=5, p=1.500, g=0.010)),
        (3, 1, dict(L=3, p=1.600, g=0.015)),
        (4, 2, dict(L=8, p=1.000, g=0.008)),
        (4, 3, dict(L=10, p=0.800, g=0.006)),
        (5, 2, dict(L=9, p=0.700, g=0.005)),
        (6, 2, dict(L=11, p=0.750, g=0.007)),
        (6, 3, dict(L=12, p=0.800, g=0.004)),
        (7, 4, dict(L=0, p=0.150, g=0.000)),
        (7, 5, dict(L=1, p=0.050, g=0.005)),
        (8, 5, dict(L=2, p=0.070, g=0.002)),
        (8, 6, dict(L=0, p=0.200, g=0.000)),
    ]
    return compile_graph(nodes, edges, num_periods, **kw)


def custom_topology(num_periods: int = 30, **kw) -> Topology:
    """The custom 7-node network (network_management_custom.py:108-139):
    1 market <- 3 retailers <- 1 distributor <- 1 factory <- 1 raw-material."""
    nodes = {
        0: {},
        1: dict(I0=120, h=0.200), 2: dict(I0=120, h=0.200), 3: dict(I0=120, h=0.200),
        4: dict(I0=900, h=0.200),
        5: dict(I0=1200, C=80, o=0.012, v=1.000, h=0.100),
        6: {},
    }
    retail = dict(p=25.000, b=0.200, dist_param=dict(lam=20))
    edges = [
        (1, 0, dict(retail)), (2, 0, dict(retail)), (3, 0, dict(retail)),
        (4, 1, dict(L=1, p=5.500, g=0.010)),
        (4, 2, dict(L=1, p=5.500, g=0.010)),
        (4, 3, dict(L=1, p=5.500, g=0.010)),
        (5, 4, dict(L=1, p=1.2, g=0.015)),
        (6, 5, dict(L=0, p=0.500, g=0.000)),
    ]
    return compile_graph(nodes, edges, num_periods, **kw)


def two_retail_topology(num_periods: int = 30, **kw) -> Topology:
    """A 6-node test network, not one of the reference's: two retail links
    (Poisson 20 and 15), a distributor that serves both retailers, one of
    them over an L = 0 link, a factory of yield 0.9 and a raw-material link
    of L = 0. It exercises what the default graph does not: several retail
    links, same-period deliveries and v < 1."""
    nodes = {0: {}, 1: dict(I0=100, h=0.03), 2: dict(I0=90, h=0.025), 3: dict(I0=200, h=0.02),
             4: dict(I0=300, C=70, o=0.01, v=0.9, h=0.012), 5: {}}
    edges = [(1, 0, dict(p=2.0, b=0.1, dist_param=dict(lam=20))),
             (2, 0, dict(p=2.2, b=0.12, dist_param=dict(lam=15))),
             (3, 1, dict(L=2, p=1.5, g=0.01)), (3, 2, dict(L=0, p=1.4, g=0.02)),
             (4, 3, dict(L=4, p=1.0, g=0.008)), (4, 2, dict(L=3, p=1.1, g=0.009)),
             (5, 4, dict(L=0, p=0.15, g=0.0))]
    return compile_graph(nodes, edges, num_periods, **kw)
