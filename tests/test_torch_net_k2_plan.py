"""The launch plan of K2 and K26 (``ops/net_step.py _shared_state_plan``)
and the ctypes mirrors of the structs the NetInvMgmt kernels take by value.

K2 (``episode_returns_fully_fused``) and K26 (``episode_returns_random_policy``)
keep each thread's state in dynamic shared memory, laid out [word][thread]
and sized to the real graph. The layout is computed in Python and handed to
the kernel (``struct NetSmem`` in csrc/net_step.cuh), so these tests check it
here, without a card: the word counts by hand, the topology's records (8
floats a link, main node and retail link) after the block's state, the
block size and the fit in an H100's 227 KB a block, and that each ctypes
mirror has its C struct's fields.
"""

import ctypes
import pathlib
import re

import pytest

from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import topology as ttopo
from or_gym_inventory_torch.ops import net_step as tns

CSRC = pathlib.Path(tns.__file__).resolve().parents[1] / "csrc"


# (graph, its counts (n_main, n_ro, n_rt, sum of L), words by hand, the word
# offsets of x, consumed, arrivals, sold, y, slot, u, ring, threads, bytes a
# block, blocks an SM). A graph of the small size class (at most 16 main
# nodes, 32 reorder links, 16 retail links) passes its records in the
# kernel's parameters; any other's take 8 floats a record after the
# threads' words.
CASES = {
    # 4*6 + 2*11 + 1 + 61 = 108 words; 4 blocks of 128 in 227 KB
    "default": (ttopo.default_topology, (6, 11, 1, 61), 108,
                (0, 6, 12, 18, 24, 35, 46, 47), 128, 55_296, 4),
    # the small class's maxima: 4*16 + 2*32 + 16 + 256 = 400 words, 1.6 KB a
    # thread
    "maxima": (None, (16, 32, 16, 256), 400,
               (0, 16, 32, 48, 64, 96, 128, 144), 128, 204_800, 1),
    # an L = 0 link and three retail links: 4*5 + 2*5 + 3 + 4 = 37
    "custom": (ttopo.custom_topology, (5, 5, 3, 4), 37,
               (0, 5, 10, 15, 20, 25, 30, 33), 128, 18_944, 11),
    # two L = 0 links and two retail links: 4*4 + 2*5 + 2 + 9 = 37
    "two_retail": (ttopo.two_retail_topology, (4, 5, 2, 9), 37,
                   (0, 4, 8, 12, 16, 21, 26, 28), 128, 18_944, 11),
    # every lead time 0: no ring at all, 4*3 + 2*2 + 1 = 17
    "no_ring": (None, (3, 2, 1, 0), 17,
                (0, 3, 6, 9, 12, 14, 16, 17), 128, 8_704, 16),
    # the default graph's nodes 1-8 eight times under one market:
    # 4*48 + 2*88 + 8 + 488 = 864 words; 128 threads would need 442,368
    # bytes, so 64: 864 * 4 * 64 + 144 * 32
    "default_regions_8": (None, (48, 88, 8, 488), 864,
                          (0, 48, 96, 144, 192, 280, 368, 376), 64, 221_184 + 4_608, 1),
    # the custom graph's nodes 1-6 six times: 4*30 + 2*30 + 18 + 24 = 222
    "custom_regions_6": (None, (30, 30, 18, 24), 222,
                         (0, 30, 60, 90, 120, 150, 180, 198), 128, 113_664 + 2_496, 1),
}
FIELDS = ("x", "consumed", "arrivals", "sold", "y", "slot", "u", "ring")


@pytest.mark.parametrize("name", list(CASES))
def test_plan_matches_a_hand_count(name):
    """At the first of 128, 64 and 32 threads a block whose shared memory
    holds the threads' state and the topology's records."""
    graph, counts, words, offsets, threads, nbytes, blocks = CASES[name]
    if graph is not None:
        T = graph()
        assert (T.n_main, T.n_reorder, T.n_retail, sum(T.ro_L)) == counts
    plan = tns._shared_state_plan(*counts)
    assert plan.words == words
    assert plan.offsets == dict(zip(FIELDS, offsets))
    assert (plan.threads, plan.bytes, plan.blocks_per_sm) == (threads, nbytes, blocks)
    small = counts[0] <= 16 and counts[1] <= 32 and counts[2] <= 16
    assert plan.topo_floats == (0 if small else 8 * (counts[0] + counts[1] + counts[2]))
    assert plan.bytes <= tns.SMEM_PER_BLOCK
    assert plan.blocks_per_sm * (plan.bytes + tns.SMEM_PER_BLOCK_RESERVED) <= tns.SMEM_PER_SM
    if threads < 128:   # the next block size up would not fit
        assert 4 * (words * 2 * threads + plan.topo_floats) > tns.SMEM_PER_BLOCK


@pytest.mark.parametrize("graph", ["default_topology", "custom_topology",
                                   "two_retail_topology"])
def test_shared_layout_mirrors_the_plan(graph):
    params = tnet.default_params(topology=getattr(ttopo, graph)(30), num_periods=30)
    plan, layout = tns._shared_layout(params.topology)
    assert layout.words == plan.words
    assert {f: getattr(layout, f) for f in FIELDS} == plan.offsets


def _c_struct_fields(header: str, struct: str):
    """[(name, element type, length)] of ``struct`` in csrc/``header``, the
    array lengths resolved from the header's #defines, plus a constant where
    one is added (1 for a scalar); a pointer's type is "ptr"."""
    text = (CSRC / header).read_text()
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", text)}
    body = re.search(r"struct (?:alignas\(\d+\) )?%s \{(.*?)\n\};" % struct, text,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        pointer = re.fullmatch(r"(?:const )?\w+\* (\w+)", decl)
        if pointer:
            fields.append((pointer.group(1), "ptr", 1))
            continue
        ctype, rest = decl.split(None, 1)
        for item in rest.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\w+)(?: \+ (\d+))?\])?", item.strip())
            length = defines[m.group(2)] + int(m.group(3) or 0) if m.group(2) else 1
            fields.append((m.group(1), ctype, length))
    return fields


_C_TYPES = {ctypes.c_int: "int", ctypes.c_float: "float", ctypes.c_void_p: "ptr"}


def _ctypes_fields(cls):
    out = []
    for name, ct in cls._fields_:
        elem, length = (ct._type_, ct._length_) if hasattr(ct, "_length_") else (ct, 1)
        out.append((name, _C_TYPES[elem], length))
    return out


def test_small_class_mirrors_its_template():
    """``_NetTopoSmall`` is ``NetTopoParams<32, 16, 16>``: the counts, then
    each record field in an array of its own (32 a link field, 16 a node
    and a retail field), 1,616 bytes as the first design's struct."""
    text = (CSRC / "net_topo.cuh").read_text()
    args = re.search(r"using NetTopoSmall = NetTopoParams<(\d+), (\d+), (\d+)>;", text)
    sizes = dict(zip(("RO", "MAIN", "RT"), (int(x) for x in args.groups())))
    assert (sizes["RO"], sizes["MAIN"], sizes["RT"]) == (tns.SMALL_RO, tns.SMALL_MAIN,
                                                        tns.SMALL_RT)
    body = re.search(r"struct NetTopoParams \{(.*?)\n\n", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl or decl.startswith("static"):
            continue
        ctype, rest = decl.split(None, 1)
        for item in rest.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\w+)\])?", item.strip())
            fields.append((m.group(1), ctype, sizes[m.group(2)] if m.group(2) else 1))
    assert _ctypes_fields(tns._NetTopoSmall) == fields
    assert ctypes.sizeof(tns._NetTopoSmall) == 4 * sum(n for _, _, n in fields) == 1_616


@pytest.mark.parametrize("header, struct, mirror", [
    ("net_topo.cuh", "NetTopo", tns._NetTopo),
    ("net_topo.cuh", "NetLink", tns._NetLink),
    ("net_topo.cuh", "NetNode", tns._NetNode),
    ("net_topo.cuh", "NetRetail", tns._NetRetail),
    ("net_step.cuh", "NetSmem", tns._NetSmem),
])
def test_ctypes_mirror_has_the_c_fields(header, struct, mirror):
    fields = _c_struct_fields(header, struct)
    assert _ctypes_fields(mirror) == fields
    size = {"int": 4, "float": 4, "ptr": 8}
    assert ctypes.sizeof(mirror) == sum(size[t] * n for _, t, n in fields)
    if struct != "NetTopo" and struct != "NetSmem":   # a record: two 16-byte loads
        assert ctypes.sizeof(mirror) == 4 * tns.RECORD_FLOATS


def test_block_size_is_launch_cuh_kthreads():
    """The plan's block size is the one the C entry points launch."""
    text = (CSRC / "launch.cuh").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", text).group(1)) == tns.THREADS
