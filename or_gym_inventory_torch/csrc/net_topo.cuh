// The compiled supply network as the NetInvMgmt kernels take it: records of
// 32 bytes, the reorder links in sorted-edge order, then the main nodes,
// then the retail links in declaration order. The JAX package baked the
// topology into each Pallas kernel at trace time (ops/pallas_net_step.py:
// 10-14), so it runs any graph that envs/topology.compile_graph builds; here
// the wrapper packs the records at run time (ops/net_step.py _pack_topology,
// whose ctypes mirrors must match these structs field for field), so one
// build serves every graph too. Each kernel is built for two size classes,
// chosen by the wrapper from the graph's counts:
//
// - NetTopoSmall, a graph within the first design's maxima (16 main nodes,
//   32 reorder links, 16 retail links; the default graph): the first
//   design's struct of field arrays in the kernel's parameters
//   (__grid_constant__, 1,616 bytes), and its step, each field read through
//   the constant cache where the step needs it, so the default graph runs
//   the first design's code. Its records staged in shared memory, or read
//   through the read-only path, or its fields read a link ahead, ran the
//   default graph's kernels slower (tools/net_graph_sweep.py --designs,
//   PERF.md).
// - NetTopo, any other graph: a header by value (the counts and the records'
//   device address), each block copying the records into its shared memory
//   once, before its first period (topology_view); a record is
//   warp-uniform, so each load is a broadcast. They take 32 (n_main + n_ro +
//   n_rt) bytes of a block's shared memory beside its lanes' state, so the
//   one bound on a graph is the card's: a lane's state words beside the
//   records must fit the shared memory of a block of 32 threads (the
//   wrappers' plans, ops/net_step.py, raise past it).
//
// Both give the same record reads (link, node, retail) to the code around
// the step; net_step.cuh keeps one step body for each class.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

struct alignas(16) NetLink {  // a reorder link
  int sup;   // supplier index into the main nodes, -1 = raw material
  int pur;   // purchaser index into the main nodes
  int L;     // lead time
  int ring;  // offset of the link's order ring (depth L)
  float price, g;
  int pad0, pad1;
};

struct alignas(16) NetNode {  // a main node; a link's contention reads the first four words
  int is_factory;
  float C, v, h, o, I0;
  int pad0, pad1;
};

// A retail link and its demand plan: konst = 1 takes tables[off + min(t,
// len - 1)]; konst = 0 inverts the CDF thresholds tables[off, off + len) and
// adds base.
struct alignas(16) NetRetail {
  int ret;  // retailer index into the main nodes
  int konst, off, len;
  float price, b, base;
  int pad0;
};

// The size class of small graphs: the first design's struct, the counts and
// each field of the records in an array of its own, in the kernel's
// parameters. The step reads the fields as the first design did
// (net_step.cuh's overloads for NetTopoSmall); the rest read records
// assembled from them.
template <int RO, int MAIN, int RT>
struct NetTopoParams {
  int n_main, n_ro, n_rt, backlog;
  // reorder links, sorted-edge order
  int ro_sup[RO], ro_pur[RO], ro_L[RO], ro_ring[RO];
  float ro_price[RO], ro_g[RO];
  // main nodes
  int is_factory[MAIN];
  float I0[MAIN], h[MAIN], C[MAIN], o[MAIN], v[MAIN];
  // retail links, declaration order, and their demand plan (NetRetail)
  int rt_ret[RT];
  float rt_price[RT], rt_b[RT];
  int rt_const[RT], rt_off[RT], rt_len[RT];
  float rt_base[RT];

  __device__ __forceinline__ NetLink link(int i) const {
    NetLink r{};
    r.sup = ro_sup[i], r.pur = ro_pur[i], r.L = ro_L[i], r.ring = ro_ring[i];
    r.price = ro_price[i], r.g = ro_g[i];
    return r;
  }
  __device__ __forceinline__ NetNode node(int n) const {
    NetNode r{};
    r.is_factory = is_factory[n], r.C = C[n], r.v = v[n], r.h = h[n], r.o = o[n], r.I0 = I0[n];
    return r;
  }
  __device__ __forceinline__ NetRetail retail(int j) const {
    NetRetail r{};
    r.ret = rt_ret[j], r.konst = rt_const[j], r.off = rt_off[j], r.len = rt_len[j];
    r.price = rt_price[j], r.b = rt_b[j], r.base = rt_base[j];
    return r;
  }
};
using NetTopoSmall = NetTopoParams<32, 16, 16>;

// Any graph: the counts and the records' address in device memory.
struct NetTopo {
  int n_main, n_ro, n_rt, backlog;
  const int4* rec;  // n_ro NetLink, then n_main NetNode, then n_rt NetRetail
};

// NetTopo's records as the step reads them, from the block's shared memory,
// each read whole (two 16-byte loads; the compiler drops a half whose
// fields go unused).
struct TopoView {
  int n_main, n_ro, n_rt, backlog;
  const int4* rec;  // n_ro NetLink, then n_main NetNode, then n_rt NetRetail

  template <class R>
  __device__ __forceinline__ R record(int k) const {
    static_assert(sizeof(R) == 32, "a record is 32 bytes");
    const int4 v[2] = {rec[2 * k], rec[2 * k + 1]};
    R r;
    memcpy(&r, v, sizeof(R));
    return r;
  }
  __device__ __forceinline__ NetLink link(int i) const { return record<NetLink>(i); }
  __device__ __forceinline__ NetNode node(int n) const { return record<NetNode>(n_ro + n); }
  __device__ __forceinline__ NetRetail retail(int j) const {
    return record<NetRetail>(n_ro + n_main + j);
  }
};

// The floats of a block's shared memory that the records take: 8 a record
// for NetTopo, none for NetTopoSmall.
__host__ __device__ __forceinline__ int net_topo_floats(const NetTopo& tp) {
  return 8 * (tp.n_main + tp.n_ro + tp.n_rt);
}
__host__ __device__ __forceinline__ int net_topo_floats(const NetTopoSmall&) { return 0; }

// The topology a kernel's steps read. NetTopo: every thread of the block
// copies a share of the records into s (16-byte aligned,
// net_topo_floats(tp) floats), then the block waits for the copy, so call
// it before any thread of the block returns. NetTopoSmall: the parameter
// itself.
__device__ __forceinline__ TopoView topology_view(const NetTopo& tp, float* s) {
  int4* d = reinterpret_cast<int4*>(s);
  const int n = net_topo_floats(tp) / 4;
  for (int k = threadIdx.x; k < n; k += blockDim.x) d[k] = __ldg(tp.rec + k);
  __syncthreads();
  return TopoView{tp.n_main, tp.n_ro, tp.n_rt, tp.backlog, d};
}
__device__ __forceinline__ const NetTopoSmall& topology_view(const NetTopoSmall& tp, float*) {
  return tp;
}

// Call f with the size class the wrapper packed: the small struct when it
// gave one, else the header.
template <class F>
int with_topology(const NetTopo* topo, const NetTopoSmall* small, F f) {
  return small ? f(*small) : f(*topo);
}
