// The compiled supply network as the NetInvMgmt kernels take it: one POD
// struct passed by value (__grid_constant__), so one build serves every
// graph. The JAX package baked the topology into each Pallas kernel at trace
// time (ops/pallas_net_step.py:10-14); here the wrapper packs it at run time
// (ops/net_step.py _pack_topology, whose ctypes mirror must match this
// layout field for field) and raises for a graph beyond the maxima.
#pragma once

#define NET_MAX_MAIN 16
#define NET_MAX_RO 32
#define NET_MAX_RT 16
#define NET_MAX_RING 256  // sum of the reorder links' lead times

struct NetTopo {
  int n_main, n_ro, n_rt, backlog;
  // reorder links, sorted-edge order
  int ro_sup[NET_MAX_RO];   // supplier index into the main nodes, -1 = raw material
  int ro_pur[NET_MAX_RO];   // purchaser index into the main nodes
  int ro_L[NET_MAX_RO];     // lead time
  int ro_ring[NET_MAX_RO];  // offset of the link's order ring (depth ro_L)
  float ro_price[NET_MAX_RO];
  float ro_g[NET_MAX_RO];
  // main nodes
  int is_factory[NET_MAX_MAIN];
  float I0[NET_MAX_MAIN], h[NET_MAX_MAIN], C[NET_MAX_MAIN], o[NET_MAX_MAIN],
      v[NET_MAX_MAIN];
  // retail links, declaration order
  int rt_ret[NET_MAX_RT];
  float rt_price[NET_MAX_RT], rt_b[NET_MAX_RT];
  // demand plan: rt_const = 1 takes tables[rt_off + min(t, rt_len - 1)];
  // rt_const = 0 inverts the CDF thresholds tables[rt_off, rt_off + rt_len)
  // and adds rt_base
  int rt_const[NET_MAX_RT], rt_off[NET_MAX_RT], rt_len[NET_MAX_RT];
  float rt_base[NET_MAX_RT];
};
