// One NetInvMgmt period on one thread, shared by every NetInvMgmt kernel
// (net_episode.cu K1-K3, K25, K26; net_policy.cu K4-K6, K29), so that they
// cannot drift apart. It replaces pallas_net_step._step_math (:34).
//
// Where the semantics are easy to get wrong:
// - Rounding: jnp.round rounds half to even, so rintf, never roundf (which
//   rounds half away from zero).
// - Contention runs over the reorder links in sorted-edge order; the
//   factory cap is min(avail, min(C, v*avail)); consumed += fulfilled / v is
//   a true division (__fdiv_rn): custom graphs may have v < 1.
// - A link with L = 0 delivers the order of the same period.
// - Order history: the JAX kernels shift a newest-first ring of lt_max x n_ro
//   rows (132 floats on the default graph) every period and read row L-1 of
//   each link. Here each link i keeps a ring of depth L_i (sum 61 on the
//   default graph): slot t % L_i holds the order of period t - L_i; it is
//   read, then overwritten with this period's order. Zero-initialised, so
//   no validity mask is needed for t < L_i. At the start of period t the
//   link's chronological window r[t-L_i .. t-1] is therefore slots
//   (t + j) % L_i for j = 0 .. L_i-1 (order_window below).
// - NaN: jnp.maximum/minimum propagate a NaN operand, fmaxf/fminf drop it;
//   the step uses nanmath.cuh's max_nan/min_nan.
// - FMA contraction is left on, so the profit may differ from the plain
//   version in the last bits; the state (integer-valued floats) is exact.
//
// Storage. The state is indexed at run time by topology indices (ro_sup[i],
// ro_pur[i], ro_ring[i], rt_ret[j]), so it cannot live in registers.
// step_view is one body over two views of it, with the same accessors:
// - FrameView: a thread's own Episode, sized to net_topo.cuh's maxima, in
//   local memory (1,792 bytes a thread). Only K29's wide route keeps it.
// - SharedView: the words the real graph needs (4 n_main + 2 n_ro + n_rt +
//   sum L_i: 108 on the default graph, 400 at the maxima) in dynamic shared
//   memory, laid out [word][thread] so that a warp's 32 accesses to one
//   warp-uniform word fall on 32 banks. ops/net_step.py _shared_state_plan
//   sizes it. K1, K2, K26, K4-K6 (over a tile's lanes) and K29 on the
//   cluster (over a CTA's lanes, [word][lane]) take it; K25 takes it with
//   one ring word per link with L > 0 (the arriving order; its packed
//   topology's ro_ring names that word), since it steps a single period.
// K2 first kept the frame. At 4,194,304 x 16 threads its ~624 live bytes a
// thread outran L1 and L2, and the old step's ~400 frame accesses an
// env-step (seven scratch arrays zeroed, three passes over the links, a
// profit pass through per-node sums) went out to HBM: 2,217 ms, 0.8% of its
// operations bound. step_view makes one pass over the links and sums the
// profit into a scalar, ~200 accesses an env-step, all to shared memory in
// K2 and K26: 0 bytes of stack, and K2 at 163-166 ms, 10.5-10.7% of its
// 17.52 ms bound, on an H100 80GB HBM3 at 700 W (PERF.md). K1 and K25 left
// the frame in the same way (net_episode.cu).
//
// The NetInvMgmt draws are here too (link_demand, draw_period, and the
// step's action and demand sources), built on philox.cuh. Random-policy
// kernels, key (seed, 0): the n_ro action words, then one demand word per
// retail link; action = float(word >> 8) * act_scale, act_scale =
// f32(act_hi / 2^24) (pallas_net_step.py:328-333). Policy kernels, key
// (seed, 1): one demand word per retail link, then, when stochastic, the
// n_ro u1 and the n_ro u2 words of the Box-Muller normals (the JAX kernels
// draw the demand before the policy, pallas_net_step.py:528/:654, and u1
// before u2, pallas_episode_kernels.py:69-70). A const (user/zero) link
// still owns its word, so the layout does not depend on the demand specs.
#pragma once

#include "nanmath.cuh"
#include "net_topo.cuh"
#include "philox.cuh"

// The thread frame of K29's wide route: the state, and the step's per-node
// scratch (consumed, arrivals, sold).
struct Episode {
  float X[NET_MAX_MAIN];
  float Y[NET_MAX_RO];
  float U[NET_MAX_RT];
  float ring[NET_MAX_RING];
  int slot[NET_MAX_RO];  // t % L_i
  float consumed[NET_MAX_MAIN], arrivals[NET_MAX_MAIN], sold[NET_MAX_MAIN];
};

// The step's view of an Episode.
struct FrameView {
  Episode& s;
  __device__ float& X(int n) const { return s.X[n]; }
  __device__ float& Y(int i) const { return s.Y[i]; }
  __device__ float& U(int j) const { return s.U[j]; }
  __device__ float& ring(int k) const { return s.ring[k]; }
  __device__ int& slot(int i) const { return s.slot[i]; }
  __device__ float& consumed(int n) const { return s.consumed[n]; }
  __device__ float& arrivals(int n) const { return s.arrivals[n]; }
  __device__ float& sold(int n) const { return s.sold[n]; }
};

// Word offsets of a thread's state in shared memory, sized to the real
// graph by ops/net_step.py _shared_state_plan (mirrored there by _NetSmem):
// X, consumed, arrivals and sold per main node, Y and slot per reorder link,
// U per retail link, then the rings.
struct NetSmem {
  int words, x, consumed, arrivals, sold, y, slot, u, ring;
};

// The step's view of the same words in dynamic shared memory, laid out
// [word][thread]: word k of thread t at smem[k * blockDim.x + t]. The
// topology loops are warp-uniform, so a warp's 32 accesses to one word fall
// on 32 banks.
struct SharedView {
  float *x_, *consumed_, *arrivals_, *sold_, *y_, *u_, *ring_;
  int* slot_;
  int n;  // the stride between a column's words: threads per block, or lanes

  __device__ SharedView(float* smem, const NetSmem& L)
      : SharedView(smem, L, (int)blockDim.x, (int)threadIdx.x) {}
  // column ``col`` of a [word][lane] region ``stride`` floats a word (K29 on
  // the cluster: a CTA's lanes, fewer than its threads)
  __device__ SharedView(float* smem, const NetSmem& L, int stride, int col) : n(stride) {
    float* p = smem + col;
    x_ = p + L.x * n;
    consumed_ = p + L.consumed * n;
    arrivals_ = p + L.arrivals * n;
    sold_ = p + L.sold * n;
    y_ = p + L.y * n;
    slot_ = reinterpret_cast<int*>(p + L.slot * n);
    u_ = p + L.u * n;
    ring_ = p + L.ring * n;
  }
  __device__ float& X(int k) const { return x_[k * n]; }
  __device__ float& Y(int k) const { return y_[k * n]; }
  __device__ float& U(int k) const { return u_[k * n]; }
  __device__ float& ring(int k) const { return ring_[k * n]; }
  __device__ int& slot(int k) const { return slot_[k * n]; }
  __device__ float& consumed(int k) const { return consumed_[k * n]; }
  __device__ float& arrivals(int k) const { return arrivals_[k * n]; }
  __device__ float& sold(int k) const { return sold_[k * n]; }
};

template <class S>
__device__ __forceinline__ void reset_view(const NetTopo& tp, const S& s) {
  for (int n = 0; n < tp.n_main; ++n) s.X(n) = tp.I0[n];
  for (int i = 0; i < tp.n_ro; ++i) {
    s.Y(i) = 0.f;
    s.slot(i) = 0;
    for (int k = 0; k < tp.ro_L[i]; ++k) s.ring(tp.ro_ring[i] + k) = 0.f;
  }
  for (int j = 0; j < tp.n_rt; ++j) s.U(j) = 0.f;
}

__device__ __forceinline__ void episode_reset(const NetTopo& tp, Episode& s) {
  reset_view(tp, FrameView{s});
}

// r[t - L_i + j] of link i at the start of period t, 0 <= j < L_i (zero
// before period 0).
__device__ __forceinline__ float order_window(const NetTopo& tp,
                                              const Episode& s, int i, int j) {
  const int L = tp.ro_L[i];
  int k = s.slot[i] + j;
  if (k >= L) k -= L;
  return s.ring[tp.ro_ring[i] + k];
}

// Sources of a period's actions (one value per reorder link) and demand (one
// per retail link), and sinks of its fulfilled orders (one per reorder
// link). The step calls each source and sink once per index, in index
// order, so a source may draw its words as it is read.
struct FromArray {  // a thread's own array
  const float* p;
  __device__ float operator()(int k) const { return p[k]; }
};

struct FromColumn {  // a column of a [row][lane] buffer in shared memory
  const float* p;
  int S;  // the stride between the column's rows
  __device__ float operator()(int k) const { return p[k * S]; }
};

struct FromStream {  // a (rows, B) slice of device memory, p at row 0 of the lane
  const float* p;
  long long stride;
  __device__ float operator()(int k) const { return __ldg(p + k * stride); }
};

// The random policy's action: (word >> 8) * act_scale, uniform on [0, act_hi).
struct DrawnActions {
  WordStream& ws;
  float act_scale;
  __device__ float operator()(int) const { return (float)(ws.next() >> 8) * act_scale; }
};

struct NoSink {  // the fulfilled orders are not kept
  __device__ void operator()(int, float) const {}
};

struct ToArray {  // a thread's own array
  float* p;
  __device__ void operator()(int k, float f) const { p[k] = f; }
};

struct ToRows {  // a (rows, B) slice of device memory, p at row 0 of the lane
  float* p;
  long long stride;
  bool on;  // false past the batch: nothing is written
  __device__ void operator()(int k, float f) const {
    if (on) p[k * stride] = f;
  }
};

// Demand of retail link j in period t from its word.
__device__ __forceinline__ float link_demand(const NetTopo& tp,
                                             const float* __restrict__ tables,
                                             int j, unsigned t, unsigned word) {
  const float* tab = tables + tp.rt_off[j];
  if (tp.rt_const[j]) return __ldg(tab + min((int)t, tp.rt_len[j] - 1));
  return tp.rt_base[j] + (float)count_le(tab, tp.rt_len[j], u01(word));
}

struct DrawnDemand {
  const NetTopo& tp;
  const float* tables;
  unsigned t;
  WordStream& ws;
  __device__ float operator()(int j) const { return link_demand(tp, tables, j, t, ws.next()); }
};

// One period (pallas_net_step._step_math) on the state view s: returns the
// undiscounted profit and hands each fulfilled order to the sink r. One pass over the reorder links does each link's contention,
// delivery, pipeline and profit terms, keeping _step_math's order of
// effects: contention reads the period's opening X (arrivals are kept apart
// until the pass ends), holding cost takes Y after the link's delivery, HC
// takes X after retail and the backlog penalty U after retail. A link's
// revenue cancels against its purchaser's cost unless the supplier is raw
// material, so only those links add -price * r. The state stays exact
// (integer-valued floats); the profit differs from the plain version's only
// in f32 summation order.
template <class S, class Act, class Dem, class Sink>
__device__ __forceinline__ float step_view(const NetTopo& tp, const S& s, const Act& act,
                                           const Dem& dem, const Sink& r) {
  for (int n = 0; n < tp.n_main; ++n) s.consumed(n) = s.arrivals(n) = s.sold(n) = 0.f;
  float total = 0.f;

  // 0-1) per reorder link: fulfillment with sequential supplier contention,
  // the delivery and the pipeline, the link's profit terms
  for (int i = 0; i < tp.n_ro; ++i) {
    // The link's loads first. None of them aliases a store of this
    // iteration (distinct fields; a link's supplier is not its purchaser),
    // but the compiler cannot know it and would hold each load behind the
    // store before it: loaded here, they issue together instead of one
    // shared-memory round trip after another on the lane's chain.
    const int sup = tp.ro_sup[i], pur = tp.ro_pur[i], L = tp.ro_L[i];
    const float req = max_nan(0.f, rintf(act(i)));
    const float y_in = s.Y(i), arr_in = s.arrivals(pur);
    float x_sup = 0.f, used = 0.f, sold = 0.f;
    if (sup >= 0) {
      x_sup = s.X(sup);
      used = s.consumed(sup);
      sold = s.sold(sup);
    }
    int slot = 0;
    float a = 0.f;
    if (L > 0) {
      slot = s.slot(i);
      a = s.ring(tp.ro_ring[i] + slot);
    }
    float f = req;
    if (sup >= 0) {
      float avail = max_nan(0.f, x_sup - used);
      if (tp.is_factory[sup])
        avail = min_nan(avail, min_nan(tp.C[sup], tp.v[sup] * avail));
      f = min_nan(req, avail);
      s.consumed(sup) = used + __fdiv_rn(f, tp.v[sup]);
      s.sold(sup) = sold + f;
    } else {
      total -= tp.ro_price[i] * f;
    }
    r(i, f);
    if (L > 0) {
      s.ring(tp.ro_ring[i] + slot) = f;
      s.slot(i) = slot + 1 == L ? 0 : slot + 1;
    } else {
      a = f;
    }
    const float y = y_in - a + f;
    s.Y(i) = y;
    s.arrivals(pur) = arr_in + a;
    total -= tp.ro_g[i] * max_nan(0.f, y);
  }
  for (int n = 0; n < tp.n_main; ++n)
    s.X(n) = s.X(n) + s.arrivals(n) - s.consumed(n);

  // 2-4) sequential retail fulfillment, with its revenue and backlog penalty
  for (int j = 0; j < tp.n_rt; ++j) {
    const int ret = tp.rt_ret[j];
    const float d = dem(j), u_in = s.U(j), x_ret = s.X(ret), sold = s.sold(ret);
    const float to_fill = max_nan(0.f, rintf(d)) + u_in;
    const float sl = min_nan(to_fill, max_nan(0.f, x_ret));
    s.X(ret) = x_ret - sl;
    s.sold(ret) = sold + sl;
    const float u = tp.backlog ? to_fill - sl : 0.f;
    s.U(j) = u;
    total += tp.rt_price[j] * sl - tp.rt_b[j] * u;
  }

  // 5) per-node holding and operating costs
  for (int n = 0; n < tp.n_main; ++n) {
    const float HC = tp.h[n] * max_nan(0.f, s.X(n));
    const float OC = tp.is_factory[n] ? __fdiv_rn(tp.o[n] * s.sold(n), tp.v[n]) : 0.f;
    total -= HC + OC;
  }
  return total;
}

// step_view on a thread's Episode, with the actions, demand and fulfilled
// orders in arrays.
__device__ __forceinline__ float step_period(const NetTopo& tp, Episode& s,
                                             const float* act, const float* dem,
                                             float* r) {
  return step_view(tp, FrameView{s}, FromArray{act}, FromArray{dem}, ToArray{r});
}

// The n_ro actions and n_rt demands of one (lane, episode, period) of the
// random-policy kernels, handed to the sinks act and dem as they are drawn
// (K2's DrawnActions and DrawnDemand, in K2's order).
template <class ActSink, class DemSink>
__device__ __forceinline__ void draw_period(const NetTopo& tp,
                                            const float* __restrict__ tables,
                                            unsigned seed, unsigned lane,
                                            unsigned e, unsigned t,
                                            float act_scale, const ActSink& act,
                                            const DemSink& dem) {
  WordStream ws(seed, 0u, lane, e, t);
  const DrawnActions draw_act{ws, act_scale};
  for (int i = 0; i < tp.n_ro; ++i) act(i, draw_act(i));
  const DrawnDemand draw_dem{tp, tables, t, ws};
  for (int j = 0; j < tp.n_rt; ++j) dem(j, draw_dem(j));
}
