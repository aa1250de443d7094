// The InvManagement lane state the policy kernels step on, shared by the
// tile kernels K10-K12 (im_policy.cu) and K27 (im_offpolicy.cu): the fixed
// route's frame (ImEpisode and the ring of requested orders), or the chain
// route's column (im_step.cuh ImLane), with each route's period step.
#pragma once

#include <type_traits>

#include "im_step.cuh"

namespace {

// One period's step, with the requested orders pushed into the ring ``ah``.
template <bool BACKLOG>
__device__ __forceinline__ float step_and_record(const ImParams& p, ImEpisode& s,
                                                 int t, const int* act, int d,
                                                 int* ah) {
  int r_req[IM_MAX_M1];
  const int slot = s.slot;
  const float profit = im_step<BACKLOG>(p, s, t, act, d, r_req);
  if (p.lt > 0)
    for (int i = 0; i < p.m1; ++i) ah[slot * p.m1 + i] = r_req[i];
  return profit;
}

// A lane's state on the fixed route: the frame, as the parent kept it.
struct ImFrameLane {
  ImEpisode s;
  int ah[IM_MAX_LT * IM_MAX_M1];  // requested order of period q: slot q % lt
  int act[IM_MAX_M1];
};

// The lane state of route P (ImFrameLane, or the chain's column ImLane),
// and its period step with the requested orders pushed into its ring.
template <class P>
using ImLaneOf = typename std::conditional<im_chain<P>(), ImLane, ImFrameLane>::type;

template <bool BACKLOG>
__device__ __forceinline__ float lane_step(const ImParams& p, ImFrameLane& l, int t, int d) {
  return step_and_record<BACKLOG>(p, l.s, t, l.act, d, l.ah);
}
template <bool BACKLOG>
__device__ __forceinline__ float lane_step(const ImView& p, ImLane& l, int t, int d) {
  return im_step_any<BACKLOG>(p, l.s, t, l.act, d, l.ah + l.s.slot * p.m1);
}

// Point a chain lane at its column (a frame lane needs nothing).
__device__ __forceinline__ void lane_init(ImFrameLane&, const ImParams&, ImColumn) {}
__device__ __forceinline__ void lane_init(ImLane& l, const ImView& p, ImColumn col) {
  l = im_lane(col, p.m1, p.lt, true);
}

}  // namespace
