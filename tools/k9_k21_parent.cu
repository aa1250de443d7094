// The first designs of K9 (sample_streams_debug_im, InvManagement's
// random-policy streams) and K21 (sample_normals_debug, the policy kernels'
// normals), kept for tools/k9_k21_sweep.py to time in turns with the
// package's kernels: copies of both kernels as csrc/im_episode.cu and
// csrc/nv_policy.cu held them before this redesign.
//
// - K9: one thread a (episode, lane) of a 1-D grid, found by dividing its
//   64-bit index by B, walks the lane's T periods: per period one
//   WordStream, the m1 action words into a frame sized to IM_MAX_M1 (the
//   stage loop to the run-time m1), the demand word, m1 + 1 stores.
// - K21: one thread an element (row, lane) of a 1-D grid, found by dividing
//   its 64-bit index by B: one Philox block, one normal.
//
// Built by the sweep with -I or_gym_inventory_torch/csrc; the C entry
// points take the arguments the package's take (K9: params, table, user_d,
// acts, dems, seed, B, E, T, stream; K21: out, seed, B, rows, stream).
// ``k9_k21_empty`` launches a kernel that does nothing, the launch floor of
// this ctypes path.

#include <cuda_runtime.h>

#include "im_step.cuh"
#include "launch.cuh"
#include "philox.cuh"

namespace {

__global__ void k_im_sample_streams_first(const __grid_constant__ ImParams p,
                                          const float* __restrict__ table,
                                          const int* __restrict__ user_d,
                                          int* __restrict__ acts, int* __restrict__ dems,
                                          unsigned seed, long long B, int E, int T) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  int act[IM_MAX_M1];
  for (int t = 0; t < T; ++t) {
    WordStream ws(seed, 0u, lane, e, (unsigned)t);
    im_draw_actions(p, ws, act);
    const long long row = (long long)t * E + e;  // (T, E, m1, B) and (T, E, B)
    for (int i = 0; i < p.m1; ++i) acts[(row * p.m1 + i) * B + lane] = act[i];
    dems[row * B + lane] = im_demand(p, table, user_d, t, ws.next());
  }
}

__global__ void k_sample_normals_first(float* __restrict__ out, unsigned seed, long long B,
                                       long long n) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const unsigned row = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)row * B);
  WordStream ws(seed, 1u, lane, 0u, row);
  const unsigned w0 = ws.next();
  out[idx] = normal01(w0, ws.next());  // (rows, B)
}

__global__ void k_empty() {}

}  // namespace

extern "C" {

int im_sample_streams_first(const ImParams* p, const float* table, const int* user_d,
                            int* acts, int* dems, unsigned seed, long long B, int E, int T,
                            cudaStream_t stream) {
  k_im_sample_streams_first<<<blocks_for(B * E), kThreads, 0, stream>>>(
      *p, table, user_d, acts, dems, seed, B, E, T);
  return (int)cudaGetLastError();
}

int sample_normals_first(float* out, unsigned seed, long long B, int rows,
                         cudaStream_t stream) {
  const long long n = B * rows;
  k_sample_normals_first<<<blocks_for(n), kThreads, 0, stream>>>(out, seed, B, n);
  return (int)cudaGetLastError();
}

int k9_k21_empty(cudaStream_t stream) {
  k_empty<<<1, 1, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
