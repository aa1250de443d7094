// Hopper's asynchronous copy of one 4-byte word (a float or an int) from
// global to shared memory, started by the thread that later reads it, and
// its group fences; shared by the kernels that stage their streams ahead of
// the step (net_episode.cu K1 and K25, im_episode.cu K7). A word needs no
// alignment beyond its own, and a thread's copies complete by its own
// wait_group, so no block barrier is needed while each thread reads only
// what it copied.
#pragma once

template <class W>
__device__ __forceinline__ void cp_async4(W* dst, const W* src) {
  static_assert(sizeof(W) == 4, "cp_async4 copies one 4-byte word");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
