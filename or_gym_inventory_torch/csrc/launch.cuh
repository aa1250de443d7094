// Launch shape and error reporting shared by every kernel source, so that the
// block size cannot drift between families: one thread per env (or per
// activation column in mlp.cuh), kThreads to a block, the batch tail masked in
// each kernel; and the opt-in to more than 48 KB of dynamic shared memory. Each source includes it once and so exports the one C entry
// point that turns an error code its launchers returned into CUDA's message
// (ops/_build.py binds it as cuda_error_message in every library).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" const char* cuda_error_message(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
