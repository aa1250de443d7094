// Launch shape and error reporting shared by every kernel source, so that the
// block size cannot drift between families: one thread per env (or per
// activation column in mlp.cuh), kThreads to a block, the batch tail masked in
// each kernel. Each source includes it once and so exports the one C entry
// point that turns an error code its launchers returned into CUDA's message
// (ops/_build.py binds it as cuda_error_message in every library).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" const char* cuda_error_message(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
