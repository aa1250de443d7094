// NaN-propagating min and max, shared by the float families' steps
// (net_step.cuh, nv_step.cuh). jnp.maximum, jnp.minimum and jnp.clip
// propagate a NaN operand; fmaxf/fminf drop it. These keep the JAX
// semantics, so a policy whose weights diverged, or a NaN action streamed
// in, gives NaN returns here as it does in the JAX package.
#pragma once

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}
