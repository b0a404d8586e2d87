// Complex arithmetic on float2 (complex64) and double2 (complex128), and the
// last-block reduction that the Lindblad and sparse-row kernels (K22, K23)
// use to add their blocks' partial sums in one launch.

#pragma once

#include <cuda_runtime.h>

namespace {

template <typename C>
struct RealOf;
template <>
struct RealOf<float2> {
  using T = float;
};
template <>
struct RealOf<double2> {
  using T = double;
};

__device__ __forceinline__ float rfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double rfma(double a, double b, double c) { return fma(a, b, c); }

template <typename C>
__device__ __forceinline__ C czero() {
  C z;
  z.x = 0;
  z.y = 0;
  return z;
}

// acc + a * b
template <typename C>
__device__ __forceinline__ C cfma(C a, C b, C acc) {
  acc.x = rfma(a.x, b.x, acc.x);
  acc.x = rfma(-a.y, b.y, acc.x);
  acc.y = rfma(a.x, b.y, acc.y);
  acc.y = rfma(a.y, b.x, acc.y);
  return acc;
}

// base + s * y, s real
template <typename C>
__device__ __forceinline__ C caxpy(typename RealOf<C>::T s, C y, C base) {
  base.x = rfma(s, y.x, base.x);
  base.y = rfma(s, y.y, base.y);
  return base;
}

// Re(a * b)
template <typename C>
__device__ __forceinline__ double re_mul(C a, C b) {
  return static_cast<double>(a.x) * b.x - static_cast<double>(a.y) * b.y;
}

// Sum over the lanes of each group of `width` lanes (a power of two); every
// lane of the warp must call it.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int off = width / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return v;
}

// After a block has written its partial sums: true in every thread of the
// one block that finishes last (which may then read every block's partials
// with __ldcg).  `counter` starts at zero and is left at zero.
__device__ __forceinline__ bool last_block_done(unsigned* counter) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(counter, 1u);
    last = ticket == gridDim.x * gridDim.y - 1;
    if (last) *counter = 0u;
  }
  __syncthreads();
  return last;
}

}  // namespace
