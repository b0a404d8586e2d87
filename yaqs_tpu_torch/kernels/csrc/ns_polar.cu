// Kernel A: Newton–Schulz polar orthogonalization of a batch of complex64
// blocks, one thread block per block.
//
// Replaces: yaqs_tpu/ops/decomp.py newton_schulz_orthogonalize (the XLA chain
// K4) where a polar factor is taken on its own.  The subspace split (K5,
// subspace_split.cu) and the Newton canonicalization (K6, ns_canon.cu) run
// the same schedule inside their own kernels, so on the analog and digital
// paths this kernel is no longer launched; it stays as the standalone polar
// factor and as the reference shape of the schedule, (d*chi, chi) =
// (128, 64).
//
// What it computes, in this order (the schedule must never change: in
// complex64 an extra lift promotes sub-eps noise directions into the basis):
//   1. x /= min(frobenius, sqrt(norm1 * norminf)) + 1e-30
//   2. 4 quintics  x = a x + b x g + c x g g,  g = x^H x, (a,b,c) = (3.4445, -4.7750, 2.0315)
//   3. 2 quintics  with (2, -1.3333, 0.3333)
//   4. 2 cubics    x = 1.5 x - 0.5 x g
//
// What bounds it on the card: arithmetic.  One (128, 64) block needs 22
// complex products of 128*64*64 multiply-adds, about 46 M real FMAs, and
// reads and writes only 2 * 64 KB of device memory.  Eager PyTorch runs the
// same schedule as ~40 launches with ~24 round trips of the iterate through
// device memory.
//
// Design: x (m*n), g = x^H x (n*n) and x g (m*n) stay in shared memory for
// all eight steps (160 KB at (128, 64), dynamic shared memory), so the block
// touches device memory once to load and once to store.  The schedule and
// the products are ns_polar_block of ns_polar.cuh, which K5 and K6 run too.
// One block per SM at this shared-memory size; splitting a block over a
// cluster is the next step for speed.

#include "ns_polar.cuh"

namespace {

__global__ void __launch_bounds__(kNsThreads)
ns_polar_kernel(const float2* __restrict__ in, float2* __restrict__ out, int m, int n) {
  extern __shared__ float2 smem[];
  float2* sx = smem;               // m * n, the iterate
  float2* sxg = sx + m * n;        // m * n, x g
  float2* sg = sxg + m * n;        // n * n, g = x^H x
  float* red = reinterpret_cast<float*>(sg + n * n);

  const size_t base = static_cast<size_t>(blockIdx.x) * m * n;
  const int mn = m * n;
  for (int e = threadIdx.x; e < mn; e += blockDim.x) sx[e] = in[base + e];
  __syncthreads();
  ns_polar_block(sx, sxg, sg, red, m, n);
  for (int e = threadIdx.x; e < mn; e += blockDim.x) out[base + e] = sx[e];
}

}  // namespace

extern "C" int ns_polar_launch(const void* in, void* out, int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || m > kNsMaxRows || n > kNsMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float2) * (2 * static_cast<size_t>(m) * n + static_cast<size_t>(n) * n) +
                      sizeof(float) * ns_scratch_floats(n);
  cudaError_t err = allow_smem(ns_polar_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_polar_kernel<<<batch, kNsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), static_cast<float2*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}
