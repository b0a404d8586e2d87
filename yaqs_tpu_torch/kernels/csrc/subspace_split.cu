// Kernel K5: the Newton half-step subspace split of a batch of complex64
// matrices, one thread block per matrix.
//
// Replaces: yaqs_tpu/ops/decomp.py split_matrix_subspace with
// qr_method="newton" (:181-308, the XLA chain K5): on the fast knob set every
// two-site split of the TDVP sweeps (the (2 chi, 2 chi) = (128, 128) block at
// B = 32 on the analog path) and of the digital bond sweeps and bond
// dissipators ((64, 64) at B = 512, chi = 32).
//
// What it computes, for m (rows, cols), the range-finder start omega and
// chi kept columns, exactly as the JAX function (NS = the Newton-Schulz
// polar factor of ns_polar.cuh):
//   "right": y = m omega (omega (cols, chi)); per iteration q = NS(y),
//            z = NS(m^H q), y = m z; left = NS(y), right = left^H m,
//            s = the row norms of right;
//   "left":  y = m^H omega (omega (rows, chi)); per iteration v0 = NS(y),
//            z = NS(m v0), y = m^H z; v = NS(y), left = m v, right = v^H,
//            s = the column norms of left.
//
// What bounds it on the card: arithmetic.  At (128, 128), chi = 64 and one
// iteration: three polar factors of 22 * 128 * 64 * 64 complex MACs and four
// products of 128 * 128 * 64, 19 M complex MACs a matrix, against 256 KB of
// device traffic.  Eager PyTorch runs it as three K4 launches and about 12
// other launches, the iterates going through device memory between them.
//
// Design: the iterate, x g and g of the polar factor stay in shared memory
// (two max(rows, cols) x chi buffers and one chi x chi: 160 KB at (128, 128),
// chi = 64), and the two buffers swap roles between the products and the
// polar factors, so no iterate leaves the block.  m itself (128 KB) does not
// fit beside them in the 227 KB a block may use, so every product reads it
// from device memory: 4 MB at B = 32, which stays in the 50 MB L2 cache
// across the block's four reads.  Splitting m over a two-block cluster is
// the next step for speed.  One block per SM at this shared-memory size.

#include "ns_polar.cuh"

namespace {

__global__ void __launch_bounds__(kNsThreads)
subspace_split_kernel(const float2* __restrict__ m, const float2* __restrict__ omega, float2* __restrict__ left,
                      float2* __restrict__ right, float* __restrict__ s, int rows, int cols, int chi, int iters,
                      int left_isometric) {
  extern __shared__ float2 smem[];
  const int big = (rows > cols ? rows : cols) * chi;
  float2* buf_a = smem;
  float2* buf_b = buf_a + big;
  float2* sg = buf_b + big;
  float* red = reinterpret_cast<float*>(sg + chi * chi);
  const float2* mz = m + static_cast<size_t>(blockIdx.x) * rows * cols;
  float2* lz = left + static_cast<size_t>(blockIdx.x) * rows * chi;
  float2* rz = right + static_cast<size_t>(blockIdx.x) * chi * cols;
  float* sz = s + static_cast<size_t>(blockIdx.x) * chi;

  // products with m read from device memory; X is a row-major buffer with chi columns
  auto m_times = [&](const float2* x, float2* out) {  // m X: (rows, chi)
    smem_matmul<false>(mz, cols, x, chi, rows, chi, cols, [&](int i, int j, float2 v) { out[i * chi + j] = v; });
    __syncthreads();
  };
  auto mh_times = [&](const float2* x, float2* out) {  // m^H X: (cols, chi)
    smem_matmul<true>(mz, cols, x, chi, cols, chi, rows, [&](int i, int j, float2 v) { out[i * chi + j] = v; });
    __syncthreads();
  };

  if (left_isometric) {
    // left factor isometric: the dominant column subspace of m
    m_times(omega, buf_a);
    for (int it = 0; it < iters; ++it) {
      ns_polar_block(buf_a, buf_b, sg, red, rows, chi);  // q
      mh_times(buf_a, buf_b);
      ns_polar_block(buf_b, buf_a, sg, red, cols, chi);  // z
      m_times(buf_b, buf_a);
    }
    ns_polar_block(buf_a, buf_b, sg, red, rows, chi);  // left
    for (int e = threadIdx.x; e < rows * chi; e += blockDim.x) lz[e] = buf_a[e];
    // right = left^H m: (chi, cols), into buf_b
    smem_matmul<true>(buf_a, chi, mz, cols, chi, cols, rows, [&](int i, int j, float2 v) { buf_b[i * cols + j] = v; });
    __syncthreads();
    for (int e = threadIdx.x; e < chi * cols; e += blockDim.x) rz[e] = buf_b[e];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = warp; i < chi; i += blockDim.x / 32) {
      float acc = 0.f;
      for (int j = lane; j < cols; j += 32) {
        const float2 v = buf_b[i * cols + j];
        acc = fmaf(v.x, v.x, fmaf(v.y, v.y, acc));
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) sz[i] = sqrtf(acc);
    }
  } else {
    // right factor isometric: the dominant row subspace of m
    mh_times(omega, buf_a);
    for (int it = 0; it < iters; ++it) {
      ns_polar_block(buf_a, buf_b, sg, red, cols, chi);  // v0
      m_times(buf_a, buf_b);
      ns_polar_block(buf_b, buf_a, sg, red, rows, chi);  // z
      mh_times(buf_b, buf_a);
    }
    ns_polar_block(buf_a, buf_b, sg, red, cols, chi);  // v
    for (int e = threadIdx.x; e < chi * cols; e += blockDim.x) {
      const int i = e / cols, j = e % cols;
      rz[e] = conj2(buf_a[j * chi + i]);
    }
    m_times(buf_a, buf_b);  // left = m v: (rows, chi)
    for (int e = threadIdx.x; e < rows * chi; e += blockDim.x) lz[e] = buf_b[e];
    for (int j = threadIdx.x; j < chi; j += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < rows; ++i) {
        const float2 v = buf_b[i * chi + j];
        acc = fmaf(v.x, v.x, fmaf(v.y, v.y, acc));
      }
      sz[j] = sqrtf(acc);
    }
  }
}

}  // namespace

// m (batch, rows, cols) contiguous; omega (cols, chi) when left_isometric,
// else (rows, chi); left (batch, rows, chi), right (batch, chi, cols), s
// (batch, chi) float
extern "C" int subspace_split_launch(const void* m, const void* omega, void* left, void* right, void* s, int batch,
                                     int rows, int cols, int chi, int iters, int left_isometric, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || chi <= 0 || iters < 0 || rows > kNsMaxRows || cols > kNsMaxRows ||
      chi > kNsMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int big = (rows > cols ? rows : cols) * chi;
  const size_t smem = sizeof(float2) * (2 * static_cast<size_t>(big) + static_cast<size_t>(chi) * chi) +
                      sizeof(float) * ns_scratch_floats(rows > cols ? rows : cols, chi);
  cudaError_t err = allow_smem(subspace_split_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  subspace_split_kernel<<<batch, kNsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(m), static_cast<const float2*>(omega), static_cast<float2*>(left),
      static_cast<float2*>(right), static_cast<float*>(s), rows, cols, chi, iters, left_isometric);
  return static_cast<int>(cudaGetLastError());
}
