// The Newton–Schulz polar factor of one complex64 block held in shared
// memory, and the shared-memory products it is built from.  Used by K4
// (ns_polar.cu), K5 (subspace_split.cu) and K6 (ns_canon.cu), so that the
// three run one schedule and cannot drift apart.
//
// The schedule (yaqs_tpu/ops/decomp.py newton_schulz_orthogonalize) must
// never change: in complex64 an extra lift promotes sub-eps noise directions
// into the basis.
//   1. x /= min(frobenius, sqrt(norm1 * norminf)) + 1e-30
//   2. 4 quintics  x = a x + b x g + c x g g,  g = x^H x, (a,b,c) = (3.4445, -4.7750, 2.0315)
//   3. 2 quintics  with (2, -1.3333, 0.3333)
//   4. 2 cubics    x = 1.5 x - 0.5 x g
//
// Products are computed by the whole block with a 4x4 register micro-tile of
// complex outputs per thread whose rows and columns are strided by a quarter
// of the output, so that for a fixed tile slot consecutive threads read
// consecutive B columns (no bank conflicts) and share A rows (broadcast).
// Plain FP32 FMAs, no tensor cores: the port runs with TF32 off, and the
// tuned schedule was validated at full float32 products.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kNsThreads = 256;
constexpr int kNsMaxRows = 128;
constexpr int kNsMaxCols = 64;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float2 conj2(float2 a) { return make_float2(a.x, -a.y); }

// C(i, j) = sum_k A(i, k) B(k, j) for i < M, j < N, k < K: fa(i, k) and
// fb(k, j) read the operands (shared or device memory), and each output is
// handed to epi(i, j, value) by the thread that computed it.  The mapping of
// outputs to threads depends on (M, N) only, so two calls with the same
// (M, N) hand each (i, j) to the same thread.
template <typename FA, typename FB, typename Epi>
__device__ __forceinline__ void tile_matmul(int M, int N, int K, FA fa, FB fb, Epi epi) {
  const int tm = (M + 3) / 4;
  const int tn = (N + 3) / 4;
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int it = t / tn;
    const int jt = t % tn;
    float2 acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = make_float2(0.f, 0.f);
    for (int k = 0; k < K; ++k) {
      float2 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = it + r * tm;
        av[r] = i < M ? fa(i, k) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jt + c * tn;
        bv[c] = j < N ? fb(k, j) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) cfma(acc[r][c], av[r], bv[c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = it + r * tm;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jt + c * tn;
        if (i < M && j < N) epi(i, j, acc[r][c]);
      }
    }
  }
}

// C(i, j) = sum_k A(i, k) B(k, j) with row-major operands: A(i, k) =
// conj(a[k * lda + i]) when CONJ_A (A = X^H of a row-major K x M matrix X),
// else a[i * lda + k]; B(k, j) = b[k * ldb + j].
template <bool CONJ_A, typename Epi>
__device__ __forceinline__ void smem_matmul(const float2* a, int lda, const float2* b, int ldb, int M, int N, int K,
                                            Epi epi) {
  tile_matmul(
      M, N, K,
      [&](int i, int k) { return CONJ_A ? conj2(a[k * lda + i]) : a[i * lda + k]; },
      [&](int k, int j) { return b[k * ldb + j]; }, epi);
}

// Floats of scratch that ns_polar_block needs beside its three buffers.
__host__ __device__ constexpr int ns_scratch_floats(int m, int n) { return 2 * n + m + 1; }

// Replace x (m x n, row-major, shared memory) by its polar factor.  xg
// (m * n) and g (n * n) are shared-memory work buffers, red holds
// ns_scratch_floats(m, n) floats of shared memory.  The caller has written x
// and synchronized the block; on return x holds the result and the block is
// synchronized again.  m <= kNsMaxRows, n <= kNsMaxCols.
__device__ void ns_polar_block(float2* x, float2* xg, float2* g, float* red, int m, int n) {
  float* colsum = red;         // n
  float* colsq = colsum + n;   // n
  float* rowsum = colsq + n;   // m
  float* bound = rowsum + m;   // 1
  const int mn = m * n;

  // 1. scale by a guaranteed upper bound on sigma_max
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int i = 0; i < m; ++i) {
      const float2 v = x[i * n + j];
      const float av = hypotf(v.x, v.y);
      s += av;
      q = fmaf(av, av, q);
    }
    colsum[j] = s;
    colsq[j] = q;
  }
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = warp; i < m; i += blockDim.x / 32) {
      float s = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float2 v = x[i * n + j];
        s += hypotf(v.x, v.y);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) rowsum[i] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float norm1 = 0.f, norminf = 0.f, sq = 0.f;
    for (int j = 0; j < n; ++j) {
      norm1 = fmaxf(norm1, colsum[j]);
      sq += colsq[j];
    }
    for (int i = 0; i < m; ++i) norminf = fmaxf(norminf, rowsum[i]);
    *bound = fminf(sqrtf(sq), sqrtf(norm1 * norminf)) + 1e-30f;
  }
  __syncthreads();
  {
    const float bnd = *bound;
    for (int e = threadIdx.x; e < mn; e += blockDim.x) {
      const float2 v = x[e];
      x[e] = make_float2(v.x / bnd, v.y / bnd);
    }
  }
  __syncthreads();

  // 2-3. six quintic steps: x = a x + b xg + c (xg) g
  const float qa[6] = {3.4445f, 3.4445f, 3.4445f, 3.4445f, 2.0f, 2.0f};
  const float qb[6] = {-4.7750f, -4.7750f, -4.7750f, -4.7750f, -1.3333f, -1.3333f};
  const float qc[6] = {2.0315f, 2.0315f, 2.0315f, 2.0315f, 0.3333f, 0.3333f};
  for (int step = 0; step < 6; ++step) {
    smem_matmul<true>(x, n, x, n, n, n, m, [&](int i, int j, float2 v) { g[i * n + j] = v; });
    __syncthreads();
    smem_matmul<false>(x, n, g, n, m, n, n, [&](int i, int j, float2 v) { xg[i * n + j] = v; });
    __syncthreads();
    const float a = qa[step], b = qb[step], c = qc[step];
    // each (i, j) of x is read and written by the thread that owns it only
    smem_matmul<false>(xg, n, g, n, m, n, n, [&](int i, int j, float2 v) {
      const float2 xv = x[i * n + j];
      const float2 yv = xg[i * n + j];
      x[i * n + j] = make_float2(a * xv.x + b * yv.x + c * v.x, a * xv.y + b * yv.y + c * v.y);
    });
    __syncthreads();
  }

  // 4. two cubic steps: x = 1.5 x - 0.5 x g
  for (int step = 0; step < 2; ++step) {
    smem_matmul<true>(x, n, x, n, n, n, m, [&](int i, int j, float2 v) { g[i * n + j] = v; });
    __syncthreads();
    smem_matmul<false>(x, n, g, n, m, n, n, [&](int i, int j, float2 v) { xg[i * n + j] = v; });
    __syncthreads();
    for (int e = threadIdx.x; e < mn; e += blockDim.x) {
      const float2 xv = x[e];
      const float2 yv = xg[e];
      x[e] = make_float2(1.5f * xv.x - 0.5f * yv.x, 1.5f * xv.y - 0.5f * yv.y);
    }
    __syncthreads();
  }
}

// Set the dynamic shared-memory limit of a kernel and report the error.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

}  // namespace
