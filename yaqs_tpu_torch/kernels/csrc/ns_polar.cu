// Kernel A: Newton–Schulz polar orthogonalization of a batch of complex64
// blocks, one thread block per block.
//
// Replaces: yaqs_tpu/ops/decomp.py newton_schulz_orthogonalize (the XLA chain
// K4).  On the TJM slice it orthonormalizes (d*chi, chi) = (128, 64) blocks
// in the subspace split, in the Newton canonicalization and in the final
// restore: three calls per bond of every sweep and one per site of every
// canonicalization.
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
// touches device memory once to load and once to store.  Each product is
// computed by 256 threads with a 4x4 register micro-tile of complex outputs
// whose rows and columns are strided by a quarter of the output, so that for
// a fixed tile slot consecutive threads read consecutive B columns (no bank
// conflicts) and share A rows (broadcast).  Plain FP32 FMAs, no tensor cores:
// the port runs with TF32 off, and the tuned schedule was validated at full
// float32 products.  One block per SM at this shared-memory size; splitting a
// block over a cluster is the next step for speed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 128;
constexpr int kMaxCols = 64;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// C(i, j) = sum_k A(i, k) B(k, j), i < M, j < N, k < K, all in shared memory.
// A(i, k) = conj(a[k * lda + i]) when CONJ_A (A = X^H of a row-major K x M
// matrix X), else a[i * lda + k].  B(k, j) = b[k * ldb + j].  Each output is
// handed to epi(i, j, value) by the thread that computed it.
template <bool CONJ_A, typename Epi>
__device__ __forceinline__ void smem_matmul(const float2* a, int lda, const float2* b, int ldb,
                                            int M, int N, int K, Epi epi) {
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
        if (i < M) {
          if (CONJ_A) {
            const float2 v = a[k * lda + i];
            av[r] = make_float2(v.x, -v.y);
          } else {
            av[r] = a[i * lda + k];
          }
        } else {
          av[r] = make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jt + c * tn;
        bv[c] = j < N ? b[k * ldb + j] : make_float2(0.f, 0.f);
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

__global__ void __launch_bounds__(kThreads)
ns_polar_kernel(const float2* __restrict__ in, float2* __restrict__ out, int m, int n) {
  extern __shared__ float2 smem[];
  float2* sx = smem;               // m * n, the iterate
  float2* sxg = sx + m * n;        // m * n, x g
  float2* sg = sxg + m * n;        // n * n, g = x^H x
  float* colsum = reinterpret_cast<float*>(sg + n * n);  // n
  float* colsq = colsum + n;                             // n
  float* rowsum = colsq + n;                             // m
  float* bound = rowsum + m;                             // 1

  const size_t base = static_cast<size_t>(blockIdx.x) * m * n;
  const int mn = m * n;
  for (int e = threadIdx.x; e < mn; e += blockDim.x) sx[e] = in[base + e];
  __syncthreads();

  // 1. scale by a guaranteed upper bound on sigma_max
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int i = 0; i < m; ++i) {
      const float2 v = sx[i * n + j];
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
        const float2 v = sx[i * n + j];
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
      const float2 v = sx[e];
      sx[e] = make_float2(v.x / bnd, v.y / bnd);
    }
  }
  __syncthreads();

  // 2-3. six quintic steps: x = a x + b xg + c (xg) g
  const float qa[6] = {3.4445f, 3.4445f, 3.4445f, 3.4445f, 2.0f, 2.0f};
  const float qb[6] = {-4.7750f, -4.7750f, -4.7750f, -4.7750f, -1.3333f, -1.3333f};
  const float qc[6] = {2.0315f, 2.0315f, 2.0315f, 2.0315f, 0.3333f, 0.3333f};
  for (int step = 0; step < 6; ++step) {
    smem_matmul<true>(sx, n, sx, n, n, n, m,
                      [&](int i, int j, float2 v) { sg[i * n + j] = v; });
    __syncthreads();
    smem_matmul<false>(sx, n, sg, n, m, n, n,
                       [&](int i, int j, float2 v) { sxg[i * n + j] = v; });
    __syncthreads();
    const float a = qa[step], b = qb[step], c = qc[step];
    // each (i, j) of x is read and written by the thread that owns it only
    smem_matmul<false>(sxg, n, sg, n, m, n, n, [&](int i, int j, float2 v) {
      const float2 x = sx[i * n + j];
      const float2 y = sxg[i * n + j];
      sx[i * n + j] = make_float2(a * x.x + b * y.x + c * v.x, a * x.y + b * y.y + c * v.y);
    });
    __syncthreads();
  }

  // 4. two cubic steps: x = 1.5 x - 0.5 x g
  for (int step = 0; step < 2; ++step) {
    smem_matmul<true>(sx, n, sx, n, n, n, m,
                      [&](int i, int j, float2 v) { sg[i * n + j] = v; });
    __syncthreads();
    smem_matmul<false>(sx, n, sg, n, m, n, n,
                       [&](int i, int j, float2 v) { sxg[i * n + j] = v; });
    __syncthreads();
    for (int e = threadIdx.x; e < mn; e += blockDim.x) {
      const float2 x = sx[e];
      const float2 y = sxg[e];
      sx[e] = make_float2(1.5f * x.x - 0.5f * y.x, 1.5f * x.y - 0.5f * y.y);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < mn; e += blockDim.x) out[base + e] = sx[e];
}

}  // namespace

extern "C" int ns_polar_launch(const void* in, void* out, int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || m > kMaxRows || n > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float2) * (2 * static_cast<size_t>(m) * n + static_cast<size_t>(n) * n) +
                      sizeof(float) * (2 * n + m + 1);
  cudaError_t err = cudaFuncSetAttribute(ns_polar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_polar_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), static_cast<float2*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}
