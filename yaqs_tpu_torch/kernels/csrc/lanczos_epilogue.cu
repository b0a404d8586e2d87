// Kernel B: the Lanczos epilogue, per trajectory
//   out = nrm > 0 ? nrm * sum_i exp(coeff T)[i, 0] V[i, :] : x
// for the k x k real symmetric tridiagonal T of the Lanczos recurrence.
//
// Replaces: yaqs_tpu/ops/krylov.py _expm_col_tridiag (float32 branch) and the
// combination (small @ V) * nrm at the end of lanczos_expm_apply (XLA chain
// K3).  On the TJM slice it ends every two-site solve (n = d^2 chi^2 = 16384)
// and every one-site back-evolution (n = d chi^2 = 8192), with k = 4.
//
// What it computes, exactly as krylov.py:123-142: A = coeff T;
// s = clip(ceil(log2(max(||A||_1, 1e-30) / 0.5)), 0, 12); 10 Taylor terms of
// exp(A / 2^s); s squarings; column 0.
//
// What bounds it on the card: device memory.  The small exponential is a few
// hundred flops; streaming V (k n complex64) and x and writing out is
// (k + 2) n * 8 bytes per trajectory, 25 MB at B = 32, k = 4, n = 16384, i.e.
// about 7.5 us at 3.35 TB/s.  Eager PyTorch needs either a host sync to read
// the data-dependent squaring count s or 12 masked k x k squarings (dozens of
// tiny launches) before the combination.
//
// Design: grid (chunks of n, B).  Every block first recomputes its
// trajectory's small exponential in shared memory with k*k threads (one
// output entry each, so the squaring count s is a per-block loop bound and
// never leaves the chip), then streams its chunk of V with coalesced
// loads, kColsPerThread columns per thread.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;  // k * k <= kThreads
constexpr int kColsPerThread = 4;
constexpr int kTaylorTerms = 10;
constexpr int kMaxSquarings = 12;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// dst = lhs @ rhs for k x k complex matrices in shared memory; thread tid < k*k
// computes entry (tid / k, tid % k).  Callers synchronize around it.
__device__ __forceinline__ float2 small_matmul_entry(const float2* lhs, const float2* rhs, int k, int tid) {
  const int i = tid / k, j = tid % k;
  float2 acc = make_float2(0.f, 0.f);
  for (int l = 0; l < k; ++l) {
    const float2 p = cmul(lhs[i * k + l], rhs[l * k + j]);
    acc.x += p.x;
    acc.y += p.y;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
lanczos_epilogue_kernel(const float* __restrict__ alphas, const float* __restrict__ betas, float cre,
                        float cim, const float2* __restrict__ v, const float* __restrict__ nrm,
                        const float2* __restrict__ x, float2* __restrict__ out, int k, int n) {
  __shared__ float2 sa[kMaxK * kMaxK];    // A / 2^s
  __shared__ float2 sm[kMaxK * kMaxK];    // A^p / 2^(s p)
  __shared__ float2 sacc[kMaxK * kMaxK];  // Taylor sum, then its squarings
  __shared__ float2 small[kMaxK];         // column 0
  __shared__ int ssq;                     // squaring count s
  __shared__ float sscale;                // 2^s

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int kk = k * k;

  if (tid < kk) {
    const int i = tid / k, j = tid % k;
    float t = 0.f;
    if (i == j) {
      t = alphas[b * k + i];
    } else if (j == i + 1) {
      t = betas[b * k + i];
    } else if (i == j + 1) {
      t = betas[b * k + j];
    }
    sa[tid] = make_float2(cre * t, cim * t);  // complex coeff times real T
  }
  __syncthreads();
  if (tid == 0) {
    float norm1 = 0.f;
    for (int j = 0; j < k; ++j) {
      float col = 0.f;
      for (int i = 0; i < k; ++i) col += hypotf(sa[i * k + j].x, sa[i * k + j].y);
      norm1 = fmaxf(norm1, col);
    }
    const float s = fminf(fmaxf(ceilf(log2f(fmaxf(norm1, 1e-30f) / 0.5f)), 0.f), float(kMaxSquarings));
    ssq = static_cast<int>(s);
    sscale = exp2f(s);
  }
  __syncthreads();
  if (tid < kk) {
    const float p = sscale;
    sa[tid] = make_float2(sa[tid].x / p, sa[tid].y / p);
    const float one = (tid / k == tid % k) ? 1.f : 0.f;
    sm[tid] = make_float2(one, 0.f);
    sacc[tid] = make_float2(one, 0.f);
  }
  __syncthreads();
  float fact = 1.f;
  for (int term = 1; term <= kTaylorTerms; ++term) {
    float2 e = make_float2(0.f, 0.f);
    if (tid < kk) e = small_matmul_entry(sm, sa, k, tid);
    __syncthreads();
    fact *= static_cast<float>(term);
    if (tid < kk) {
      sm[tid] = e;
      sacc[tid] = make_float2(sacc[tid].x + e.x / fact, sacc[tid].y + e.y / fact);
    }
    __syncthreads();
  }
  const int nsq = ssq;
  for (int q = 0; q < nsq; ++q) {
    float2 e = make_float2(0.f, 0.f);
    if (tid < kk) e = small_matmul_entry(sacc, sacc, k, tid);
    __syncthreads();
    if (tid < kk) sacc[tid] = e;
    __syncthreads();
  }
  if (tid < k) small[tid] = sacc[tid * k];
  __syncthreads();

  const float nb = nrm[b];
  const size_t vb = static_cast<size_t>(b) * k * n;
  const size_t xb = static_cast<size_t>(b) * n;
  const int col0 = blockIdx.x * kThreads * kColsPerThread + tid;
#pragma unroll
  for (int p = 0; p < kColsPerThread; ++p) {
    const int j = col0 + p * kThreads;
    if (j >= n) break;
    float2 res;
    if (nb > 0.f) {
      float2 acc = make_float2(0.f, 0.f);
      for (int i = 0; i < k; ++i) {
        const float2 t = cmul(small[i], v[vb + static_cast<size_t>(i) * n + j]);
        acc.x += t.x;
        acc.y += t.y;
      }
      res = make_float2(acc.x * nb, acc.y * nb);
    } else {
      res = x[xb + j];
    }
    out[xb + j] = res;
  }
}

}  // namespace

extern "C" int lanczos_epilogue_launch(const void* alphas, const void* betas, float coeff_re, float coeff_im,
                                       const void* v, const void* nrm, const void* x, void* out, int batch,
                                       int k, int n, void* stream) {
  if (batch <= 0 || batch > 65535 || k <= 0 || k > kMaxK || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = kThreads * kColsPerThread;
  const dim3 grid((n + per_block - 1) / per_block, batch);
  lanczos_epilogue_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alphas), static_cast<const float*>(betas), coeff_re, coeff_im,
      static_cast<const float2*>(v), static_cast<const float*>(nrm), static_cast<const float2*>(x),
      static_cast<float2*>(out), k, n);
  return static_cast<int>(cudaGetLastError());
}
