// Kernel B: the Lanczos epilogue, per trajectory
//   out = nrm > 0 ? nrm * sum_i exp(coeff T)[i, 0] V[i, :] : x
// for the k x k real symmetric tridiagonal T of the Lanczos recurrence.
//
// Replaces: yaqs_tpu/ops/krylov.py _expm_col_tridiag (float32 branch) and the
// combination (small @ V) * nrm at the end of lanczos_expm_apply (XLA chain
// K3).  On the TJM slice it ends every two-site solve (n = d^2 chi^2 = 16384)
// and every one-site back-evolution (n = d chi^2 = 8192), with k = 4, and
// the digital TDVP gate windows with k = 25.
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
// trajectory's small exponential in dynamic shared memory (3 k^2 complex
// values, 96 KB at k = 64): each thread owns the entries tid, tid + 256, ...
// of every k x k product and keeps them in registers until the block has
// read both factors, so the squaring count s is a per-block loop bound and
// never leaves the chip.  The entries per thread are a template parameter
// (1 for k <= 16, 4 for k <= 32, 16 for k <= 64), so the analog path's
// k = 4 holds one register pair, not sixteen.  Then the block streams its
// chunk of V with coalesced loads, kColsPerThread columns per thread.  k runs
// from 1 to 64 (the window route of the digital path runs k = 25).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;
constexpr int kColsPerThread = 4;
constexpr int kTaylorTerms = 10;
constexpr int kMaxSquarings = 12;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Entry e = (i, j) of lhs @ rhs for k x k complex matrices in shared memory.
__device__ __forceinline__ float2 small_matmul_entry(const float2* lhs, const float2* rhs, int k, int e) {
  const int i = e / k, j = e % k;
  float2 acc = make_float2(0.f, 0.f);
  for (int l = 0; l < k; ++l) {
    const float2 p = cmul(lhs[i * k + l], rhs[l * k + j]);
    acc.x += p.x;
    acc.y += p.y;
  }
  return acc;
}

// Every entry of lhs @ rhs, held by its owning thread (entries tid + r * kThreads).
template <int kEntries>
__device__ __forceinline__ void small_matmul(const float2* lhs, const float2* rhs, int k, int tid,
                                             float2 (&e)[kEntries]) {
#pragma unroll
  for (int r = 0; r < kEntries; ++r) {
    const int idx = tid + r * kThreads;
    e[r] = idx < k * k ? small_matmul_entry(lhs, rhs, k, idx) : make_float2(0.f, 0.f);
  }
}

// kEntries: entries of each k x k product per thread, k * k <= kEntries * kThreads.
template <int kEntries>
__global__ void __launch_bounds__(kThreads)
lanczos_epilogue_kernel(const float* __restrict__ alphas, const float* __restrict__ betas, float cre,
                        float cim, const float2* __restrict__ v, const float* __restrict__ nrm,
                        const float2* __restrict__ x, long long sx, float2* __restrict__ out, int k, int n) {
  extern __shared__ float2 smem[];
  __shared__ float2 small[kMaxK];  // column 0
  __shared__ float colsum[kMaxK];  // column sums of |A|
  __shared__ int ssq;              // squaring count s
  __shared__ float sscale;         // 2^s
  const int kk = k * k;
  float2* sa = smem;               // A / 2^s
  float2* sm = sa + kk;            // A^p / 2^(s p)
  float2* sacc = sm + kk;          // Taylor sum, then its squarings

  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  for (int e = tid; e < kk; e += kThreads) {
    const int i = e / k, j = e % k;
    float t = 0.f;
    if (i == j) {
      t = alphas[b * k + i];
    } else if (j == i + 1) {
      t = betas[b * k + i];
    } else if (i == j + 1) {
      t = betas[b * k + j];
    }
    sa[e] = make_float2(cre * t, cim * t);  // complex coeff times real T
  }
  __syncthreads();
  if (tid < k) {
    float col = 0.f;
    for (int i = 0; i < k; ++i) col += hypotf(sa[i * k + tid].x, sa[i * k + tid].y);
    colsum[tid] = col;
  }
  __syncthreads();
  if (tid == 0) {
    float norm1 = 0.f;
    for (int j = 0; j < k; ++j) norm1 = fmaxf(norm1, colsum[j]);
    const float s = fminf(fmaxf(ceilf(log2f(fmaxf(norm1, 1e-30f) / 0.5f)), 0.f), float(kMaxSquarings));
    ssq = static_cast<int>(s);
    sscale = exp2f(s);
  }
  __syncthreads();
  for (int e = tid; e < kk; e += kThreads) {
    const float p = sscale;
    sa[e] = make_float2(sa[e].x / p, sa[e].y / p);
    const float one = (e / k == e % k) ? 1.f : 0.f;
    sm[e] = make_float2(one, 0.f);
    sacc[e] = make_float2(one, 0.f);
  }
  __syncthreads();
  float2 ent[kEntries];
  float fact = 1.f;
  for (int term = 1; term <= kTaylorTerms; ++term) {
    small_matmul<kEntries>(sm, sa, k, tid, ent);
    __syncthreads();
    fact *= static_cast<float>(term);
#pragma unroll
    for (int r = 0; r < kEntries; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < kk) {
        sm[idx] = ent[r];
        sacc[idx] = make_float2(sacc[idx].x + ent[r].x / fact, sacc[idx].y + ent[r].y / fact);
      }
    }
    __syncthreads();
  }
  const int nsq = ssq;
  for (int q = 0; q < nsq; ++q) {
    small_matmul<kEntries>(sacc, sacc, k, tid, ent);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kEntries; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < kk) sacc[idx] = ent[r];
    }
    __syncthreads();
  }
  if (tid < k) small[tid] = sacc[tid * k];
  __syncthreads();

  const float nb = nrm[b];
  const size_t vb = static_cast<size_t>(b) * k * n;
  const size_t xb = static_cast<size_t>(b) * sx;
  const size_t ob = static_cast<size_t>(b) * n;
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
    out[ob + j] = res;
  }
}

template <int kEntries>
int launch(const float* alphas, const float* betas, float cre, float cim, const float2* v, const float* nrm,
           const float2* x, long long sx, float2* out, int batch, int k, int n, cudaStream_t stream) {
  constexpr size_t kMaxSmem = sizeof(float2) * 3 * kEntries * kThreads;
  if constexpr (kMaxSmem > 48 * 1024) {  // above the default limit: raise it once per process
    static const cudaError_t configured = cudaFuncSetAttribute(
        lanczos_epilogue_kernel<kEntries>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
    if (configured != cudaSuccess) return static_cast<int>(configured);
  }
  const int per_block = kThreads * kColsPerThread;
  const dim3 grid((n + per_block - 1) / per_block, batch);
  const size_t smem = sizeof(float2) * 3 * static_cast<size_t>(k) * k;
  lanczos_epilogue_kernel<kEntries><<<grid, kThreads, smem, stream>>>(alphas, betas, cre, cim, v, nrm, x, sx, out, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// alphas, betas (batch, k) float; v (batch, k, n); nrm (batch,) float; out
// (batch, n), all contiguous; x (batch, n) with contiguous rows, sx elements
// apart (a start vector handed over in place, such as a site of the MPS).
extern "C" int lanczos_epilogue_launch(const void* alphas, const void* betas, float coeff_re, float coeff_im,
                                       const void* v, const void* nrm, const void* x, long long sx, void* out, int batch,
                                       int k, int n, void* stream) {
  if (batch <= 0 || batch > 65535 || k <= 0 || k > kMaxK || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto a = static_cast<const float*>(alphas);
  const auto bt = static_cast<const float*>(betas);
  const auto vv = static_cast<const float2*>(v);
  const auto nr = static_cast<const float*>(nrm);
  const auto xx = static_cast<const float2*>(x);
  const auto o = static_cast<float2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k * k <= kThreads) return launch<1>(a, bt, coeff_re, coeff_im, vv, nr, xx, sx, o, batch, k, n, s);
  if (k * k <= 4 * kThreads) return launch<4>(a, bt, coeff_re, coeff_im, vv, nr, xx, sx, o, batch, k, n, s);
  return launch<16>(a, bt, coeff_re, coeff_im, vv, nr, xx, sx, o, batch, k, n, s);
}
