// Kernel K14: batched thin Householder QR of complex64 blocks, one thread
// block per block.
//
// Replaces: the per-site `jnp.linalg.qr` of yaqs_tpu/core/mps_ops.py
// canonicalize_right(method="qr") (the LQ of each absorbed site block, taken
// as the QR of its adjoint), shift_center_right and bond_spectra.  On the
// analog path the blocks are (d*chi, chi) = (128, 64) at B = 32, one launch
// a site; in the digital gate window's center shift (512, 64, 32).
//
// What it computes: a (n, k), n >= k, optionally loaded as the adjoint of a
// row-major (k, n) block, plus the complex64 rank-noise floor (eps32 *
// ||a||_F + 1e-16) * noise with a fixed real (n, k) noise matrix; then
// a = Q R with LAPACK's conventions (zgeqr2 / zlarfg / zung2r):
//   for j = 0 .. k-1: alpha = a[j, j], x = a[j+1:, j];
//     if x == 0 and Im(alpha) == 0: tau = 0 (H = I, R[j, j] = alpha);
//     else beta = -sign(Re alpha) * ||(alpha, x)||, tau = (beta - alpha) / beta,
//          v = (1, x / (alpha - beta)), R[j, j] = beta (real);
//     a[j:, j+1:] -= conj(tau) v (v^H a[j:, j+1:])
//   Q = H_0 ... H_{k-1} I[:, :k], built backwards, H_j = I - tau v v^H.
// So Q and R equal the LAPACK (and cuSOLVER) factors entry by entry on a
// full-rank input, and an exactly rank-deficient input gives tau = 0 where a
// column is already reduced, never 0/0.
//
// What bounds it on the card: latency.  A (128, 64) block is 2 * 64 KB of
// device traffic and about 8 M real FMAs (factorization plus Q), but the k
// column steps are sequential, each a norm, a scalar and a rank-one update.
// Design: the block lives column-major in shared memory (leading dimension
// n + 1, so a warp's row-major loads and column walks avoid bank conflicts),
// Q in a second shared buffer; one warp takes a column's norm, then each warp
// applies the reflector to its own columns (a warp-wide dot over the rows,
// then the update).  Device memory is read once and written once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;
constexpr int kMaxCols = 64;
constexpr float kEps32 = 1.1920928955078125e-07f;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) * b
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 warp_sum2(float2 v) {
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// y[j:, c] -= coef * v * (v^H y[j:, c]) for every column c in [c0, k), one
// warp a column; v = (1, col[j+1:]) with col the reflector's column of sa.
__device__ __forceinline__ void apply_reflector(const float2* sa, int lda, int j, float2 coef, float2* y,
                                                int c0, int n, int k) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float2* v = sa + j * lda;
  for (int c = c0 + warp; c < k; c += kWarps) {
    float2* col = y + c * lda;
    float2 w = make_float2(0.f, 0.f);
    for (int i = j + lane; i < n; i += 32) {
      const float2 vi = (i == j) ? make_float2(1.f, 0.f) : v[i];
      const float2 t = cmulc(vi, col[i]);
      w.x += t.x;
      w.y += t.y;
    }
    w = warp_sum2(w);
    const float2 cw = cmul(coef, w);
    for (int i = j + lane; i < n; i += 32) {
      const float2 vi = (i == j) ? make_float2(1.f, 0.f) : v[i];
      const float2 t = cmul(vi, cw);
      col[i].x -= t.x;
      col[i].y -= t.y;
    }
  }
}

__global__ void __launch_bounds__(kThreads) householder_qr_kernel(const float2* __restrict__ in, long long stride_in,
                                                                  const float* __restrict__ noise,
                                                                  float2* __restrict__ q_out,
                                                                  float2* __restrict__ r_out, int n, int k,
                                                                  int adjoint) {
  extern __shared__ float2 smem[];
  const int lda = n + 1;
  float2* sa = smem;                 // (k columns) x lda, column-major
  float2* sq = sa + k * lda;         // Q, the same layout
  float2* stau = sq + k * lda;       // k reflector scalars
  float* sred = reinterpret_cast<float*>(stau + k);  // kWarps partial sums
  const int b = blockIdx.x;
  const float2* src = in + b * stride_in;
  const int nk = n * k;

  // load: a[i, c] from a row-major (n, k) block, or conj(m[c, i]) from a
  // row-major (k, n) block; both read consecutive addresses per warp
  float part = 0.f;
  for (int e = threadIdx.x; e < nk; e += kThreads) {
    float2 x;
    int i, c;
    if (adjoint) {
      c = e / n;
      i = e % n;
      x = src[e];
      x.y = -x.y;
    } else {
      i = e / k;
      c = e % k;
      x = src[e];
    }
    sa[c * lda + i] = x;
    part += x.x * x.x + x.y * x.y;
  }
  part = warp_sum(part);
  if (threadIdx.x % 32 == 0) sred[threadIdx.x / 32] = part;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarps; ++w) total += sred[w];
  const float scale = kEps32 * sqrtf(total) + 1e-16f;
  for (int e = threadIdx.x; e < nk; e += kThreads) {
    const int i = e / k;
    const int c = e % k;
    sa[c * lda + i].x += scale * noise[e];
  }
  __syncthreads();

  // factorization
  for (int j = 0; j < k; ++j) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      float xn = 0.f;
      for (int i = j + 1 + lane; i < n; i += 32) {
        const float2 x = sa[j * lda + i];
        xn += x.x * x.x + x.y * x.y;
      }
      xn = warp_sum(xn);
      if (lane == 0) {
        const float2 alpha = sa[j * lda + j];
        if (xn == 0.f && alpha.y == 0.f) {
          stau[j] = make_float2(0.f, 0.f);
        } else {
          const float nrm = sqrtf(alpha.x * alpha.x + alpha.y * alpha.y + xn);
          const float beta = alpha.x >= 0.f ? -nrm : nrm;
          stau[j] = make_float2((beta - alpha.x) / beta, -alpha.y / beta);
          // scale = 1 / (alpha - beta), kept in the diagonal slot until the
          // column is scaled
          const float2 d = make_float2(alpha.x - beta, alpha.y);
          const float dd = d.x * d.x + d.y * d.y;
          sa[j * lda + j] = make_float2(d.x / dd, -d.y / dd);
          sred[kWarps] = beta;
        }
      }
    }
    __syncthreads();
    const float2 tau = stau[j];
    if (tau.x != 0.f || tau.y != 0.f) {
      const float2 scale = sa[j * lda + j];
      for (int i = j + 1 + threadIdx.x; i < n; i += kThreads) sa[j * lda + i] = cmul(sa[j * lda + i], scale);
      __syncthreads();
      if (threadIdx.x == 0) sa[j * lda + j] = make_float2(sred[kWarps], 0.f);
      apply_reflector(sa, lda, j, make_float2(tau.x, -tau.y), sa, j + 1, n, k);
    }
    __syncthreads();
  }

  // Q = H_0 ... H_{k-1} I[:, :k], from the last reflector back
  for (int e = threadIdx.x; e < nk; e += kThreads) {
    const int c = e / n;
    const int i = e % n;
    sq[c * lda + i] = make_float2(i == c ? 1.f : 0.f, 0.f);
  }
  __syncthreads();
  for (int j = k - 1; j >= 0; --j) {
    const float2 tau = stau[j];
    if (tau.x != 0.f || tau.y != 0.f) apply_reflector(sa, lda, j, tau, sq, j, n, k);
    __syncthreads();
  }

  float2* q = q_out + static_cast<long long>(b) * nk;
  for (int e = threadIdx.x; e < nk; e += kThreads) {
    const int i = e / k;
    const int c = e % k;
    q[e] = sq[c * lda + i];
  }
  float2* r = r_out + static_cast<long long>(b) * k * k;
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    const int i = e / k;
    const int c = e % k;
    r[e] = c >= i ? sa[c * lda + i] : make_float2(0.f, 0.f);
  }
}

}  // namespace

// in: batch blocks, each a row-major (n, k) block or, with adjoint, a
// row-major (k, n) block whose adjoint is factored, stride_in elements apart;
// noise: the floor's row-major real (n, k) matrix; q_out (batch, n, k) and
// r_out (batch, k, k), contiguous.
extern "C" int householder_qr_launch(const void* in, long long stride_in, const void* noise, void* q_out,
                                     void* r_out, int batch, int n, int k, int adjoint, void* stream) {
  if (batch <= 0 || k <= 0 || n < k || n > kMaxRows || k > kMaxCols || noise == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float2) * (2 * static_cast<size_t>(k) * (n + 1) + k) + sizeof(float) * (kWarps + 1);
  cudaError_t err = cudaFuncSetAttribute(householder_qr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  householder_qr_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), stride_in, static_cast<const float*>(noise), static_cast<float2*>(q_out),
      static_cast<float2*>(r_out), n, k, adjoint);
  return static_cast<int>(cudaGetLastError());
}
