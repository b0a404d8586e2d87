// Kernel K14: batched thin Householder QR of complex64 blocks, blocked in
// panels of kNb columns (the compact WY form), one thread block per block;
// optionally R alone.
//
// Replaces: the per-site `jnp.linalg.qr` of yaqs_tpu/core/mps_ops.py
// canonicalize_right(method="qr") (the LQ of each absorbed site block, taken
// as the QR of its adjoint), shift_center_right and bond_spectra (which
// keeps R only).  On the analog path the blocks are (d*chi, chi) = (128, 64)
// at B = 32, one launch a site; in the digital gate window's center shift
// (512, 64, 32).
//
// What it computes: a (n, k), n >= k, optionally loaded as the adjoint of a
// row-major (k, n) block, plus the complex64 rank-noise floor (eps32 *
// ||a||_F + 1e-16) * noise with a fixed real (n, k) noise matrix; then
// a = Q R with LAPACK's conventions (zgeqrf / zlarfg / zlarft / zlarfb /
// zungqr):
//   for j = 0 .. k-1: alpha = a[j, j], x = a[j+1:, j];
//     if x == 0 and Im(alpha) == 0: tau = 0 (H = I, R[j, j] = alpha);
//     else beta = -sign(Re alpha) * ||(alpha, x)||, tau = (beta - alpha) / beta,
//          v = (1, x / (alpha - beta)), R[j, j] = beta (real);
//     a[j:, j+1:] -= conj(tau) v (v^H a[j:, j+1:])
//   Q = H_0 ... H_{k-1} I[:, :k], H_j = I - tau v v^H.
// So Q and R equal the LAPACK (and cuSOLVER) factors entry by entry on a
// full-rank input, and an exactly rank-deficient input gives tau = 0 where a
// column is already reduced, never 0/0.
//
// What bounds it on the card: latency.  A (128, 64) block is 2 * 64 KB of
// device traffic and about 0.9 M complex MACs with Q, but its k column steps
// are sequential.  The unblocked form (one warp's norm, three block barriers
// and a rank-one update of every trailing column a step, then k more steps
// for Q) took 0.39 ms at B = 32.
//
// Design: the block lives column-major in shared memory (leading dimension
// n + 1, so a warp's row-major loads and column walks avoid bank conflicts).
// Panels of kNb = 8 columns (16 measured slower at every path's shape):
//  1. Panel factorization by one warp with the panel in registers (lane l
//     holds rows p + l + 32 q): a column's norm below the diagonal and the
//     dots of its reflector with the panel's later columns are warp sums, so
//     a column step has no block barrier; the reflectors go to the panel's
//     Y buffer and below a's diagonal.
//  2. The panel's triangular factor T (H_p ... H_{p+kNb-1} = I - Y T Y^H):
//     G = Y^H Y as step 3's W, then each row of T by one thread (a row of T
//     depends only on the same row's earlier entries).
//  3. The trailing columns: W = Y^H A (eight lanes a 4 x 4 tile of W, split
//     over the rows and added by shuffles), W = T^H W, A -= Y W (a 4 x 4
//     register tile a thread), with all 256 threads.
//  4. With Q: Q = I[:, :k], then panel by panel from the last, Q[p:, p:] -=
//     Y (T (Y^H Q[p:, p:])), Y read back from below a's diagonal.  Without
//     Q (want_q = 0, the bond spectra) this step and Q's write are skipped.
// Device memory is read once and written once.

#include <cuda_runtime.h>

#include "householder.cuh"
#include "launch.cuh"

namespace {

constexpr int kMaxRows = 128;
constexpr int kMaxCols = 64;
constexpr float kEps32 = 1.1920928955078125e-07f;

// Elements (float2) of shared memory a block takes: a, Q (want_q), the
// panel's Y, every panel's T, W and W2, tau and R's diagonal; then floats.
__host__ __device__ constexpr size_t smem_bytes(int n, int k, bool want_q) {
  const int lda = n + 1;
  const int panels = (k + kNb - 1) / kNb;
  return sizeof(float2) * (static_cast<size_t>(k) * lda * (want_q ? 2 : 1) + static_cast<size_t>(kNb) * lda +
                           static_cast<size_t>(panels) * kNb * kNb + 2 * static_cast<size_t>(kNb) * k + 2 * k) +
         sizeof(float) * kWarps;
}

// kQ = 4 (n <= 128) at up to 128 registers, two blocks an SM; kQ = 2 (n <=
// 64, the window's blocks) at up to 64, four blocks an SM.
template <int kQ>
__global__ void __launch_bounds__(kThreads, 8 / kQ) householder_qr_kernel(const float2* __restrict__ in, long long stride_in,
                                                                  const float* __restrict__ noise,
                                                                  float2* __restrict__ q_out,
                                                                  float2* __restrict__ r_out, int n, int k,
                                                                  int adjoint) {
  extern __shared__ float2 smem[];
  const bool want_q = q_out != nullptr;
  const int lda = n + 1;
  const int panels = (k + kNb - 1) / kNb;
  float2* sa = smem;                                 // (k columns) x lda, column-major
  float2* sq = sa + k * lda;                         // Q, the same layout (want_q)
  float2* sy = sq + (want_q ? k * lda : 0);          // the panel's reflectors, kNb columns
  float2* st = sy + kNb * lda;                       // each panel's T, kNb x kNb row-major
  float2* sw = st + panels * kNb * kNb;              // kNb x k
  float2* sw2 = sw + kNb * k;                        // kNb x k
  float2* stau = sw2 + kNb * k;                      // k
  float2* sdiag = stau + k;                          // k: R's diagonal
  float* sred = reinterpret_cast<float*>(sdiag + k);  // kWarps partial sums
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x;
  const float2* src = in + b * stride_in;
  const int nk = n * k;

  // load: a[i, c] from a row-major (n, k) block, or conj(m[c, i]) from a
  // row-major (k, n) block; both read consecutive addresses per warp
  float part = 0.f;
  for (int e = tid; e < nk; e += kThreads) {
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
  if (lane == 0) sred[warp] = part;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarps; ++w) total += sred[w];
  const float floor_scale = kEps32 * sqrtf(total) + 1e-16f;
  for (int e = tid; e < nk; e += kThreads) {
    const int i = e / k;
    const int c = e % k;
    sa[c * lda + i].x += floor_scale * noise[e];
  }
  __syncthreads();

  householder_factor<kQ>(sa, lda, sq, sy, st, sw, sw2, stau, sdiag, n, k, want_q);
  if (want_q) {
    float2* q = q_out + static_cast<long long>(b) * nk;
    for (int e = tid; e < nk; e += kThreads) {
      const int i = e / k;
      const int c = e % k;
      q[e] = sq[c * lda + i];
    }
  }
  float2* r = r_out + static_cast<long long>(b) * k * k;
  for (int e = tid; e < k * k; e += kThreads) {
    const int i = e / k;
    const int c = e % k;
    r[e] = c > i ? sa[c * lda + i] : (c == i ? sdiag[i] : make_float2(0.f, 0.f));
  }
}

}  // namespace

// in: batch blocks, each a row-major (n, k) block or, with adjoint, a
// row-major (k, n) block whose adjoint is factored, stride_in elements apart;
// noise: the floor's row-major real (n, k) matrix; q_out (batch, n, k), or
// null for R alone, and r_out (batch, k, k), contiguous.
extern "C" int householder_qr_launch(const void* in, long long stride_in, const void* noise, void* q_out,
                                     void* r_out, int batch, int n, int k, int adjoint, void* stream) {
  if (batch <= 0 || k <= 0 || n < k || n > kMaxRows || k > kMaxCols || noise == nullptr || r_out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(n, k, q_out != nullptr);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = n <= 64 ? householder_qr_kernel<2> : householder_qr_kernel<4>;
  cudaError_t err = allow_smem(kernel, smem_bytes(kMaxRows, kMaxCols, true));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), stride_in, static_cast<const float*>(noise), static_cast<float2*>(q_out),
      static_cast<float2*>(r_out), n, k, adjoint);
  return static_cast<int>(cudaGetLastError());
}
