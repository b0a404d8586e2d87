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

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;
constexpr int kMaxCols = 64;
constexpr int kNb = 8;  // the panel width
constexpr float kEps32 = 1.1920928955078125e-07f;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc += a * b
__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// acc += conj(a) * b
__device__ __forceinline__ void cfmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// X[i, c] -= sum_r Y[i, r] W[r, c] for rows i in [p, n) and c < ct (X's
// column c at x + c * ld): a register tile of 4 x 4 outputs a thread, rows
// strided by a quarter of the rows and columns by a quarter of the columns,
// so that consecutive threads take consecutive columns and share rows.
__device__ __forceinline__ void sub_y_times_w(const float2* y, int ld, const float2* w, int nbp, float2* x, int p,
                                              int n, int ct) {
  const int M = n - p;
  const int tm = (M + 3) / 4;
  const int tn = (ct + 3) / 4;
  for (int t = threadIdx.x; t < tm * tn; t += kThreads) {
    const int it = t / tn, jt = t % tn;
    int ri[4], cj[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ri[r] = p + min(it + r * tm, M - 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) cj[c] = min(jt + c * tn, ct - 1);
    float2 acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = make_float2(0.f, 0.f);
    for (int l = 0; l < nbp; ++l) {
      float2 yv[4], wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = y[l * ld + ri[r]];
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[c] = w[l * ct + cj[c]];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) cfma(acc[r][c], yv[r], wv[c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (it + r * tm >= M) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (jt + c * tn >= ct) continue;
        float2* dst = x + cj[c] * ld + ri[r];
        dst->x -= acc[r][c].x;
        dst->y -= acc[r][c].y;
      }
    }
  }
}

// W[r, c] = sum_{i >= p} conj(Y[i, r]) X[i, c] for r < nbp, c < ct (Y's
// column r at y + r * ld, zero above row p + r; X's column c at x + c * ld).
// Eight adjacent lanes share a 4 x 4 tile of W, each over the rows i = p + s
// (mod 8), and add their sums by shuffles within the eight.
__device__ __forceinline__ void yh_times_x(const float2* y, const float2* x, int ld, int p, int n, int nbp, int ct,
                                           float2* w) {
  const int lane = threadIdx.x % 32, s = lane % 8;
  const unsigned group = 0xffu << (lane & ~7);
  const int tr = (nbp + 3) / 4, tc = (ct + 3) / 4;
  for (int t = threadIdx.x / 8; t < tr * tc; t += kThreads / 8) {
    const int r0 = (t / tc) * 4, c0 = (t % tc) * 4;
    int yo[4], xo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      yo[u] = min(r0 + u, nbp - 1) * ld;
      xo[u] = min(c0 + u, ct - 1) * ld;
    }
    float2 acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int i = p + s; i < n; i += 8) {
      float2 yv[4], xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        yv[u] = y[yo[u] + i];
        xv[u] = x[xo[u] + i];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) cfmac(acc[a][c], yv[a], xv[c]);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[a][c].x += __shfl_xor_sync(group, acc[a][c].x, off);
          acc[a][c].y += __shfl_xor_sync(group, acc[a][c].y, off);
        }
    // lane s of the eight writes the two entries with a * 4 + c = s (mod 8)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (((a * 4 + c) & 7) == s && r0 + a < nbp && c0 + c < ct) w[(r0 + a) * ct + c0 + c] = acc[a][c];
  }
}

// Factor the panel's columns [p, p + nbp) (rows p .. n-1 of sa) by one warp,
// the panel in registers (lane l holds rows p + l + 32 q), with no block
// barrier: a column's norm and the dots of its reflector with the panel's
// later columns are warp sums.  Writes the reflectors to sy (column r: zero
// from row p to p + r - 1, one at p + r), tau and R's diagonal, and the
// panel back to sa (R above the diagonal, the reflectors below it).  kQ:
// rows a lane, n <= 32 kQ.
template <int kQ>
__device__ void factor_panel(float2* sa, int lda, float2* sy, float2* stau, float2* sdiag, int p, int nbp, int n) {
  const int lane = threadIdx.x % 32;
  float2 a[kQ][kNb];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int row = p + lane + 32 * q;
#pragma unroll
    for (int c = 0; c < kNb; ++c) a[q][c] = row < n && c < nbp ? sa[(p + c) * lda + row] : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    if (j >= nbp) break;
    float xn = 0.f;
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (lane + 32 * q > j) xn = fmaf(a[q][j].x, a[q][j].x, fmaf(a[q][j].y, a[q][j].y, xn));
    xn = warp_sum(xn);
    const float2 alpha = make_float2(__shfl_sync(0xffffffffu, a[0][j].x, j), __shfl_sync(0xffffffffu, a[0][j].y, j));
    const bool reflect = !(xn == 0.f && alpha.y == 0.f);
    float2 tau = make_float2(0.f, 0.f), scale = make_float2(0.f, 0.f);
    float beta = alpha.x;
    if (reflect) {
      const float nrm = sqrtf(alpha.x * alpha.x + alpha.y * alpha.y + xn);
      beta = alpha.x >= 0.f ? -nrm : nrm;
      tau = make_float2((beta - alpha.x) / beta, -alpha.y / beta);
      const float2 d = make_float2(alpha.x - beta, alpha.y);
      const float dd = d.x * d.x + d.y * d.y;
      scale = make_float2(d.x / dd, -d.y / dd);
    }
    float2 v[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int rel = lane + 32 * q;
      v[q] = rel < j ? make_float2(0.f, 0.f)
                     : (rel == j ? make_float2(1.f, 0.f) : (reflect ? cmul(a[q][j], scale) : make_float2(0.f, 0.f)));
    }
    // H_j^H on the panel's later columns: a -= conj(tau) v (v^H a)
    float2 w[kNb];
#pragma unroll
    for (int c = j + 1; c < kNb; ++c) {
      w[c] = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kQ; ++q) cfmac(w[c], v[q], a[q][c]);
    }
    // the sums level by level, so that the shuffles of different columns
    // are independent of each other and pipeline
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int c = j + 1; c < kNb; ++c) {
        w[c].x += __shfl_xor_sync(0xffffffffu, w[c].x, off);
        w[c].y += __shfl_xor_sync(0xffffffffu, w[c].y, off);
      }
    const float2 ctau = make_float2(tau.x, -tau.y);
#pragma unroll
    for (int c = j + 1; c < kNb; ++c) {
      const float2 cw = cmul(ctau, w[c]);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float2 u = cmul(v[q], cw);
        a[q][c].x -= u.x;
        a[q][c].y -= u.y;
      }
    }
    // column j: R above the diagonal, beta on it, the reflector below
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int rel = lane + 32 * q;
      if (rel == j) a[q][j] = make_float2(beta, 0.f);
      if (rel > j) a[q][j] = v[q];
      if (p + rel < n) sy[j * lda + p + rel] = v[q];
    }
    if (lane == 0) {
      stau[p + j] = tau;
      sdiag[p + j] = make_float2(beta, 0.f);
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int row = p + lane + 32 * q;
#pragma unroll
    for (int c = 0; c < kNb; ++c)
      if (row < n && c < nbp) sa[(p + c) * lda + row] = a[q][c];
  }
}

// The panel's T (kNb x kNb, row-major) from G = Y^H Y (g, nbp x nbp
// row-major): row l by thread l.  T[l, r] = -tau_r sum_{l <= m < r} T[l, m]
// G[m, r], T[l, l] = tau_l; a row of T depends only on its own earlier
// entries.
__device__ __forceinline__ void triangular_factor(const float2* g, const float2* tau, int nbp, float2* t) {
  const int l = threadIdx.x;
  if (l >= nbp) return;
  float2* tl = t + l * kNb;
  for (int r = 0; r < l; ++r) tl[r] = make_float2(0.f, 0.f);
  tl[l] = tau[l];
  for (int r = l + 1; r < nbp; ++r) {
    float2 acc = make_float2(0.f, 0.f);
    for (int m = l; m < r; ++m) cfma(acc, tl[m], g[m * nbp + r]);
    const float2 tr = tau[r];
    tl[r] = make_float2(-(tr.x * acc.x - tr.y * acc.y), -(tr.x * acc.y + tr.y * acc.x));
  }
}

// Apply the panel's block reflector to ct columns of X (column c at x + c *
// ld), rows p .. n-1: X -= Y op(T) (Y^H X), op(T) = T^H (adjoint_t, the
// factorization's H^H) or T (forming Q).  y: the panel's nbp reflectors
// (column r zero above row p + r, one at it); t: its nbp x nbp factor (row
// stride kNb); w, w2: nbp x ct scratch.  Ends with the block synchronized.
__device__ __forceinline__ void apply_panel(const float2* y, int ld, const float2* t, bool adjoint_t, int nbp,
                                            float2* x, int p, int n, int ct, float2* w, float2* w2) {
  yh_times_x(y, x, ld, p, n, nbp, ct, w);
  __syncthreads();
  // W2 = op(T) W
  for (int e = threadIdx.x; e < nbp * ct; e += kThreads) {
    const int r = e / ct, c = e % ct;
    float2 acc = make_float2(0.f, 0.f);
    if (adjoint_t) {
      for (int l = 0; l <= r; ++l) cfmac(acc, t[l * kNb + r], w[l * ct + c]);
    } else {
      for (int l = r; l < nbp; ++l) cfma(acc, t[r * kNb + l], w[l * ct + c]);
    }
    w2[e] = acc;
  }
  __syncthreads();
  sub_y_times_w(y, ld, w2, nbp, x, p, n, ct);
  __syncthreads();
}

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

  // factorization, panel by panel
  for (int pi = 0; pi < panels; ++pi) {
    const int p = pi * kNb;
    const int nbp = min(kNb, k - p);
    // 1. the panel's reflectors, by warp 0
    if (warp == 0) factor_panel<kQ>(sa, lda, sy, stau, sdiag, p, nbp, n);
    __syncthreads();
    // 2. T, from G = Y^H Y
    float2* t = st + pi * kNb * kNb;
    yh_times_x(sy, sy, lda, p, n, nbp, nbp, sw);
    __syncthreads();
    triangular_factor(sw, stau + p, nbp, t);
    __syncthreads();
    // 3. the trailing columns: A -= Y T^H (Y^H A)
    if (p + nbp < k) apply_panel(sy, lda, t, true, nbp, sa + (p + nbp) * lda, p, n, k - p - nbp, sw, sw2);
  }

  // 4. Q = H_0 ... H_{k-1} I[:, :k], panel by panel from the last
  if (want_q) {
    for (int e = tid; e < nk; e += kThreads) {
      const int c = e / n;
      const int i = e % n;
      sq[c * lda + i] = make_float2(i == c ? 1.f : 0.f, 0.f);
    }
    for (int pi = panels - 1; pi >= 0; --pi) {
      const int p = pi * kNb;
      const int nbp = min(kNb, k - p);
      for (int e = tid; e < nbp * n; e += kThreads) {
        const int r = e / n, i = e % n;
        sy[r * lda + i] = i < p + r ? make_float2(0.f, 0.f)
                                    : (i == p + r ? make_float2(1.f, 0.f) : sa[(p + r) * lda + i]);
      }
      __syncthreads();
      apply_panel(sy, lda, st + pi * kNb * kNb, false, nbp, sq + p * lda, p, n, k - p, sw, sw2);
    }
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
