// The blocked compact-WY Householder QR of one complex64 (n, k) block by one
// thread block of kThreads (256) threads, in shared memory: K14's body
// (householder_qr.cu, whose header comment gives the algorithm and its
// LAPACK conventions), shared with K18 (subspace_power.cu) and K20
// (masked_qr.cu), which factor blocks they form or load themselves (K18 on
// its own noise floor, K20 with none).  A block's column j whose part below
// the diagonal is zero and whose diagonal is real takes tau = 0 (H = I,
// R[j, j] = a[j, j]): a zero column divides by nothing.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNb = 8;  // the panel width

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


// Factor a (n, k) in place (sa, column-major, leading dimension lda = n + 1
// or more; n >= k): R above the diagonal, the reflectors below it, tau in
// stau and R's real diagonal in sdiag; with want_q, form Q = H_0 ... H_{k-1}
// I[:, :k] in sq (the same layout).  Scratch: sy (kNb columns of lda), st
// (every panel's kNb x kNb T), sw and sw2 (kNb x k each).  Called by every
// thread of the block; ends with the block synchronized.
template <int kQ>
__device__ void householder_factor(float2* sa, int lda, float2* sq, float2* sy, float2* st, float2* sw, float2* sw2,
                                   float2* stau, float2* sdiag, int n, int k, bool want_q) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int panels = (k + kNb - 1) / kNb;
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
  if (!want_q) return;
  // 4. Q = H_0 ... H_{k-1} I[:, :k], panel by panel from the last
  for (int e = tid; e < n * k; e += kThreads) {
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
}

// float2 elements of householder_factor's scratch (sy, st, sw, sw2) and of
// tau and R's diagonal, for lda and k
__host__ __device__ constexpr size_t householder_scratch(int lda, int k) {
  return static_cast<size_t>(kNb) * lda + static_cast<size_t>((k + kNb - 1) / kNb) * kNb * kNb +
         2 * static_cast<size_t>(kNb) * k + 2 * static_cast<size_t>(k);
}

}  // namespace
