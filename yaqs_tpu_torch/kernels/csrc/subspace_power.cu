// Kernels K18 and K19 (subspace_power): the power-scheme subspace split of
// a batch of complex64 blocks m (rows, cols), one launch a split, one thread
// block a matrix, with Householder QRs on the JAX package's noise floor
// (K18) or CholQR on a shifted Gram (K19).
//
// Replaces: yaqs_tpu/ops/decomp.py split_matrix_subspace with
// qr_method="householder" (:228-256, :269-307) and "cholesky" (:239-250).
// With A = m (left_isometric, svd_distribution "right") or A = m^H:
//   y = A omega;  iters times: [y = qr(y)]; y = A (A^H y);  q = qr(y)
// (the bracket where orth_every is set), P = A^H q, and the split
// (left, right) = (q, P^H) or (P, q^H), s = the column norms of P.
//   householder: qr(y) = the thin Q of y + eps_reg ||y||_F nz_j (nz_j the
//     j-th fixed unit-norm real (n, k) matrix, eps_reg = eps32^(3/4)), by
//     K14's blocked compact-WY body (householder.cuh);
//   cholesky: G = y^H y, L L^H = G + eps_reg tr(G) / k I (a pivot that is
//     not positive, NaN included, makes the whole matrix's outputs NaN, as
//     jnp.linalg.cholesky does), qr(y) = y L^{-H} by forward substitution.
// On the paths: analog (32, 128, 128), chi = 64; digital (512, 64, 64),
// chi = 32; the mpo route's zip-up (32, d chi, Dw chi).
//
// What bounds it on the card: FP32 operations (and, at B = 32, the 32
// blocks that use 32 of 132 SMs).  At (128, 128), chi = 64, iters = 2 a
// matrix takes 2 iters + 2 products of 128 x 128 x 64 complex MACs and
// iters + 1 QRs of (128, 64) (about 11 M complex MACs in all).
//
// Design (a simple kernel, right first): m stays in device memory and is
// read through L2 by each product (4 MB at the analog batch); the iterate
// y (n x k, column-major, leading dimension n + 1), its Q (householder),
// A^H y (nc x k) and the QR's scratch live in shared memory: 215 KB at
// (128, 128), chi = 64 (the iterate's n <= 128 rows, m's other side as far
// as shared memory holds it: the zip-up's (64, Dw chi)).  A product is a
// 4 x 4 register tile of outputs a thread, the tile's four rows of m read
// from L2 and its four columns of the iterate from shared memory; the
// Cholesky factor is one column a step with two barriers, and the
// substitution one row of y a thread.

#include <cuda_runtime.h>

#include "householder.cuh"
#include "launch.cuh"

namespace {

constexpr int kMaxRows = 128;   // the iterate's rows n (K14's panel registers)
constexpr int kMaxOther = 1024;  // m's other side nc, within shared memory
constexpr int kMaxChi = 64;

__device__ __forceinline__ float2 conjf2(float2 a) { return make_float2(a.x, -a.y); }

// out[r, c] = sum_l op(m)[r, l] x[l, c] for r < nr, c < k, l < depth, with
// op(m) = m (m row-major (nr, depth)) or, with kAdj, m^H (m row-major
// (depth, nr)); x and out column-major in shared memory (leading dimensions
// ldx, ldo).  Consecutive threads take consecutive column tiles, so a
// warp's m reads fall on few rows.
template <bool kAdj>
__device__ void product(const float2* __restrict__ m, int mcols, const float2* x, int ldx, int depth, float2* out,
                        int ldo, int nr, int k) {
  const int tm = (nr + 3) / 4, tn = (k + 3) / 4;
  for (int t = threadIdx.x; t < tm * tn; t += kThreads) {
    const int it = t / tn, jt = t % tn;
    int ri[4], cj[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ri[u] = min(it + u * tm, nr - 1);
      cj[u] = min(jt + u * tn, k - 1);
    }
    float2 acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = make_float2(0.f, 0.f);
    for (int l = 0; l < depth; ++l) {
      float2 mv[4], xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mv[u] = kAdj ? conjf2(__ldg(m + static_cast<long long>(l) * mcols + ri[u]))
                     : __ldg(m + static_cast<long long>(ri[u]) * mcols + l);
        xv[u] = x[cj[u] * ldx + l];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) cfma(acc[r][c], mv[r], xv[c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (it + r * tm >= nr) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (jt + c * tn < k) out[cj[c] * ldo + ri[r]] = acc[r][c];
    }
  }
  __syncthreads();
}

// sum of v over the block (every thread gets it); red: kWarps floats
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// CholQR of y (n x k in sa, column-major, lda) in place: y <- y L^{-H},
// L L^H = y^H y + eps_reg tr(y^H y) / k I.  g: k x k scratch (row-major).
// A pivot that is not positive makes y NaN.
__device__ void cholesky_q(float2* sa, int lda, int n, int k, float eps_reg, float2* g, float* red, int* bad) {
  yh_times_x(sa, sa, lda, 0, n, k, k, g);  // G = y^H y
  if (threadIdx.x == 0) *bad = 0;
  __syncthreads();
  float tr = 0.f;
  for (int j = threadIdx.x; j < k; j += kThreads) tr += g[j * k + j].x;
  const float shift = eps_reg * block_sum(tr, red) / k;
  for (int j = threadIdx.x; j < k; j += kThreads) g[j * k + j].x += shift;
  __syncthreads();
  // right-looking Cholesky, lower triangle in place
  for (int j = 0; j < k; ++j) {
    const float pivot = g[j * k + j].x;
    const float ljj = sqrtf(pivot);
    if (!(pivot > 0.f) && threadIdx.x == 0) *bad = 1;
    for (int i = j + 1 + threadIdx.x; i < k; i += kThreads) {
      g[i * k + j].x /= ljj;
      g[i * k + j].y /= ljj;
    }
    __syncthreads();
    if (threadIdx.x == 0) g[j * k + j] = make_float2(ljj, 0.f);
    const int rest = k - j - 1;
    for (int e = threadIdx.x; e < rest * rest; e += kThreads) {
      const int i = j + 1 + e / rest, c = j + 1 + e % rest;
      if (c > i) continue;
      const float2 a = g[i * k + j], b = g[c * k + j];  // G[i, c] -= L[i, j] conj(L[c, j])
      g[i * k + c].x -= a.x * b.x + a.y * b.y;
      g[i * k + c].y -= a.y * b.x - a.x * b.y;
    }
    __syncthreads();
  }
  const bool nan = *bad != 0;
  // row i of y: conj(q_i)^T = L^{-1} conj(y_i)^T by forward substitution, in place
  for (int i = threadIdx.x; i < n; i += kThreads) {
    for (int p = 0; p < k; ++p) {
      float2 w = conjf2(sa[p * lda + i]);
      for (int c = 0; c < p; ++c) {
        const float2 l = g[p * k + c], wc = conjf2(sa[c * lda + i]);
        w.x -= l.x * wc.x - l.y * wc.y;
        w.y -= l.x * wc.y + l.y * wc.x;
      }
      const float d = g[p * k + p].x;
      sa[p * lda + i] = nan ? make_float2(__int_as_float(0x7fc00000), __int_as_float(0x7fc00000))
                            : make_float2(w.x / d, -w.y / d);
    }
  }
  __syncthreads();
}

// The split's orthonormalization of y (sa): returns where its Q lies (sq
// for householder, sa in place for cholesky).
template <int kQ>
__device__ float2* orthonormalize(float2* sa, float2* sq, float2* scratch, int lda, int n, int k, bool chol,
                                  float eps_reg, const float* noise, float* red, int* bad) {
  if (chol) {
    cholesky_q(sa, lda, n, k, eps_reg, scratch, red, bad);
    return sa;
  }
  float part = 0.f;
  for (int e = threadIdx.x; e < n * k; e += kThreads) {
    const float2 v = sa[(e % k) * lda + e / k];
    part += v.x * v.x + v.y * v.y;
  }
  const float scale = eps_reg * sqrtf(block_sum(part, red));
  for (int e = threadIdx.x; e < n * k; e += kThreads) sa[(e % k) * lda + e / k].x += scale * __ldg(noise + e);
  __syncthreads();
  float2* sy = scratch;
  float2* st = sy + kNb * lda;
  float2* sw = st + ((k + kNb - 1) / kNb) * kNb * kNb;
  float2* sw2 = sw + kNb * k;
  float2* stau = sw2 + kNb * k;
  householder_factor<kQ>(sa, lda, sq, sy, st, sw, sw2, stau, stau + k, n, k, true);
  return sq;
}

// Shared memory: y (k x lda), its Q (householder), A^H y (k x ldz), the
// scratch (householder's or the k x k Gram), the reduction floats.
__host__ __device__ constexpr size_t smem_bytes(int n, int nc, int k, bool chol) {
  const int lda = n + 1, ldz = nc + 1;
  const size_t scratch = chol ? static_cast<size_t>(k) * k : householder_scratch(lda, k);
  return sizeof(float2) * (static_cast<size_t>(k) * lda * (chol ? 1 : 2) + static_cast<size_t>(k) * ldz + scratch) +
         sizeof(float) * (kWarps + 1);
}

// m: batch row-major (rows, cols) blocks; omega row-major (nc, k) (nc = cols
// with left_isometric, else rows); noise (iters + 1, n, k) real, row-major;
// left (batch, rows, k), right (batch, k, cols), s (batch, k).
template <int kQ>
__global__ void __launch_bounds__(kThreads, 1)
    subspace_power_kernel(const float2* __restrict__ m, const float2* __restrict__ omega,
                          const float* __restrict__ noise, float2* __restrict__ left, float2* __restrict__ right,
                          float* __restrict__ s_out, int rows, int cols, int k, int iters, int orth_every,
                          int left_isometric, int chol, float eps_reg) {
  extern __shared__ float2 smem[];
  const bool liso = left_isometric != 0;
  const int n = liso ? rows : cols, nc = liso ? cols : rows;
  const int lda = n + 1, ldz = nc + 1;
  float2* sa = smem;                       // y: k columns of lda
  float2* sq = sa + k * lda;               // its Q (householder)
  float2* sz = sq + (chol ? 0 : k * lda);  // A^H y: k columns of ldz
  float2* scratch = sz + k * ldz;
  float* red = reinterpret_cast<float*>(scratch + (chol ? static_cast<size_t>(k) * k : householder_scratch(lda, k)));
  int* bad = reinterpret_cast<int*>(red + kWarps);
  const float2* mb = m + static_cast<long long>(blockIdx.x) * rows * cols;
  const int nk = n * k;

  // A x: m x (left_isometric) or m^H x; A^H x the other
  auto apply_a = [&](const float2* x, int ldx, float2* out, int ldo) {
    if (liso) product<false>(mb, cols, x, ldx, cols, out, ldo, rows, k);
    else product<true>(mb, cols, x, ldx, rows, out, ldo, cols, k);
  };
  auto apply_ah = [&](const float2* x, int ldx, float2* out, int ldo) {
    if (liso) product<true>(mb, cols, x, ldx, rows, out, ldo, cols, k);
    else product<false>(mb, cols, x, ldx, cols, out, ldo, rows, k);
  };

  for (int e = threadIdx.x; e < nc * k; e += kThreads) sz[(e % k) * ldz + e / k] = __ldg(omega + e);
  __syncthreads();
  apply_a(sz, ldz, sa, lda);  // y = A omega
  for (int it = 0; it < iters; ++it) {
    const float2* cur = sa;
    if (orth_every) cur = orthonormalize<kQ>(sa, sq, scratch, lda, n, k, chol, eps_reg, noise + it * nk, red, bad);
    apply_ah(cur, lda, sz, ldz);  // z = A^H y
    apply_a(sz, ldz, sa, lda);    // y = A z
  }
  const float2* q = orthonormalize<kQ>(sa, sq, scratch, lda, n, k, chol, eps_reg, noise + iters * nk, red, bad);
  apply_ah(q, lda, sz, ldz);  // P = A^H q

  const long long b = blockIdx.x;
  float2* lo = left + b * rows * k;
  float2* ro = right + b * k * cols;
  // left_isometric: left = q (rows = n), right[c, j] = conj(P[j, c]) (cols = nc);
  // else left = P (rows = nc), right[c, j] = conj(q[j, c]) (cols = n)
  const float2* lsrc = liso ? q : sz;
  const int lld = liso ? lda : ldz;
  for (int e = threadIdx.x; e < rows * k; e += kThreads) lo[e] = lsrc[(e % k) * lld + e / k];
  const float2* rsrc = liso ? sz : q;
  const int rld = liso ? ldz : lda;
  for (int e = threadIdx.x; e < k * cols; e += kThreads) ro[e] = conjf2(rsrc[(e / cols) * rld + e % cols]);
  for (int c = threadIdx.x; c < k; c += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < nc; ++j) {
      const float2 v = sz[c * ldz + j];
      acc = fmaf(v.x, v.x, fmaf(v.y, v.y, acc));
    }
    s_out[b * k + c] = sqrtf(acc);
  }
}

}  // namespace

extern "C" int subspace_power_launch(const void* m, const void* omega, const void* noise, void* left, void* right,
                                     void* s, int batch, int rows, int cols, int chi, int iters, int orth_every,
                                     int left_isometric, int cholesky, float eps_reg, void* stream) {
  const int n = left_isometric ? rows : cols, nc = left_isometric ? cols : rows;
  if (batch <= 0 || n <= 0 || nc <= 0 || n > kMaxRows || nc > kMaxOther || chi <= 0 || chi > kMaxChi || chi > n ||
      iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(n, nc, chi, cholesky != 0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = n <= 64 ? subspace_power_kernel<2> : subspace_power_kernel<4>;
  cudaError_t err = allow_smem(kernel, kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(m), static_cast<const float2*>(omega), static_cast<const float*>(noise),
      static_cast<float2*>(left), static_cast<float2*>(right), static_cast<float*>(s), rows, cols, chi, iters,
      orth_every, left_isometric, cholesky, eps_reg);
  return static_cast<int>(cudaGetLastError());
}
