// The Newton–Schulz polar factor of one complex64 block held in shared
// memory, and the shared-memory products it is built from.  Used by K4
// (ns_polar.cu), K5 (subspace_split.cu) and K6 (ns_canon.cu), so that the
// three run one schedule and cannot drift apart; K7 (moment_scan.cu) runs
// its scans and moments on the same FP32 products.
//
// The schedule (yaqs_tpu/ops/decomp.py newton_schulz_orthogonalize) must
// never change: in complex64 an extra lift promotes sub-eps noise directions
// into the basis.
//   1. x /= min(frobenius, sqrt(norm1 * norminf)) + 1e-30
//   2. 4 quintics  x = a x + b x g + c x g g,  g = x^H x, (a,b,c) = (3.4445, -4.7750, 2.0315)
//   3. 2 quintics  with (2, -1.3333, 0.3333)
//   4. 2 cubics    x = 1.5 x - 0.5 x g
// The schedule is written once, in ns_polar_rows below: ns_polar_block (one
// block holds the matrix; K4 at one block a matrix, K6 and K5's single-block
// kernel) and the cluster kernels of K4, K5 and K6 (the matrix's rows split
// over a thread block cluster) are its instantiations, and differ only in
// how a block's partial sums (the scale's statistics, the Gram) are combined.
//
// The schedule's three products a step (the Gram x^H x, x g and (x g) g)
// run on the tensor cores (tc_product): mma.sync m16n8k8 with TF32 operands
// and FP32 accumulators, each operand split as hi = tf32(a), lo = tf32(a -
// hi) and each real product summed as lo hi + hi lo + hi hi (3xTF32, the
// scheme CUTLASS calls OpMultiplyAddFastF32).  That keeps about 22 of float32's
// 24 bits; a bare TF32 product (about 11) is not used: the schedule was
// validated at full float32 products, and the port runs with TF32 off.  A
// complex product is four real ones.  Every shape takes this path (padded
// rows and columns of a tile are zeros); there is no FP32 rule.  During the
// steps the iterate, x g and g are held with each row's columns permuted
// (ns_swizzle), so that a warp's fragment loads do not conflict on banks.
//
// The other products (K5's with m, K6's absorb and carry, K7's scans) are
// computed by the whole block with a register tile of TM x 4 complex
// outputs a thread (tile_product) whose rows are strided by M / TM and
// columns by N / 4, so that for a fixed tile slot consecutive threads read
// consecutive B columns (no bank conflicts) and share A rows (broadcast).
// Plain FP32 FMAs.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kNsThreads = 256;
constexpr int kNsWarps = kNsThreads / 32;
constexpr int kNsMaxRows = 128;
constexpr int kNsMaxCols = 64;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float2 conj2(float2 a) { return make_float2(a.x, -a.y); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Step `step` of the schedule's polynomial part: x = a x + b x g + c (x g) g
// with g = x^H x; c = 0 marks a cubic step, whose (x g) g is not formed.
struct NsStep {
  float a, b, c;
};
constexpr int kNsSteps = 8;

__host__ __device__ constexpr NsStep ns_step(int step) {
  return step < 4 ? NsStep{3.4445f, -4.7750f, 2.0315f}
                  : (step < 6 ? NsStep{2.0f, -1.3333f, 0.3333f} : NsStep{1.5f, -0.5f, 0.0f});
}

// C(i, j) = sum_k A(i, k) B(k, j) for i < M, j < N and k = (k1, k2), k1 <
// K1, k2 < K2, with A(i, k) = a[aoff(i) + k1 a1 + k2 a2] (conjugated when
// CONJ_A) and B(k, j) = b[boff(j) + k1 b1 + k2 b2] (shared or device
// memory).  Each thread takes a TM x 4 tile; its row and column offsets are
// computed once, clamped into range, and the k loop walks two pointers.
// Each output goes to epi(i, j, value) from the thread that computed it; the
// mapping of outputs to threads depends on (M, N) only, so two calls with
// the same (M, N) hand each (i, j) to the same thread.  Every output is
// summed over k in order, whatever TM.
template <int TM, bool CONJ_A, typename AO, typename BO, typename Epi>
__device__ __forceinline__ void tile_product(const float2* a, AO aoff, int a1, int a2, const float2* b, BO boff,
                                             int b1, int b2, int M, int N, int K1, int K2, Epi epi) {
  constexpr int TN = 4;
  const int tm = (M + TM - 1) / TM;
  const int tn = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int it = t / tn;
    const int jt = t % tn;
    int ao[TM], bo[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) ao[r] = aoff(min(it + r * tm, M - 1));
#pragma unroll
    for (int c = 0; c < TN; ++c) bo[c] = boff(min(jt + c * tn, N - 1));
    float2 acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = make_float2(0.f, 0.f);
    for (int k1 = 0; k1 < K1; ++k1) {
      const float2* ak = a + k1 * a1;
      const float2* bk = b + k1 * b1;
#pragma unroll 4
      for (int k2 = 0; k2 < K2; ++k2) {
        float2 av[TM], bv[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) av[r] = CONJ_A ? conj2(ak[ao[r]]) : ak[ao[r]];
#pragma unroll
        for (int c = 0; c < TN; ++c) bv[c] = bk[bo[c]];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) cfma(acc[r][c], av[r], bv[c]);
        ak += a2;
        bk += b2;
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = it + r * tm;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int j = jt + c * tn;
        if (i < M && j < N) epi(i, j, acc[r][c]);
      }
    }
  }
}

// tile_product with the largest tile of 8, 4 or 2 rows that still gives
// every thread of the block a tile: at (128, 128), chi = 64, 8 x 4 for
// K5's m X and m^H X on 128 rows, 2 x 4 on the 43 or 32 rows of a cluster
// block.  (A 3 x 4 tile for 43 rows, one tile a thread, measured slower.)
// kMaxTM caps the tile's rows: a kernel whose products never take the
// taller tiles (ns_fits_small_tiles) leaves them out, and with them the
// registers they would hold.
template <bool CONJ_A, int kMaxTM = 8, typename AO, typename BO, typename Epi>
__device__ __forceinline__ void product(const float2* a, AO aoff, int a1, int a2, const float2* b, BO boff, int b1,
                                        int b2, int M, int N, int K1, int K2, Epi epi) {
  const int tn = (N + 3) / 4;
  if (kMaxTM >= 8 && (M + 7) / 8 * tn >= kNsThreads) {
    tile_product<(kMaxTM >= 8 ? 8 : 2), CONJ_A>(a, aoff, a1, a2, b, boff, b1, b2, M, N, K1, K2, epi);
  } else if (kMaxTM >= 4 && (M + 3) / 4 * tn >= kNsThreads) {
    tile_product<(kMaxTM >= 4 ? 4 : 2), CONJ_A>(a, aoff, a1, a2, b, boff, b1, b2, M, N, K1, K2, epi);
  } else {
    tile_product<2, CONJ_A>(a, aoff, a1, a2, b, boff, b1, b2, M, N, K1, K2, epi);
  }
}

// The same over one k < K, with A(i, k) = a[i asi + k ask] and B(k, j) =
// b[k ldb + j].  A = X^H of a row-major (K, M) matrix x is product<true>(x,
// 1, M, ...); a row-major (M, K) matrix a is product<false>(a, K, 1, ...).
template <bool CONJ_A, int kMaxTM = 8, typename Epi>
__device__ __forceinline__ void product(const float2* a, int asi, int ask, const float2* b, int ldb, int M, int N,
                                        int K, Epi epi) {
  product<CONJ_A, kMaxTM>(
      a, [asi](int i) { return i * asi; }, 0, ask, b, [](int j) { return j; }, 0, ldb, M, N, 1, K, epi);
}

// True when no product of M x N outputs for M, N <= (m, n) takes a tile of
// more than 2 rows (for K5's products with m the tallest is m X, rows x
// chi; for K6's absorb, d chi x chi; for K7's scans tmp, chi x d chi), so
// product<..., 2> computes the same sums in the same threads.  The kernels
// built with those tiles for four blocks an SM take the polar factor's
// smallest tensor-core tile too (ns_polar_rows).
__host__ __device__ constexpr bool ns_fits_small_tiles(int m, int n) {
  return (m + 3) / 4 * ((n + 3) / 4) < kNsThreads;
}

// Block k's copy of a shared-memory pointer in a cluster of kC blocks
// (kC = 1: the block's own).
template <int kC, typename T>
__device__ __forceinline__ T* rank_ptr(T* p, int k) {
  if constexpr (kC > 1) {
    return cooperative_groups::this_cluster().map_shared_rank(p, k);
  } else {
    return p;
  }
}

// Synchronize the cluster (kC > 1) or the block.
template <int kC>
__device__ __forceinline__ void cluster_or_block_sync() {
  if constexpr (kC > 1) {
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// dst[e] = the sum over the cluster's blocks, in rank order, of src[e] in
// each block's shared memory (e < n): every block that sums the same
// elements gets the same bits.  src must not change until the cluster has
// synchronized after this call.
template <int kC>
__device__ __forceinline__ void cluster_sum(float2* dst, float2* src, int n) {
  const float2* part[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) part[k] = rank_ptr<kC>(src, k);
  constexpr int kU = 4;  // elements in flight a thread
  for (int e0 = threadIdx.x; e0 < n; e0 += kU * blockDim.x) {
    float2 v[kU][kC];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = min(e0 + u * static_cast<int>(blockDim.x), n - 1);
#pragma unroll
      for (int k = 0; k < kC; ++k) v[u][k] = part[k][e];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * static_cast<int>(blockDim.x);
      float2 acc = v[u][0];
#pragma unroll
      for (int k = 1; k < kC; ++k) acc = make_float2(acc.x + v[u][k].x, acc.y + v[u][k].y);
      if (e < n) dst[e] = acc;
    }
  }
}

// Floats of shared-memory scratch that ns_polar_rows needs for n columns:
// the scale's statistics (2 n + 1, read by the cluster's other blocks) and
// a block reduction (kNsWarps + 1).
__host__ __device__ constexpr int ns_scratch_floats(int n) { return 2 * n + 1 + kNsWarps + 1; }

// ---- the tensor-core products of the schedule (3xTF32) ----

// The mma.sync tile: m16n8k8, TF32 operands, FP32 accumulators.
constexpr int kTcM = 16;
constexpr int kTcN = 8;
constexpr int kTcK = 8;

// The column permutation of row r of an n-column matrix while the schedule
// runs: column c is held at c ^ ns_swizzle(r, n).  Where n is a multiple of
// 16 it spreads the four rows that one fragment load reads over all 32
// banks; otherwise it is the identity.
__host__ __device__ constexpr int ns_swizzle(int r, int n) { return n % 16 == 0 ? (r & 3) << 2 : 0; }

// TF32 of v, rounded to nearest with ties away from zero (cvt.rna), as the
// bits of a float32.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 22 bits: hi = tf32(v), lo = tf32(v - hi) (v - hi is
// exact in float32).  lo is rounded as cvt.rna rounds a finite value, in two
// integer instructions (add half a TF32 ulp to the magnitude, clear the 13
// low bits); cvt.rna's test for infinities and NaN is left to hi, which
// carries them.
__device__ __forceinline__ void tf32_split(float v, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(v);
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// c += a b for one m16n8k8 tile (a: rows g, g + 8 by columns t, t + 4; b:
// rows t, t + 4 of column g; c: row g, g + 8 by columns 2 t, 2 t + 1; g =
// lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 3xTF32 terms of one real product, small first: (lo, hi), (hi, lo),
// (hi, hi).
constexpr int kTcTerms = 3;

// A thread's share of a complex A fragment (16 x 8): the real and the
// imaginary parts of its four elements, each split.
struct TcA {
  unsigned rh[4], rl[4], ih[4], il[4];
};

// A thread's share of a complex B fragment (8 x 8): real and imaginary
// parts of its two elements and the negation of one of them, each split.
struct TcB {
  unsigned rh[2], rl[2], ih[2], il[2], nh[2], nl[2];
};

// Element (r, c) of a row-major matrix of ld columns held permuted by
// ns_swizzle, or 0 when !valid.
__device__ __forceinline__ float2 tc_load(const float2* p, int r, int c, int ld, bool valid) {
  return valid ? p[r * ld + (c ^ ns_swizzle(r, ld))] : make_float2(0.f, 0.f);
}

// C (M x N) = A (M x K) B (K x N) on the tensor cores, every output to
// epi(i, j, value) from the thread that holds it.  A(i, k) = a[k][i],
// conjugated with CONJ_A; B(k, j) = b[k][j], or b[j][k] with TRANS_B; a and
// b are row-major with ld columns, held permuted by ns_swizzle.  (The Gram
// x^H x is A = conj(x)^T, B = x; the products x g are formed as their
// transposes g^T x^T, A = g^T, B = x^T, so that a warp's tile holds more
// of the n = 64 columns and fewer of the block's 43 rows, and loads fewer
// elements a k chunk.)  A warp computes a tile of WM x WN mma tiles at a
// time, the block's warps taking the tiles in turn; rows, columns and k
// beyond M, N and K load as zeros.
//
// The order of sums (tests/test_torch_ns_tf32x3_algorithm.py models it):
// for each chunk of kTcK in k, each output's real part starts a fresh mma
// accumulator t = 0 and adds to it, in this order, A_re B_re and then A_im
// (-B_im) (A_im B_im with CONJ_A, A_im being the stored element's imaginary
// part), each real product as its kTcTerms 3xTF32 terms; the imaginary part
// A_re B_im, then A_im B_re (A_im (-B_re) with CONJ_A).  The FP32 sum then
// adds t, rounding to nearest.  The fresh accumulator keeps the tensor
// cores' own rounding inside an mma to a chunk's terms: one sum carried
// through every mma put the site moments of a random chain (K6's card test)
// at twice their limit.  Issue order walks the six (product, term) stages
// over all of a warp's tiles, so that consecutive mmas never depend on each
// other; with kPipelined the next chunk's elements are loaded while this
// one multiplies.
template <bool CONJ_A, bool TRANS_B, int WM, int WN, bool kPipelined, typename Epi>
__device__ __forceinline__ void tc_tiles(const float2* a, const float2* b, int ld, int M, int N, int K, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int tm = (M + WM * kTcM - 1) / (WM * kTcM), tn = (N + WN * kTcN - 1) / (WN * kTcN);
  for (int wt = warp; wt < tm * tn; wt += kNsWarps) {
    const int i0 = wt / tn * WM * kTcM, j0 = wt % tn * WN * kTcN;
    float2 ea[WM][4], eb[WN][2];  // a chunk's elements, in fragment order
    auto load = [&](int k0) {
#pragma unroll
      for (int c = 0; c < WN; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = j0 + c * kTcN + gq, k = k0 + tq + 4 * h;
          const bool ok = k < K && j < N;
          eb[c][h] = TRANS_B ? tc_load(b, j, k, ld, ok) : tc_load(b, k, j, ld, ok);
        }
#pragma unroll
      for (int r = 0; r < WM; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + r * kTcM + gq + 8 * (q & 1), k = k0 + tq + 4 * (q >> 1);
          ea[r][q] = tc_load(a, k, i, ld, k < K && i < M);
        }
    };
    float cr[WM][WN][4], ci[WM][WN][4];
#pragma unroll
    for (int r = 0; r < WM; ++r)
#pragma unroll
      for (int c = 0; c < WN; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) cr[r][c][q] = ci[r][c][q] = 0.f;
    if (kPipelined) load(0);
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += kTcK) {
      if (!kPipelined) load(k0);
      TcA fa[WM];
      TcB fb[WN];
#pragma unroll
      for (int c = 0; c < WN; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tf32_split(eb[c][h].x, fb[c].rh[h], fb[c].rl[h]);
          tf32_split(eb[c][h].y, fb[c].ih[h], fb[c].il[h]);
          // negation is exact on the split: -Im B, or -Re B with CONJ_A
          fb[c].nh[h] = (CONJ_A ? fb[c].rh[h] : fb[c].ih[h]) ^ 0x80000000u;
          fb[c].nl[h] = (CONJ_A ? fb[c].rl[h] : fb[c].il[h]) ^ 0x80000000u;
        }
#pragma unroll
      for (int r = 0; r < WM; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          tf32_split(ea[r][q].x, fa[r].rh[q], fa[r].rl[q]);
          tf32_split(ea[r][q].y, fa[r].ih[q], fa[r].il[q]);
        }
      if (kPipelined && k0 + kTcK < K) load(k0 + kTcK);
      float tr[WM][WN][4], ti[WM][WN][4];
#pragma unroll
      for (int r = 0; r < WM; ++r)
#pragma unroll
        for (int c = 0; c < WN; ++c)
#pragma unroll
          for (int q = 0; q < 4; ++q) tr[r][c][q] = ti[r][c][q] = 0.f;
      // stage = (product against A_re, then A_im) x (term)
#pragma unroll
      for (int stage = 0; stage < 2 * kTcTerms; ++stage) {
        const int term = stage % kTcTerms;
        const bool im = stage >= kTcTerms;
#pragma unroll
        for (int r = 0; r < WM; ++r)
#pragma unroll
          for (int c = 0; c < WN; ++c) {
            const TcA& x = fa[r];
            const TcB& y = fb[c];
            // real part: A_re B_re, then A_im (-B_im) (A_im B_im with CONJ_A);
            // imaginary part: A_re B_im, then A_im B_re (A_im (-B_re) with CONJ_A)
            const unsigned(&ah)[4] = im ? x.ih : x.rh;
            const unsigned(&al)[4] = im ? x.il : x.rl;
            const unsigned(&rh)[2] = !im ? y.rh : (CONJ_A ? y.ih : y.nh);
            const unsigned(&rl)[2] = !im ? y.rl : (CONJ_A ? y.il : y.nl);
            const unsigned(&ih)[2] = !im ? y.ih : (CONJ_A ? y.nh : y.rh);
            const unsigned(&il)[2] = !im ? y.il : (CONJ_A ? y.nl : y.rl);
            if (term == 0) {
              mma_tf32(tr[r][c], al, rh);
              mma_tf32(ti[r][c], al, ih);
            } else if (term == 1) {
              mma_tf32(tr[r][c], ah, rl);
              mma_tf32(ti[r][c], ah, il);
            } else {
              mma_tf32(tr[r][c], ah, rh);
              mma_tf32(ti[r][c], ah, ih);
            }
          }
      }
#pragma unroll
      for (int r = 0; r < WM; ++r)
#pragma unroll
        for (int c = 0; c < WN; ++c)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cr[r][c][q] += tr[r][c][q];
            ci[r][c][q] += ti[r][c][q];
          }
    }
#pragma unroll
    for (int r = 0; r < WM; ++r)
#pragma unroll
      for (int c = 0; c < WN; ++c)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + r * kTcM + gq + 8 * (q >> 1), j = j0 + c * kTcN + 2 * tq + (q & 1);
          if (i < M && j < N) epi(i, j, make_float2(cr[r][c][q], ci[r][c][q]));
        }
  }
}

// Mma tiles that the busiest warp computes for an M x N output at a warp
// tile of wm x wn mma tiles.
__host__ __device__ constexpr int tc_busiest(int M, int N, int wm, int wn) {
  return (((M + wm * kTcM - 1) / (wm * kTcM)) * ((N + wn * kTcN - 1) / (wn * kTcN)) + kNsWarps - 1) / kNsWarps *
         wm * wn;
}

// tc_tiles at the warp tile that leaves the busiest warp the fewest mma
// tiles, the larger tile on a tie (fewer fragment loads): of 2 x 2 and 1 x 1
// for the Gram (CONJ_A; n x n), of 2 x 2, 1 x 3, 1 x 2 and 1 x 1 for the
// transposed x g and (x g) g (TRANS_B; n x nl).  At n = 64 the Gram takes
// 2 x 2; x g takes 1 x 3 on the 43 or 42 rows of a block of three, 1 x 2
// on 32 rows, 2 x 2 on 64 or 128; at n = 32 the Gram takes 1 x 1 and x g on
// 64 rows 1 x 2.  kSmall (a kernel built for four blocks an SM, 64
// registers a thread) takes 1 x 1 only, unpipelined (its four blocks an SM
// hide the loads).
template <bool CONJ_A, bool TRANS_B, bool kSmall, typename Epi>
__device__ __forceinline__ void tc_product(const float2* a, const float2* b, int ld, int M, int N, int K, Epi epi) {
  if constexpr (kSmall) {
    tc_tiles<CONJ_A, TRANS_B, 1, 1, false>(a, b, ld, M, N, K, epi);
  } else {
    const int c22 = tc_busiest(M, N, 2, 2), c11 = tc_busiest(M, N, 1, 1);
    if constexpr (!TRANS_B) {
      if (c22 <= c11) {
        tc_tiles<CONJ_A, TRANS_B, 2, 2, true>(a, b, ld, M, N, K, epi);
      } else {
        tc_tiles<CONJ_A, TRANS_B, 1, 1, true>(a, b, ld, M, N, K, epi);
      }
    } else {
      const int c13 = tc_busiest(M, N, 1, 3), c12 = tc_busiest(M, N, 1, 2);
      if (c22 <= c13 && c22 <= c12 && c22 <= c11) {
        tc_tiles<CONJ_A, TRANS_B, 2, 2, true>(a, b, ld, M, N, K, epi);
      } else if (c13 <= c12 && c13 <= c11) {
        tc_tiles<CONJ_A, TRANS_B, 1, 3, true>(a, b, ld, M, N, K, epi);
      } else if (c12 <= c11) {
        tc_tiles<CONJ_A, TRANS_B, 1, 2, true>(a, b, ld, M, N, K, epi);
      } else {
        tc_tiles<CONJ_A, TRANS_B, 1, 1, true>(a, b, ld, M, N, K, epi);
      }
    }
  }
}

// Replace x (nl x n, row-major, shared memory) by its rows of the polar
// factor of a matrix whose rows are split over a cluster of kC blocks, each
// holding nl of them (kC = 1: one block holds the whole matrix).  xg (nl *
// n) and g (n * n) are work buffers; scratch holds ns_scratch_floats(n)
// floats, and may share g's memory (scratch serves the scale only, g the
// steps after the scale's barriers); with kC > 1, part holds two n x n Gram partials part_stride
// elements apart, which the other blocks read.  Every block of the cluster
// calls it with x written and the block synchronized; it returns with the
// block (not the cluster) synchronized.  The partial sums of each block are
// combined in rank order (cluster_sum, rank_ptr), so all blocks scale and
// step alike; one cluster barrier for the scale and one a step.  nl <=
// kNsMaxRows, n <= kNsMaxCols.  While the steps run, the iterate lives in
// xg's memory and x g in x's, both (and g and the Gram partials) with each
// row's columns permuted by ns_swizzle; the last pass writes the result
// back to x in order.  kMaxTM <= 2 marks a kernel built for four blocks an
// SM: its products take the smallest warp tile.
//
// Never inlined: one copy a kernel.  The single-block split calls it six
// times (through ns_polar_block), and six inlined copies of its products
// made subspace_split.cu nearly all of the library's build time.
template <int kC, int kMaxTM = 8>
__device__ __noinline__ void ns_polar_rows(float2* x, float2* xg, float2* g, float2* part, int part_stride,
                                           float* scratch, int nl, int n) {
  constexpr bool kSmall = kMaxTM <= 2;
  float* stat = scratch;             // column abs sums (n), column squares (n), largest row abs sum
  float* red = scratch + 2 * n + 1;  // kNsWarps + 1
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // 1. scale by min(frobenius, sqrt(norm1 * norminf)) + 1e-30, a guaranteed
  // upper bound on sigma_max of the whole matrix
  for (int j = tid; j < n; j += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int i = 0; i < nl; ++i) {
      const float2 v = x[i * n + j];
      const float av = hypotf(v.x, v.y);
      s += av;
      q = fmaf(av, av, q);
    }
    stat[j] = s;
    stat[n + j] = q;
  }
  float rmax = 0.f;
  for (int i = warp; i < nl; i += kNsWarps) {
    float s = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float2 v = x[i * n + j];
      s += hypotf(v.x, v.y);
    }
    rmax = fmaxf(rmax, warp_sum(s));
  }
  if (lane == 0) red[warp] = rmax;
  __syncthreads();
  if (tid == 0) {
    float r = 0.f;
    for (int w = 0; w < kNsWarps; ++w) r = fmaxf(r, red[w]);
    stat[2 * n] = r;
  }
  cluster_or_block_sync<kC>();
  if (warp == 0) {
    float norm1 = 0.f, sq = 0.f;
    for (int j = lane; j < n; j += 32) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const float* pk = rank_ptr<kC>(stat, k);
        s += pk[j];
        q += pk[n + j];
      }
      norm1 = fmaxf(norm1, s);
      sq += q;
    }
    norm1 = warp_max(norm1);
    sq = warp_sum(sq);
    if (lane == 0) {
      float norminf = 0.f;
#pragma unroll
      for (int k = 0; k < kC; ++k) norminf = fmaxf(norminf, rank_ptr<kC>(stat, k)[2 * n]);
      red[kNsWarps] = fminf(sqrtf(sq), sqrtf(norm1 * norminf)) + 1e-30f;
    }
  }
  __syncthreads();
  const float bnd = red[kNsWarps];
  float2* xp = xg;   // the iterate, permuted
  float2* xgp = x;   // x g, permuted
  for (int e = tid; e < nl * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    const float2 v = x[e];
    xp[i * n + (j ^ ns_swizzle(i, n))] = make_float2(v.x / bnd, v.y / bnd);
  }
  __syncthreads();

  // 2-4. the schedule's eight steps: x = a x + b x g + c (x g) g, g = x^H x
  // (over the cluster: the Gram partials double-buffered, so that one
  // barrier a step suffices)
  for (int step = 0; step < kNsSteps; ++step) {
    const NsStep st = ns_step(step);
    float2* gram = g;
    if constexpr (kC > 1) gram = part + (step & 1) * part_stride;
    tc_product<true, false, kSmall>(xp, xp, n, n, n, nl,
                                    [&](int i, int j, float2 v) { gram[i * n + (j ^ ns_swizzle(i, n))] = v; });
    if constexpr (kC > 1) {
      cooperative_groups::this_cluster().sync();
      cluster_sum<kC>(g, gram, n * n);
    }
    __syncthreads();
    // (x g)^T = g^T x^T: output (i, j) is x g's (j, i)
    tc_product<false, true, kSmall>(g, xp, n, n, nl, n,
                                    [&](int i, int j, float2 v) { xgp[j * n + (i ^ ns_swizzle(j, n))] = v; });
    __syncthreads();
    if (st.c != 0.f) {
      // each (i, j) of the iterate is read and written by the thread that owns it only
      tc_product<false, true, kSmall>(g, xgp, n, n, nl, n, [&](int i, int j, float2 v) {
        const int e = j * n + (i ^ ns_swizzle(j, n));
        const float2 xv = xp[e];
        const float2 yv = xgp[e];
        xp[e] = make_float2(st.a * xv.x + st.b * yv.x + st.c * v.x, st.a * xv.y + st.b * yv.y + st.c * v.y);
      });
    } else {
      for (int e = tid; e < nl * n; e += blockDim.x) {
        const float2 xv = xp[e];
        const float2 yv = xgp[e];
        xp[e] = make_float2(st.a * xv.x + st.b * yv.x, st.a * xv.y + st.b * yv.y);
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < nl * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    x[e] = xp[i * n + (j ^ ns_swizzle(i, n))];
  }
  __syncthreads();
}

// Replace x (m x n, row-major, shared memory), held whole by this block, by
// its polar factor: ns_polar_rows on one block (kMaxTM as there).  xg (m *
// n) and g (n * n) are work buffers, red holds ns_scratch_floats(n) floats.  The caller has
// written x and synchronized the block; on return x holds the result and
// the block is synchronized again.
template <int kMaxTM = 8>
__device__ __forceinline__ void ns_polar_block(float2* x, float2* xg, float2* g, float* red, int m, int n) {
  ns_polar_rows<1, kMaxTM>(x, xg, g, nullptr, 0, red, m, n);
}

}  // namespace
