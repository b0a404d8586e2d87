// The Newton–Schulz polar factor of one complex64 block held in shared
// memory, and the shared-memory products it is built from.  Used by K4
// (ns_polar.cu), K5 (subspace_split.cu) and K6 (ns_canon.cu), so that the
// three run one schedule and cannot drift apart; K7 (moment_scan.cu) runs
// its scans and moments on the same products.
//
// The schedule (yaqs_tpu/ops/decomp.py newton_schulz_orthogonalize) must
// never change: in complex64 an extra lift promotes sub-eps noise directions
// into the basis.
//   1. x /= min(frobenius, sqrt(norm1 * norminf)) + 1e-30
//   2. 4 quintics  x = a x + b x g + c x g g,  g = x^H x, (a,b,c) = (3.4445, -4.7750, 2.0315)
//   3. 2 quintics  with (2, -1.3333, 0.3333)
//   4. 2 cubics    x = 1.5 x - 0.5 x g
// The schedule is written once, in ns_polar_rows below: ns_polar_block (one
// block holds the matrix; K4, K6 and K5's single-block kernel) and K5's
// cluster kernel (the matrix's rows split over a thread block cluster) are
// its two instantiations, and differ only in how a block's partial sums
// (the scale's statistics, the Gram) are combined.
//
// Products are computed by the whole block with a register tile of TM x 4
// complex outputs a thread (tile_product) whose rows are strided by M / TM
// and columns by N / 4, so that for a fixed tile slot consecutive threads
// read consecutive B columns (no bank conflicts) and share A rows
// (broadcast).  Plain FP32 FMAs, no tensor cores: the port runs with TF32
// off, and the tuned schedule was validated at full float32 products.

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
// m^H X and for x g on 128 rows, 4 x 4 for the Gram, 2 x 4 for x g on the
// 43 or 32 rows of a cluster block.  (A 3 x 4 tile for 43 rows, one tile a
// thread, measured slower.)  kMaxTM caps the tile's rows: a kernel whose
// products never take the taller tiles (ns_fits_small_tiles) leaves them
// out, and with them the registers they would hold.
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
// more than 2 rows (for a polar factor the tallest is x g, m x n; for K7's
// scans tmp, chi x d chi), so product<..., 2> computes the same sums in the
// same threads.
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
// kNsMaxRows, n <= kNsMaxCols.
//
// Never inlined: one copy a kernel.  The single-block split calls it six
// times (through ns_polar_block), and six inlined copies of its twelve
// product tiles made subspace_split.cu nearly all of the library's build
// time.
template <int kC, int kMaxTM = 8>
__device__ __noinline__ void ns_polar_rows(float2* x, float2* xg, float2* g, float2* part, int part_stride,
                                           float* scratch, int nl, int n) {
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
  for (int e = tid; e < nl * n; e += blockDim.x) {
    const float2 v = x[e];
    x[e] = make_float2(v.x / bnd, v.y / bnd);
  }
  __syncthreads();

  // 2-4. the schedule's eight steps: x = a x + b x g + c (x g) g, g = x^H x
  // (over the cluster: the Gram partials double-buffered, so that one
  // barrier a step suffices)
  for (int step = 0; step < kNsSteps; ++step) {
    const NsStep st = ns_step(step);
    if constexpr (kC > 1) {
      float2* p = part + (step & 1) * part_stride;
      product<true, kMaxTM>(x, 1, n, x, n, n, n, nl, [&](int i, int j, float2 v) { p[i * n + j] = v; });
      cooperative_groups::this_cluster().sync();
      cluster_sum<kC>(g, p, n * n);
    } else {
      product<true, kMaxTM>(x, 1, n, x, n, n, n, nl, [&](int i, int j, float2 v) { g[i * n + j] = v; });
    }
    __syncthreads();
    product<false, kMaxTM>(x, n, 1, g, n, nl, n, n, [&](int i, int j, float2 v) { xg[i * n + j] = v; });
    __syncthreads();
    if (st.c != 0.f) {
      // each (i, j) of x is read and written by the thread that owns it only
      product<false, kMaxTM>(xg, n, 1, g, n, nl, n, n, [&](int i, int j, float2 v) {
        const float2 xv = x[i * n + j];
        const float2 yv = xg[i * n + j];
        x[i * n + j] = make_float2(st.a * xv.x + st.b * yv.x + st.c * v.x, st.a * xv.y + st.b * yv.y + st.c * v.y);
      });
    } else {
      for (int e = tid; e < nl * n; e += blockDim.x) {
        const float2 xv = x[e];
        const float2 yv = xg[e];
        x[e] = make_float2(st.a * xv.x + st.b * yv.x, st.a * xv.y + st.b * yv.y);
      }
    }
    __syncthreads();
  }
}

// Replace x (m x n, row-major, shared memory), held whole by this block, by
// its polar factor: ns_polar_rows on one block.  xg (m * n) and g (n * n)
// are work buffers, red holds ns_scratch_floats(n) floats.  The caller has
// written x and synchronized the block; on return x holds the result and
// the block is synchronized again.
__device__ __forceinline__ void ns_polar_block(float2* x, float2* xg, float2* g, float* red, int m, int n) {
  ns_polar_rows<1>(x, xg, g, nullptr, 0, red, m, n);
}

}  // namespace
