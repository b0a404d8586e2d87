// The merged-MPO effective Hamiltonian of TDVP on one tile of output rows:
// the matvec body of kernels K1, K2 and K16, shared by the single-matvec
// kernels (heff.cu) and the one-launch Lanczos solves (lanczos_solve.cu).
//
// Per trajectory, with c, x running over the P physical combinations of the
// block (P = 4 for the two-site block theta, P = 2 for one site, P = 1 for
// a bond matrix):
//   X[a, (w, c), q] = sum_p f[a, w, p] v[c, p, q]
//   Y[a, q, (x, u)] = sum_(w, c) X[a, (w, c), q] W[(w, c), (x, u)]
//   out[x, a, b]    = sum_(q, u) Y[a, q, (x, u)] g[b, u, q]
// The bond's zero-site H_eff (heff0, yaqs_tpu/methods/tdvp.py heff_bond)
// has no W: Y is X, and phase (2) below is skipped, so
//   out[a, b] = sum_(w, p, q) f[a, w, p] c[p, q] g[b, w, q],
// 2 Dw chi^3 complex MACs a trajectory.
// A tile is TA rows a (tile_rows: 16, 16, 11, 8, 6, 5 for Dw = 1..6); the
// tile's output rows are (a, x), NR = TA * P of them, each of chi columns b.
//
// What bounds it on the card: FP32 operations (2 P Dw chi^3 + (P Dw)^2
// chi^2 complex MACs a trajectory), and inside the SM the rate of the
// shared-memory loads that feed them.  The tiles are chosen for that:
//  (1) a thread owns a column (c, q) of v and the tile's TA * Dw rows of X
//      (or half of them, where P chi <= 128 would leave threads idle) and
//      reads f's rows as 16-byte pairs along p: one shared load feeds two
//      complex FMAs (two p for one row; one before), the next pair of v
//      loaded while this one is used;
//  (2) Y = X W in place, each thread owning a column (a, q) of X, W read as
//      16-byte pairs of columns;
//  (3) g streams through shared memory in chunks of QC columns q, stored in
//      pairs of columns b with one padding pair between them so that the
//      16-byte loads of neighbouring threads fall on distinct banks; each
//      thread owns RG = ceil(NR / 8) rows (a, x) times two columns b and
//      reads Y and g as 16-byte pairs along q, so 2 + RG shared loads feed
//      4 RG complex FMAs (8 rows, one column and 9 loads before).
// The phase-3 sums stay in registers: the single-matvec kernel writes them
// out, the Lanczos solve runs its recurrence on them.  d = 2, chi <= 64,
// Dw <= 6; odd chi runs on an even padded width (chs) with zero pads.

#pragma once

#include <cuda_runtime.h>

namespace heff {

constexpr int kThreads = 256;
constexpr int kMaxChi = 64;
constexpr int kMaxDw = 6;

__host__ __device__ constexpr int even(int n) { return n + (n & 1); }

// Rows a of a tile: as many as keep phase 1's TA * Dw sums within 33
// register pairs, at most 16 (the Lanczos solve's clusters are then 4, 4,
// 6, 8, 11 and 13 blocks at chi = 64 for Dw = 1..6: 6 blocks hold a
// trajectory on 3 SMs, so an H100 holds the analog batch of 32 at once).
__host__ __device__ constexpr int tile_rows(int dw) { return 33 / dw < 16 ? 33 / dw : 16; }

template <int P, int DW>
struct Tile {
  static constexpr int TA = tile_rows(DW);            // rows a of a tile
  static constexpr int R = DW * P;                    // rows of W
  static constexpr int NR = TA * P;                   // output rows (a, x) of a tile
  static constexpr int RG = (NR + 7) / 8;             // of them a thread in phase 3
  static constexpr int GROUPS = (NR + RG - 1) / RG;   // threads a column pair in phase 3, <= 8
  static constexpr int QC = DW <= 3 ? 16 : 8;         // columns q of g a chunk
  static constexpr int RT = TA * DW;                  // rows (a, w) of f a tile
  static constexpr int RT2 = even(RT);                // ... padded to an even count (a zero row)

  // shared memory of one tile's matvec, in float2, at padded width chs
  __host__ __device__ static constexpr int f_elems(int chs) { return RT2 * chs; }
  // none for the zero-site H_eff: an odd Dw^2 would leave the next arrays off their 16-byte alignment
  __host__ __device__ static constexpr int w_elems() { return P == 1 ? 0 : R * R; }
  __host__ __device__ static constexpr int xy_elems(int chs) { return TA * R * chs; }
  __host__ __device__ static constexpr int g_elems(int chs) { return (chs / 2) * (2 * DW * QC + 2); }
};

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// Where a trajectory's input block v[c, p, q] lies: c = (c0, c1) for P = 4
// (c1 unused for P = 2), element offset c0 sc0 + c1 sc1 + p sp + q sq.  A
// merged two-site block comes out of its product permuted, and a site of
// the MPS lies inside the whole chain: both are read in place.
struct VLayout {
  long long sc0, sc1, sp, sq;

  template <int P>
  __host__ __device__ static VLayout contiguous(int chi) {
    const long long cc = static_cast<long long>(chi) * chi;
    return P == 4 ? VLayout{2 * cc, cc, chi, 1} : VLayout{cc, 0, chi, 1};
  }
  template <int P>
  __device__ __forceinline__ long long offset(int c, int p, int q) const {
    const int c0 = P == 4 ? c / 2 : c, c1 = P == 4 ? c % 2 : 0;
    return c0 * sc0 + c1 * sc1 + p * sp + q * sq;
  }
};

__device__ __forceinline__ float2 lo(float4 v) { return make_float2(v.x, v.y); }
__device__ __forceinline__ float2 hi(float4 v) { return make_float2(v.z, v.w); }

// Stages a tile's rows of f, fs[(ta * DW + w) * chs + p] = f[a0 + ta, w, p],
// zero beyond chi and in the padding row.
template <int P, int DW>
__device__ __forceinline__ void stage_f(float2* fs, const float2* fz, int a0, int chi, int chs) {
  using T = Tile<P, DW>;
  for (int e = threadIdx.x; e < T::RT2 * chs; e += kThreads) {
    const int p = e % chs, row = e / chs;
    const int a = a0 + row / DW, w = row % DW;
    fs[e] = row < T::RT && a < chi && p < chi ? fz[(static_cast<size_t>(a) * DW + w) * chi + p]
                                              : make_float2(0.f, 0.f);
  }
}

// X rows [r0, r0 + NRW) of column (c, q), the source scaled by `scale` (0:
// a zero source, whatever it holds).  The source may have been written by
// other blocks of the cluster in this launch: read through L2 (ld.global.cg).
template <int P, int DW, int NRW>
__device__ __forceinline__ void phase1_column(const float2* fs, float2* xy, const float2* vz, VLayout vl, float scale,
                                              int chi, int chs, int r0, int col) {
  using T = Tile<P, DW>;
  const int c = col / chi, q = col % chi;
  float2 acc[NRW];
#pragma unroll
  for (int r = 0; r < NRW; ++r) acc[r] = make_float2(0.f, 0.f);
  if (scale != 0.f) {
    // the next pair of v is loaded while this one is used: phase 1 waits on
    // L2 otherwise, with two blocks (16 warps) an SM
    const float2* vc = vz + vl.offset<P>(c, 0, q);
    const float2 zero = make_float2(0.f, 0.f);
    float2 n0 = __ldcg(vc);
    float2 n1 = chi > 1 ? __ldcg(vc + vl.sp) : zero;
    for (int p = 0; p < chi; p += 2) {
      float2 v0 = make_float2(n0.x * scale, n0.y * scale);
      float2 v1 = make_float2(n1.x * scale, n1.y * scale);
      n0 = p + 2 < chi ? __ldcg(vc + (p + 2) * vl.sp) : zero;
      n1 = p + 3 < chi ? __ldcg(vc + (p + 3) * vl.sp) : zero;
#pragma unroll
      for (int r = 0; r < NRW; ++r) {
        const float4 fp = *reinterpret_cast<const float4*>(fs + (r0 + r) * chs + p);
        cfma(acc[r], lo(fp), v0);
        cfma(acc[r], hi(fp), v1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NRW; ++r) {
    const int row = r0 + r, ta = row / DW, wl = row % DW;
    if (row < T::RT) xy[(ta * T::R + wl * P + c) * chs + q] = acc[r];
  }
}

// One tile's matvec of v = vz * scale (laid out as vl): acc[i][s] =
// out[x, a, b] for the thread's rows row = rg * RG + i = (ta, x) and columns
// b = 2 bp + s (bp = tid % (chs / 2), rg = tid / (chs / 2)); threads with
// rg >= GROUPS own nothing and hold 0, and rows past NR hold what the last
// row holds.
// fs holds the tile's rows of f, ws W; xy and gs are the tile's work space.
// Ends with a block barrier: the next matvec may reuse xy and gs.
template <int P, int DW>
__device__ __forceinline__ void matvec_tile(const float2* fs, const float2* ws, float2* xy, float2* gs,
                                            const float2* vz, VLayout vl, float scale, const float2* gz, int chi,
                                            int chs, float2 (&acc)[Tile<P, DW>::RG][2]) {
  using T = Tile<P, DW>;
  constexpr int R = T::R, RG = T::RG, QC = T::QC;
  const int tid = threadIdx.x;

  // (1) X = f v
  const int ncol = P * chi;
  if (2 * ncol <= kThreads) {
    if (tid < 2 * ncol) {
      phase1_column<P, DW, T::RT2 / 2>(fs, xy, vz, vl, scale, chi, chs, tid / ncol * (T::RT2 / 2), tid % ncol);
    }
  } else {
    for (int col = tid; col < ncol; col += kThreads) {
      phase1_column<P, DW, T::RT>(fs, xy, vz, vl, scale, chi, chs, 0, col);
    }
  }
  __syncthreads();

  if constexpr (P == 1) {
    // heff0: no W, Y is X; only the padding column q = chi is zeroed
    if (chs > chi) {
      for (int e = tid; e < T::TA * R; e += kThreads) xy[e * chs + chi] = make_float2(0.f, 0.f);
    }
  } else {
    // (2) Y = X W in place, a thread a column (ta, q); the padding column q = chi is zero
    for (int e = tid; e < T::TA * chs; e += kThreads) {
      const int ta = e / chs, q = e % chs;
      float2* col = xy + ta * R * chs + q;
      if (q >= chi) {
#pragma unroll
        for (int r = 0; r < R; ++r) col[r * chs] = make_float2(0.f, 0.f);
        continue;
      }
      float2 xin[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xin[r] = col[r * chs];
#pragma unroll
      for (int o = 0; o < R; o += 2) {
        float2 y0 = make_float2(0.f, 0.f), y1 = make_float2(0.f, 0.f);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 wp = *reinterpret_cast<const float4*>(ws + r * R + o);
          cfma(y0, xin[r], lo(wp));
          cfma(y1, xin[r], hi(wp));
        }
        col[o * chs] = y0;
        col[(o + 1) * chs] = y1;
      }
    }
  }
  __syncthreads();

  // (3) out[x, a, b] = sum_(q, u) Y[ta, (x, u), q] g[b, u, q], g in chunks of QC columns q:
  // gs[(b / 2) * kPair + ((b % 2) * DW + u) * QC + qc] = g[b, u, q0 + qc]
  constexpr int kPair = 2 * DW * QC + 2;
  const int pairs = chs / 2;
  const int bp = tid % pairs, rg = tid / pairs;
  const bool owns = rg < T::GROUPS;
#pragma unroll
  for (int i = 0; i < RG; ++i) acc[i][0] = acc[i][1] = make_float2(0.f, 0.f);
  for (int q0 = 0; q0 < chs; q0 += QC) {
    const int qn = min(QC, chs - q0);  // even
    for (int e = tid; e < chs * DW * qn; e += kThreads) {
      const int qc = e % qn, u = (e / qn) % DW, b = e / (qn * DW);
      const int q = q0 + qc;
      gs[(b / 2) * kPair + ((b % 2) * DW + u) * QC + qc] =
          b < chi && q < chi ? gz[(static_cast<size_t>(b) * DW + u) * chi + q] : make_float2(0.f, 0.f);
    }
    __syncthreads();
    if (owns) {
      const float2* g0 = gs + bp * kPair;
#pragma unroll
      for (int u = 0; u < DW; ++u) {
        for (int qc = 0; qc < qn; qc += 2) {
          const float4 ga = *reinterpret_cast<const float4*>(g0 + u * QC + qc);         // g[b, u, q:q+2]
          const float4 gb = *reinterpret_cast<const float4*>(g0 + (DW + u) * QC + qc);  // g[b + 1, u, q:q+2]
#pragma unroll
          for (int i = 0; i < RG; ++i) {
            const int row = min(rg * RG + i, T::NR - 1), ta = row / P, x = row % P;
            const float4 y = *reinterpret_cast<const float4*>(xy + (ta * R + x * DW + u) * chs + q0 + qc);
            cfma(acc[i][0], lo(y), lo(ga));
            cfma(acc[i][0], hi(y), hi(ga));
            cfma(acc[i][1], lo(y), lo(gb));
            cfma(acc[i][1], hi(y), hi(gb));
          }
        }
      }
    }
    __syncthreads();
  }
}

// The element (within a trajectory's (P, chi, chi) block) that a thread's
// acc[i][s] of the tile starting at row a0 stands for, or -1 where the
// thread owns none (rows past chi, the padding column, idle threads).
template <int P, int DW>
__device__ __forceinline__ int owned_index(int a0, int i, int s, int chi, int chs) {
  using T = Tile<P, DW>;
  const int pairs = chs / 2;
  const int bp = threadIdx.x % pairs, rg = threadIdx.x / pairs;
  const int row = rg * T::RG + i, ta = row / P, x = row % P;
  const int a = a0 + ta, b = 2 * bp + s;
  if (rg >= T::GROUPS || row >= T::NR || a >= chi || b >= chi) return -1;
  return (x * chi + a) * chi + b;
}

}  // namespace heff
