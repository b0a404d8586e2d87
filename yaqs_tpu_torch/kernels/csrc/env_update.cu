// Kernel K8: the MPO environment update of TDVP, per trajectory,
//   left:  F'[m, v, k] = sum conj(Ab[t, a, m]) W[t, s, w, v] Ak[s, b, k] F[a, w, b]
//   right: G'[a, w, b] = sum conj(Ab[t, a, m]) W[t, s, w, v] Ak[s, b, k] G[m, v, k]
// for environments (B, chi, Dw, chi), site tensors (B, d, chi, chi) and one
// MPO site W (d, d, Dw, Dw) shared by the batch.  The right update is the
// left one with the two bond indices of both site tensors and the two MPO
// bond indices exchanged, so one kernel runs both.  Written generically, with
// A(t, i, j) = A[t, i, j] (left) or A[t, j, i] (right) and W'(t, s, w, v) =
// W[t, s, w, v] (left) or W[t, s, v, w] (right):
//   T1[(p, w), s, j] = sum_i F[p, w, i] Ak(s, i, j)                  (F's rows)
//   T2[p, t, v, j]   = sum_(w, s) T1[(p, w), s, j] W'(t, s, w, v)
//   out[m, v, j]     = sum_(t, p) conj(Ab(t, p, m)) T2[p, t, v, j].
//
// Replaces: yaqs_tpu/methods/tdvp.py update_left_env, update_right_env
// (:98-109) and the scan of right_environments (:112-129) (XLA chain K8): at
// L = 100 a sweep runs 297 of them.
//
// What bounds it on the card: operations.  2 d Dw chi^3 + d^2 Dw^2 chi^2
// complex MACs per trajectory (3.29 M at chi = 64, Dw = 3, d = 2; 0.84 GFLOP
// at B = 32, 12.6 us at 67 TFLOP/s fp32) against (2 Dw + 2 d) chi^2 complex
// values moved.
//
// Design: grid (column slices, B).  A block owns the output columns
// [c0, c0 + w) of one trajectory (w = 4 .. 32, `cols`, chosen by the wrapper:
// 16 at the analog shape, 128 blocks of 384 threads); T1, T2 and out
// restricted to those columns need the whole F and the whole bra but only w
// columns of the ket, so no sum crosses blocks.  Everything reaches shared
// memory through cp.async copies in which consecutive threads read
// consecutive addresses: the ket's slice (transposed for the right update),
// then F in chunks of `chunk` columns (rows padded to chunk + 1) and the bra
// in chunks of up to chi rows of one t (padded to chi + 1; the right
// update's bra is read along its rows and stored transposed), through a
// ring of two stages, each chunk copied while the one before it is
// contracted.
//  (1) T1 = F (chi Dw x chi) times the ket's slice (chi x d w), chunk by
//      chunk: each thread keeps one TM1 x 4 register tile of T1 across the
//      chunks, its rows strided by M / TM1 and its columns by N / 4 (the
//      tile of ns_polar.cuh's tile_product).
//  (2) T2 from T1 in place: a thread holds one (p, j) column of T1, d Dw
//      values, in registers and writes the d Dw values of T2 over them.
//  (3) out = conj(bra)^T (chi x d chi) times T2 (d chi x Dw w), bra chunk by
//      bra chunk, one TM3 x 4 register tile a thread (TM3 = TM1 / 2: 2 or
//      4), the conjugation applied as the bra is read.
// Each output element is summed whole by one thread in a fixed order (i
// ascending; (w, s); t, then p ascending), whatever the column slice, the
// tile or the batch: a trajectory gets the same bits in any batch.  d = 2,
// chi <= 64, Dw <= 8; the output may be a view with any stride between
// trajectories, so right_environments writes in place.

#include "launch.cuh"

namespace {

constexpr int kMaxChi = 64;
constexpr int kMaxDw = 8;
constexpr int kD = 2;
constexpr int kTN = 4;  // columns of a register tile

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// acc += conj(a) b
__device__ __forceinline__ void cfma_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(-a.y, b.x, acc.y);
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The block's threads: one register tile each in both products (T1 is chi Dw
// x d w in TM1 x 4 tiles, out chi x Dw w in TM3 x 4 tiles), rounded up to
// whole warps.
__host__ __device__ inline int env_threads(int chi, int dw, int cols, int tm3) {
  const int tiles1 = cdiv(chi * dw, 2 * tm3) * (kD * cols / kTN);
  const int tiles3 = cdiv(chi, tm3) * (dw * cols / kTN);
  return cdiv(tiles1 > tiles3 ? tiles1 : tiles3, 32) * 32;
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

__device__ __forceinline__ int log2_of(int pow2) { return __ffs(pow2) - 1; }

// Shared memory of a block, in float2: W', the ket's slice (d chi rows of
// w + 1), T1 / T2 (chi Dw d w), and two ring stages, each an F chunk (chi Dw
// rows of chunk + 1) or a bra chunk of brows rows of chi + 1: the largest
// power of two of rows, at most chi's, that fits the stage.
struct EnvLayout {
  int wsz, ket, t, stage, brows;
  __host__ __device__ EnvLayout(int chi, int dw, int cols, int chunk) {
    wsz = kD * kD * dw * dw;
    ket = kD * chi * (cols + 1);
    t = chi * dw * kD * cols;
    const int f_stage = chi * dw * (chunk + 1);
    const int bra_stage = chunk * (chi + 1);
    stage = f_stage > bra_stage ? f_stage : bra_stage;
    brows = chunk;
    while (2 * brows * (chi + 1) <= stage && brows < pow2_at_least(chi)) brows *= 2;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float2) * (static_cast<size_t>(wsz) + ket + t + 2 * stage); }
};

// Threads a block may have: 384 with tiles of 4 x 4 and 2 x 4, 256 with
// 8 x 4 and 4 x 4.
__host__ __device__ constexpr int max_threads(int tm3) { return tm3 <= 2 ? 384 : 256; }

// TM3: rows of a product (3) tile; product (1) takes tiles of TM1 = 2 TM3.
template <int TM3>
__global__ void __launch_bounds__(max_threads(TM3))
env_update_kernel(const float2* __restrict__ f, long long sf, const float2* __restrict__ ab, long long sab,
                  const float2* __restrict__ ak, long long sak, const float2* __restrict__ w,
                  float2* __restrict__ out, long long so, int chi, int dw, int cols, int chunk, int right) {
  constexpr int TM1 = 2 * TM3;
  extern __shared__ float2 smem[];
  const EnvLayout ly(chi, dw, cols, chunk);
  float2* sw = smem;           // W'(t, s, w, v)
  float2* sket = sw + ly.wsz;  // Ak(s, i, c0 + jj) at (s chi + i) (cols + 1) + jj
  float2* st = sket + ly.ket;  // T1[(p, w), (s, jj)], then T2[p, t, (v, jj)]
  float2* ring = st + ly.t;

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int c0 = blockIdx.x * cols;
  const float2* fz = f + blockIdx.y * sf;
  const float2* abz = ab + blockIdx.y * sab;
  const float2* akz = ak + blockIdx.y * sak;
  const int cc = chi * chi;
  const int m1 = chi * dw;             // T1's rows
  const int kw = kD * cols;            // T1's columns
  const int pblock = dw * kD * cols;   // one p's slots of T1 / T2
  const int brows = ly.brows;
  const int nf = cdiv(chi, chunk);     // F chunks
  const int np = cdiv(chi, brows);     // bra chunks of one t
  const int nq = nf + kD * np;
  // cols, chunk and brows are powers of two; chi's index runs over chp >= chi
  const int chp = pow2_at_least(chi);
  const int lc = log2_of(cols), lk = log2_of(chunk), lb = log2_of(brows), lh = log2_of(chp);

  for (int e = tid; e < ly.wsz; e += nth) {
    const int v = e % dw;
    const int wl = (e / dw) % dw;
    const int ts = e / (dw * dw);
    sw[e] = right ? w[(ts * dw + v) * dw + wl] : w[e];
  }
  if (right) {  // Ak(s, i, j) = Ak[s, j, i]: read along i
    for (int e = tid; e < kD * cols * chp; e += nth) {
      const int i = e & (chp - 1), jj = (e >> lh) & (cols - 1), s = e >> (lh + lc);
      if (i < chi) cp_async8(sket + (s * chi + i) * (cols + 1) + jj, akz, s * cc + (c0 + jj) * chi + i, c0 + jj < chi);
    }
  } else {  // row (s, i) of Ak: cols consecutive columns
    for (int e = tid; e < kD * chi * cols; e += nth) {
      const int jj = e & (cols - 1), row = e >> lc;
      cp_async8(sket + row * (cols + 1) + jj, akz, row * chi + c0 + jj, c0 + jj < chi);
    }
  }

  // chunk q of the stream: F's columns [q chunk, ...) for q < nf, else the
  // bra's rows [p0, p0 + brows) of one t
  auto load_chunk = [&](int q, float2* dst) {
    if (q < nf) {
      const int b0 = q * chunk;
      for (int e = tid; e < m1 * chunk; e += nth) {
        const int bb = e & (chunk - 1), r = e >> lk;
        cp_async8(dst + r * (chunk + 1) + bb, fz, r * chi + b0 + bb, b0 + bb < chi);
      }
    } else {
      const int t = (q - nf) / np;
      const int p0 = ((q - nf) % np) * brows;
      if (right) {  // Ab(t, p, m) = Ab[t, m, p]: read along p, stored transposed
        for (int e = tid; e < brows * chi; e += nth) {
          const int pp = e & (brows - 1), m = e >> lb;
          cp_async8(dst + pp * (chi + 1) + m, abz, t * cc + m * chi + p0 + pp, p0 + pp < chi);
        }
      } else {
        for (int e = tid; e < brows * chp; e += nth) {
          const int m = e & (chp - 1), pp = e >> lh;
          if (m < chi) cp_async8(dst + pp * (chi + 1) + m, abz, t * cc + (p0 + pp) * chi + m, p0 + pp < chi);
        }
      }
    }
    cp_async_commit();
  };
  load_chunk(0, ring);  // with the ket's slice

  // (1)'s tile: rows it1 + r tm1, columns jt1 + c tn1 of T1
  const int tn1 = kw / kTN;
  const int tm1 = cdiv(m1, TM1);
  const bool on1 = tid < tm1 * tn1;
  const int it1 = tid / tn1, jt1 = tid % tn1;
  int ao1[TM1], bo1[kTN];
#pragma unroll
  for (int r = 0; r < TM1; ++r) ao1[r] = min(it1 + r * tm1, m1 - 1) * (chunk + 1);
#pragma unroll
  for (int c = 0; c < kTN; ++c) {
    const int j = jt1 + c * tn1;
    bo1[c] = (j / cols) * chi * (cols + 1) + j % cols;
  }
  // (3)'s tile: rows it3 + r tm3 (m), columns jt3 + c tn3 ((v, jj))
  const int tn3 = dw * cols / kTN;
  const int tm3 = cdiv(chi, TM3);
  const bool on3 = tid < tm3 * tn3;
  const int it3 = tid / tn3, jt3 = tid % tn3;
  int ao3[TM3];
#pragma unroll
  for (int r = 0; r < TM3; ++r) ao3[r] = min(it3 + r * tm3, chi - 1);

  // wait for chunk q (chunk q + 1 on its way) and hand back its stage
  auto stage = [&](int q) -> const float2* {
    if (q + 1 < nq) {
      load_chunk(q + 1, ring + ((q + 1) & 1) * ly.stage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    return ring + (q & 1) * ly.stage;
  };

  {
    // (1) T1[(p, w), (s, jj)] = sum_i F[p, w, i] Ak(s, i, c0 + jj), F chunk by F chunk
    float2 acc[TM1][kTN];
#pragma unroll
    for (int r = 0; r < TM1; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c) acc[r][c] = make_float2(0.f, 0.f);
    for (int q = 0; q < nf; ++q) {
      const float2* buf = stage(q);
      const int b0 = q * chunk;
      const int kb = min(chunk, chi - b0);
      if (on1) {
        const float2* bk = sket + b0 * (cols + 1);
#pragma unroll 4
        for (int bb = 0; bb < kb; ++bb) {
          float2 av[TM1], bv[kTN];
#pragma unroll
          for (int r = 0; r < TM1; ++r) av[r] = buf[ao1[r] + bb];
#pragma unroll
          for (int c = 0; c < kTN; ++c) bv[c] = bk[bo1[c]];
#pragma unroll
          for (int r = 0; r < TM1; ++r)
#pragma unroll
            for (int c = 0; c < kTN; ++c) cfma(acc[r][c], av[r], bv[c]);
          bk += cols + 1;
        }
      }
      __syncthreads();  // the stage is free for chunk q + 2
    }
    if (on1) {
#pragma unroll
      for (int r = 0; r < TM1; ++r) {
        const int row = it1 + r * tm1;
#pragma unroll
        for (int c = 0; c < kTN; ++c)
          if (row < m1) st[row * kw + jt1 + c * tn1] = acc[r][c];
      }
    }
  }
  __syncthreads();

  // (2) T2[p, t, v, jj] = sum_(w, s) T1[(p, w), s, jj] W'(t, s, w, v), in place
  for (int item = tid; item < chi * cols; item += nth) {
    float2* col = st + (item / cols) * pblock + item % cols;
    float2 x[kMaxDw * kD], y[kD * kMaxDw];
#pragma unroll
    for (int e = 0; e < kMaxDw * kD; ++e)
      if (e < dw * kD) x[e] = col[e * cols];
#pragma unroll
    for (int t = 0; t < kD; ++t)
#pragma unroll
      for (int v = 0; v < kMaxDw; ++v) {
        if (v >= dw) continue;
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int wl = 0; wl < kMaxDw; ++wl) {
          if (wl >= dw) continue;
#pragma unroll
          for (int s = 0; s < kD; ++s) cfma(acc, x[wl * kD + s], sw[((t * kD + s) * dw + wl) * dw + v]);
        }
        y[t * kMaxDw + v] = acc;
      }
#pragma unroll
    for (int t = 0; t < kD; ++t)
#pragma unroll
      for (int v = 0; v < kMaxDw; ++v)
        if (v < dw) col[(t * dw + v) * cols] = y[t * kMaxDw + v];
  }

  // (3) out[m, (v, jj)] = sum_(t, p) conj(Ab(t, p, m)) T2[p, t, (v, jj)], bra chunk by bra chunk
  float2 acc[TM3][kTN];
#pragma unroll
  for (int r = 0; r < TM3; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = make_float2(0.f, 0.f);
  for (int q = nf; q < nq; ++q) {
    const float2* buf = stage(q);  // its barrier also orders (2) before the first chunk
    const int t = (q - nf) / np;
    const int p0 = ((q - nf) % np) * brows;
    const int kp = min(brows, chi - p0);
    if (on3) {
      const float2* bk = st + p0 * pblock + t * dw * cols + jt3;
#pragma unroll 4
      for (int pp = 0; pp < kp; ++pp) {
        float2 av[TM3], bv[kTN];
#pragma unroll
        for (int r = 0; r < TM3; ++r) av[r] = buf[pp * (chi + 1) + ao3[r]];
#pragma unroll
        for (int c = 0; c < kTN; ++c) bv[c] = bk[c * tn3];
#pragma unroll
        for (int r = 0; r < TM3; ++r)
#pragma unroll
          for (int c = 0; c < kTN; ++c) cfma_conj(acc[r][c], av[r], bv[c]);
        bk += pblock;
      }
    }
    __syncthreads();
  }

  if (on3) {
    float2* oz = out + blockIdx.y * so;
#pragma unroll
    for (int r = 0; r < TM3; ++r) {
      const int m = it3 + r * tm3;
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        const int j = jt3 + c * tn3;
        const int v = j / cols, jj = j % cols;
        if (m < chi && c0 + jj < chi) oz[(m * dw + v) * chi + c0 + jj] = acc[r][c];
      }
    }
  }
}

template <int TM3>
int launch(const float2* f, long long sf, const float2* ab, long long sab, const float2* ak, long long sak,
           const float2* w, float2* out, long long so, int batch, int chi, int dw, int cols, int chunk, int right,
           cudaStream_t stream) {
  static const cudaError_t configured = prepare(env_update_kernel<TM3>, kSmemLimit);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid(cdiv(chi, cols), batch);
  const int threads = env_threads(chi, dw, cols, TM3);
  env_update_kernel<TM3><<<grid, threads, EnvLayout(chi, dw, cols, chunk).bytes(), stream>>>(
      f, sf, ab, sab, ak, sak, w, out, so, chi, dw, cols, chunk, right);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f: (chi, dw, chi) per trajectory, stride sf; a_bra / a_ket: (2, chi, chi)
// per trajectory, strides sab / sak (the bra is conjugated here); w: (2, 2,
// dw, dw); out: (chi, dw, chi) per trajectory, stride so.  right = 0 runs
// update_left_env, right = 1 update_right_env.  The plan (env_update.plan):
// cols, the output columns of a block (4, 8, 16 or 32); chunk, the F columns
// of a ring stage (a power of two); tm3, the rows of a product (3) tile (2 or 4; product (1)
// takes 2 tm3).
extern "C" int env_update_launch(const void* f, long long sf, const void* a_bra, long long sab, const void* a_ket,
                                 long long sak, const void* w, void* out, long long so, int batch, int chi, int dw,
                                 int cols, int chunk, int tm3, int right, void* stream) {
  const bool cols_ok = cols == 4 || cols == 8 || cols == 16 || cols == 32;
  const bool chunk_ok = chunk > 0 && (chunk & (chunk - 1)) == 0;  // the loads index by shifts
  if (batch <= 0 || batch > 65535 || chi <= 0 || chi > kMaxChi || dw <= 0 || dw > kMaxDw || !cols_ok || !chunk_ok ||
      EnvLayout(chi, dw, cols, chunk).bytes() > kSmemLimit || env_threads(chi, dw, cols, tm3) > max_threads(tm3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto fp = static_cast<const float2*>(f);
  const auto bp = static_cast<const float2*>(a_bra);
  const auto kp = static_cast<const float2*>(a_ket);
  const auto wp = static_cast<const float2*>(w);
  const auto op = static_cast<float2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tm3) {
    case 2: return launch<2>(fp, sf, bp, sab, kp, sak, wp, op, so, batch, chi, dw, cols, chunk, right, s);
    case 4: return launch<4>(fp, sf, bp, sab, kp, sak, wp, op, so, batch, chi, dw, cols, chunk, right, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
