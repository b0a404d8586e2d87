// Kernel K15: the jump weights of the adjacent non-Pauli two-site channels,
// one thread block per (channel, trajectory).
//
// Replaces: yaqs_tpu/methods/stochastic.py channel_weights2 (:65-84, the XLA
// chain K15): on the analog path once per jump step with two-site noise, on
// the digital path once per half-layer and gate stage.
//
// What it computes, for tensors (B, L, 2, chi, chi), the left and right Gram
// environments E, R (B, L, chi, chi) of moment_scan.cu (E_i before site i,
// R_i after it), and channel k on bond b = bonds[k] with weight operator
// W_k (4, 4) and coefficient c_k = dt * gamma_k, exactly as the JAX function:
//   theta[(s1 s2), l, r] = sum_m A_b[s1, l, m] A_(b+1)[s2, m, r]
//   Y[q, l, r] = sum_(m, t) E_b[l, m] theta[q, m, t] R_(b+1)[r, t]
//   out[z, k] = c_k * Re sum_(p, q, l, r) conj(theta[p, l, r]) W_k[p, q] Y[q, l, r]
//
// What bounds it on the card: arithmetic.  A block does 12 chi^3 complex
// MACs: 3.1 M at chi = 64, so 10 GMAC (81 GFLOP) over 99 channels and 32
// trajectories, against reading two sites and two environments (128 KB) a
// block.
//
// Design: the products are merged by re-association.  With P_s1 = E A_b[s1]
// and Q_s2 = A_(b+1)[s2] R^T, E theta_(s1 s2) R^T = P_s1 Q_s2, so
//   1. P = E [A_b[0] | A_b[1]]            (chi x 2chi, one product, 2 chi^3)
//   2. Q = [A_(b+1)[0]; A_(b+1)[1]] R^T    (2chi x chi, one product, 2 chi^3)
//   3. theta = [A_b[0]; A_b[1]] [A_(b+1)[0] | A_(b+1)[1]]  (2chi x 2chi, 4 chi^3)
//   4. Y = [P_0; P_1] [Q_0 | Q_1]          (2chi x 2chi, 4 chi^3)
// P and Q stay in shared memory (66 KB each at chi = 64, transposed so the
// products read them along k); theta and Y never leave registers: a
// thread's 8 x 4 complex micro-tile holds four l, two r and all four
// (s1, s2) blocks, so the epilogue folds W_k and conj(theta) into Y where it
// is computed.  The sites and environments are staged into shared memory by
// cp.async, double-buffered along k in chunks of kChunk (R transposed as it
// lands), so no product reads device memory inside its k loop.  Each k step
// loads 8 + 4 complex operands for 32 complex FMAs.  One 256-thread block an
// SM (197 KB of shared memory and 233 registers a thread at chi = 64).

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChi = 64;
constexpr int kChunk = 16;                  // k per stage
constexpr int kStageLd = 2 * kMaxChi;       // a staged row: up to 2 chi operands
constexpr int kStage = 2 * kChunk * kStageLd;  // float2: the A chunk, then the B chunk

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// The k loop of one product over K = chi in chunks of kChunk: load(chunk,
// stage) issues the chunk's cp.asyncs, compute(stage) runs on it; the next
// chunk lands while this one is computed.
template <typename Load, typename Compute>
__device__ __forceinline__ void staged_loop(int chi, float2* stages, Load load, Compute compute) {
  const int chunks = (chi + kChunk - 1) / kChunk;
  load(0, stages);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load(ch + 1, stages + ((ch + 1) & 1) * kStage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(stages + (ch & 1) * kStage);
    __syncthreads();
  }
}

// acc[i][c] += sum_kk A(kk, arow[i]) B(kk, bcol[c]) over a staged chunk
__device__ __forceinline__ void chunk_fma(const float2* stage, const int (&arow)[8], const int (&bcol)[4],
                                          float2 (&acc)[8][4]) {
  const float2* as = stage;
  const float2* bs = stage + kChunk * kStageLd;
#pragma unroll 4
  for (int kk = 0; kk < kChunk; ++kk) {
    float2 av[8], bv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = as[kk * kStageLd + arow[i]];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = bs[kk * kStageLd + bcol[c]];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) cfma(acc[i][c], av[i], bv[c]);
  }
}

__device__ __forceinline__ void zero(float2 (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = make_float2(0.f, 0.f);
}

size_t smem_bytes(int chi) {
  return sizeof(float2) * (2 * static_cast<size_t>(chi) * (2 * chi + 1) + 2 * kStage);
}

__global__ void __launch_bounds__(kThreads, 1)
pair_weights_kernel(const float2* __restrict__ t, const float2* __restrict__ left_envs,
                    const float2* __restrict__ right_envs, const long long* __restrict__ bonds,
                    const float2* __restrict__ wop, const float* __restrict__ coeff, float* __restrict__ out, int L,
                    int chi, int nc2) {
  extern __shared__ float2 smem[];
  __shared__ float2 sw[16];
  __shared__ float partial[kWarps];
  const int ld = 2 * chi + 1;
  float2* ps = smem;             // P^T: ps[m * ld + s1 chi + l] = P_s1[l, m]
  float2* qs = ps + chi * ld;    // Q:   qs[m * ld + s2 chi + r] = Q_s2[m, r]
  float2* stages = qs + chi * ld;
  const int cc = chi * chi;
  const int k = blockIdx.x;
  const int z = blockIdx.y;
  const int bond = static_cast<int>(bonds[k]);
  const float2* a = t + (static_cast<size_t>(z) * L + bond) * 2 * cc;  // A_b (2, chi, chi)
  const float2* bb = a + 2 * cc;                                          // A_(b+1)
  const float2* e = left_envs + (static_cast<size_t>(z) * L + bond) * cc;
  const float2* r = right_envs + (static_cast<size_t>(z) * L + bond + 1) * cc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < 16) sw[tid] = wop[k * 16 + tid];
  float2 acc[8][4];

  // 1. P = E [A_b[0] | A_b[1]]: rows l = warp + 8 i, columns (s1, m) = lane + 32 c
  {
    int arow[8], bcol[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) arow[i] = warp + 8 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) bcol[c] = lane + 32 * c;
    zero(acc);
    staged_loop(
        chi, stages,
        [&](int ch, float2* st) {
          const int t0 = ch * kChunk;
          for (int x = tid; x < chi * kChunk; x += kThreads) {  // E[l, t0 + kk] -> as[kk][l]
            const int l = x / kChunk, kk = x % kChunk;
            cp_async8(st + kk * kStageLd + l, e, l * chi + t0 + kk, t0 + kk < chi);
          }
          for (int x = tid; x < kChunk * 2 * chi; x += kThreads) {  // A_b[s1, t0 + kk, m] -> bs[kk][s1 chi + m]
            const int kk = x / (2 * chi), col = x % (2 * chi);
            const int s1 = col / chi, m = col % chi;
            cp_async8(st + kChunk * kStageLd + kk * kStageLd + col, a, s1 * cc + (t0 + kk) * chi + m, t0 + kk < chi);
          }
        },
        [&](const float2* st) { chunk_fma(st, arow, bcol, acc); });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int l = arow[i], col = bcol[c];
        if (l < chi && col < 2 * chi) ps[(col % chi) * ld + (col / chi) * chi + l] = acc[i][c];
      }
    }
  }

  // 2. Q = [A_(b+1)[0]; A_(b+1)[1]] R^T: rows (s2, m) = 2 warp + lane / 16 + 16 i, columns r = lane % 16 + 16 c
  {
    int arow[8], bcol[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) arow[i] = 2 * warp + lane / 16 + 16 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) bcol[c] = lane % 16 + 16 * c;
    zero(acc);
    staged_loop(
        chi, stages,
        [&](int ch, float2* st) {
          const int t0 = ch * kChunk;
          for (int x = tid; x < 2 * chi * kChunk; x += kThreads) {  // A_(b+1)[s2, m, t0 + kk] -> as[kk][s2 chi + m]
            const int row = x / kChunk, kk = x % kChunk;
            cp_async8(st + kk * kStageLd + row, bb, row * chi + t0 + kk, t0 + kk < chi);
          }
          for (int x = tid; x < chi * kChunk; x += kThreads) {  // R[r, t0 + kk] -> bs[kk][r] (R^T)
            const int rr = x / kChunk, kk = x % kChunk;
            cp_async8(st + kChunk * kStageLd + kk * kStageLd + rr, r, rr * chi + t0 + kk, t0 + kk < chi);
          }
        },
        [&](const float2* st) { chunk_fma(st, arow, bcol, acc); });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = arow[i], rr = bcol[c];
        if (row < 2 * chi && rr < chi) qs[(row % chi) * ld + (row / chi) * chi + rr] = acc[i][c];
      }
    }
  }
  __syncthreads();

  // 3-4. theta and Y on the same micro-tile: l = l0 + warp + 8 i' (i' < 4),
  // r = lane + 32 c' (c' < 2); row slot i = 4 s1 + i', column slot c = 2 s2 + c'
  float total = 0.f;
  for (int l0 = 0; l0 < chi; l0 += 32) {
    int arow[8], bcol[4], prow[8], qcol[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s1 = i / 4, l = l0 + warp + 8 * (i % 4);
      arow[i] = s1 * 32 + warp + 8 * (i % 4);
      prow[i] = s1 * chi + min(l, chi - 1);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s2 = c / 2, rr = lane + 32 * (c % 2);
      bcol[c] = s2 * chi + min(rr, chi - 1);
      qcol[c] = bcol[c];
    }
    zero(acc);
    staged_loop(
        chi, stages,
        [&](int ch, float2* st) {
          const int m0 = ch * kChunk;
          for (int x = tid; x < 64 * kChunk; x += kThreads) {  // A_b[s1, l, m0 + kk] -> as[kk][s1 32 + l - l0]
            const int row = x / kChunk, kk = x % kChunk;
            const int s1 = row / 32, l = l0 + row % 32;
            cp_async8(st + kk * kStageLd + row, a, s1 * cc + l * chi + m0 + kk, l < chi && m0 + kk < chi);
          }
          for (int x = tid; x < kChunk * 2 * chi; x += kThreads) {  // A_(b+1)[s2, m0 + kk, r] -> bs[kk][s2 chi + r]
            const int kk = x / (2 * chi), col = x % (2 * chi);
            const int s2 = col / chi, rr = col % chi;
            cp_async8(st + kChunk * kStageLd + kk * kStageLd + col, bb, s2 * cc + (m0 + kk) * chi + rr, m0 + kk < chi);
          }
        },
        [&](const float2* st) { chunk_fma(st, arow, bcol, acc); });
    // theta -> M_q = sum_p W[p, q] conj(theta_p), in place: p = 2 s1 + s2
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        float2 th[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float2 v = acc[4 * (p / 2) + ii][2 * (p % 2) + cx];
          th[p] = make_float2(v.x, -v.y);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 w = make_float2(0.f, 0.f);
#pragma unroll
          for (int p = 0; p < 4; ++p) cfma(w, sw[p * 4 + q], th[p]);
          acc[4 * (q / 2) + ii][2 * (q % 2) + cx] = w;
        }
      }
    }
    float2 y[8][4];
    zero(y);
#pragma unroll 2
    for (int m = 0; m < chi; ++m) {
      float2 av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = ps[m * ld + prow[i]];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = qs[m * ld + qcol[c]];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) cfma(y[i][c], av[i], bv[c]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool row_ok = l0 + warp + 8 * (i % 4) < chi;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (row_ok && lane + 32 * (c % 2) < chi) total = fmaf(acc[i][c].x, y[i][c].x, fmaf(-acc[i][c].y, y[i][c].y, total));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) total += __shfl_down_sync(0xffffffffu, total, off);
  if (lane == 0) partial[warp] = total;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += partial[w];
    out[static_cast<size_t>(z) * nc2 + k] = coeff[k] * sum;
  }
}

}  // namespace

// t (batch, L, 2, chi, chi), left_envs and right_envs (batch, L, chi, chi),
// all contiguous; bonds (nc2,) int64 in [0, L - 2]; wop (nc2, 4, 4);
// coeff (nc2,) float; out (batch, nc2) float
extern "C" int pair_weights_launch(const void* t, const void* left_envs, const void* right_envs, const void* bonds,
                                   const void* wop, const void* coeff, void* out, int batch, int L, int chi, int nc2,
                                   void* stream) {
  if (batch <= 0 || batch > 65535 || nc2 <= 0 || L < 2 || chi <= 0 || chi > kMaxChi) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(chi);
  cudaError_t err = allow_smem(pair_weights_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_weights_kernel<<<dim3(nc2, batch), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(t), static_cast<const float2*>(left_envs), static_cast<const float2*>(right_envs),
      static_cast<const long long*>(bonds), static_cast<const float2*>(wop), static_cast<const float*>(coeff),
      static_cast<float*>(out), L, chi, nc2);
  return static_cast<int>(cudaGetLastError());
}
