// Kernel K10: the two-site gate merge of a TEBD bond, per trajectory
//   M[s1 l + x, s2 r + y] = sum_(t1, t2) G[s1 s2, t1 t2] sum_m A[t1, x, m] B[t2, m, y]
// for site tensors A (B, 2, l, m), B (B, 2, m, r) complex64 and a gate
// G (4, 4) shared by the batch (gate stride 0) or one per trajectory (gate
// stride 16).  M (B, 2 l, 2 r) is the split's input matrix.
//
// Replaces: yaqs_tpu/digital/engine.py _apply_bond_gate (:76-80) with
// yaqs_tpu/ops/decomp.py merge_two_site (:122) and the (s1, x) x (s2, y)
// permute copy in front of every split (the XLA chain K10).  On the digital
// path it runs once per bond of every half-layer: 19 bonds at B = 512,
// chi = 32.  With two-site noise it also forms the bond dissipators' blocks
// (a shared gate per bond: 99 bonds at B = 32, chi = 64 on the analog path)
// and each trajectory's two-site jump (a gate per trajectory:
// yaqs_tpu/methods/stochastic.py _apply_channel2, :122-141).
//
// What bounds it on the card: device memory at B = 512, chi = 32 (it reads
// the two site tensors and writes M, (2 l m + 2 m r + 4 l r) * 8 bytes a
// trajectory, 34 MB, 10 us at 3.35 TB/s, against 8 us of FP32 operations);
// operations at B = 32, chi = 64 (4 chi^3 + 16 chi^2 complex MACs a
// trajectory, 0.29 GFLOP, 4.3 us at 67 TFLOP/s, against 2.6 us of bytes).
//
// Design: grid (B, slices).  A block owns a slice [x0, x0 + bx) x [y0, y0 +
// by) of theta's (x, y) for all four (t1, t2) and both (s1, s2), so it
// needs A's rows x0.. and B's columns y0.. only and no sum crosses blocks;
// the wrapper's plan (bond_gate.plan) picks (bx, by), powers of two, so
// that a small batch still fills the card (four quadrants a trajectory at
// B = 32, chi = 64; one block a trajectory at B = 512, chi = 32).  A and B
// stream through a ring of kStages shared-memory stages along m, kChunk
// values of m a stage, by cp.async (16 bytes where the rows allow it):
// A's rows padded by kPad so that the threads' 16-byte reads of (k, k + 1)
// pairs fall on distinct banks, B's rows as they are.  Each thread keeps a
// kTX x kTY register tile of theta for the four (t1, t2) (32 accumulators);
// a pair of m values costs it 12 shared loads of 16 bytes for 64 complex
// FMAs.  Then it mixes the tile with the gate (read into registers) and
// writes its outputs of M straight to their permuted places: a warp's
// stores are contiguous row segments of M.  theta never leaves registers.
// Each output is summed over m in ascending order and mixed over (t1, t2)
// in ascending order whatever the slice, so a trajectory's block has the
// same bits in any batch and plan.

#include "launch.cuh"

namespace {

constexpr int kMaxChi = 64;
constexpr int kTX = 4;           // rows x of a thread's register tile (strided by bx / kTX)
constexpr int kTY = 2;           // columns y of a thread's register tile (one 16-byte pair)
constexpr int kChunk = 16;       // values of m a ring stage holds
constexpr int kPad = 2;          // complex values a staged row of A is padded by
constexpr int kStages = 3;       // ring stages
constexpr int kMaxThreads = 256;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// float2 elements of one ring stage of a (bx, by) slice: A's rows (2, bx,
// kChunk + kPad), then B's (2, kChunk, by)
__host__ __device__ constexpr int stage_elems(int bx, int by) { return 2 * bx * (kChunk + kPad) + 2 * kChunk * by; }

// the gate (16 values), then the ring
__host__ __device__ constexpr size_t smem_bytes(int bx, int by) {
  return sizeof(float2) * (16 + static_cast<size_t>(kStages) * stage_elems(bx, by));
}

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float2 lo(float4 v) { return make_float2(v.x, v.y); }
__device__ __forceinline__ float2 hi(float4 v) { return make_float2(v.z, v.w); }

__device__ __forceinline__ int log2_of(int pow2) { return __ffs(pow2) - 1; }

// kVec: every row of A, B and M starts 16-byte aligned (m and r even, even
// strides, aligned pointers), so copies and stores go 16 bytes at a time.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 2)
bond_gate_kernel(const float2* __restrict__ a, long long stride_a, const float2* __restrict__ bt,
                 long long stride_b, const float2* __restrict__ gate, long long stride_g, float2* __restrict__ out,
                 int l, int m, int r, int bx, int by, int slices_x) {
  extern __shared__ float4 smem4[];
  float2* sg = reinterpret_cast<float2*>(smem4);  // G[s1 s2, t1 t2]
  float2* ring = sg + 16;
  const int se = stage_elems(bx, by);
  const int arow = kChunk + kPad;
  const int z = blockIdx.x;
  const int x0 = (blockIdx.y % slices_x) * bx;
  const int y0 = (blockIdx.y / slices_x) * by;
  const float2* az = a + z * stride_a;
  const float2* bz = bt + z * stride_b;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lbx = log2_of(bx), lby = log2_of(by);

  // chunk q: A[t1, x0 + xx, q kChunk + kk] and B[t2, q kChunk + kk, y0 + yy]
  // into stage q % kStages; zeros outside (l, m, r)
  auto load_chunk = [&](int q) {
    float2* sa = ring + (q % kStages) * se;
    float2* sb = sa + 2 * bx * arow;
    const int k0 = q * kChunk;
    if (kVec) {
      constexpr int kp = kChunk / 2;  // 16-byte pairs of a row of A's chunk
      for (int e = tid; e < 2 * bx * kp; e += nth) {
        const int kk = 2 * (e % kp), row = e / kp;  // row = t1 bx + xx
        const int t1 = row >> lbx, x = x0 + (row & (bx - 1));
        const bool ok = x < l && k0 + kk < m;
        cp_async16(reinterpret_cast<float4*>(sa + row * arow + kk), reinterpret_cast<const float4*>(az),
                   ((t1 * l + x) * static_cast<long long>(m) + k0 + kk) / 2, ok);
      }
      const int half = by / 2;
      for (int e = tid; e < 2 * kChunk * half; e += nth) {
        const int yy = 2 * (e & (half - 1)), row = e >> (lby - 1);  // row = t2 kChunk + kk
        const int t2 = row / kChunk, k = k0 + row % kChunk;
        const bool ok = k < m && y0 + yy < r;
        cp_async16(reinterpret_cast<float4*>(sb + row * by + yy), reinterpret_cast<const float4*>(bz),
                   ((t2 * m + k) * static_cast<long long>(r) + y0 + yy) / 2, ok);
      }
    } else {
      for (int e = tid; e < 2 * bx * kChunk; e += nth) {
        const int kk = e % kChunk, row = e / kChunk;
        const int t1 = row >> lbx, x = x0 + (row & (bx - 1));
        cp_async8(sa + row * arow + kk, az, (t1 * l + x) * static_cast<long long>(m) + k0 + kk, x < l && k0 + kk < m);
      }
      for (int e = tid; e < 2 * kChunk * by; e += nth) {
        const int yy = e & (by - 1), row = e >> lby;
        const int t2 = row / kChunk, k = k0 + row % kChunk;
        cp_async8(sb + row * by + yy, bz, (t2 * m + k) * static_cast<long long>(r) + y0 + yy, k < m && y0 + yy < r);
      }
    }
  };

  const int nq = cdiv(m, kChunk);
  for (int e = tid; e < 16; e += nth) cp_async8(sg + e, gate + z * stride_g + e);  // a block may have 8 threads
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < nq) load_chunk(q);
    cp_async_commit();  // empty groups keep the count of groups in flight uniform
  }

  // the thread's tile: rows x0 + tx + rr ntx, columns y0 + 2 ty, + 1
  const int nty = by / kTY, ntx = bx / kTX;
  const int ty = tid % nty, tx = tid / nty;
  float2 acc[2][2][kTX][kTY];  // [t1][t2][rr][cc]
#pragma unroll
  for (int t1 = 0; t1 < 2; ++t1)
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
      for (int rr = 0; rr < kTX; ++rr)
#pragma unroll
        for (int cc = 0; cc < kTY; ++cc) acc[t1][t2][rr][cc] = make_float2(0.f, 0.f);

  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages - 2>();  // chunk q has landed for this thread ...
    __syncthreads();               // ... and for all; every thread is done with chunk q - 1's stage
    if (q + kStages - 1 < nq) load_chunk(q + kStages - 1);
    cp_async_commit();
    const float2* sa = ring + (q % kStages) * se;
    const float2* sb = sa + 2 * bx * arow;
    const int kc = min(kChunk, m - q * kChunk);  // an odd m reads its zero partner: + 0 * 0
#pragma unroll 2
    for (int kk = 0; kk < kc; kk += 2) {
      float4 bv[2][2];  // [t2][k - kk]: B[t2, k, y pair]
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          bv[t2][p] = *reinterpret_cast<const float4*>(sb + (t2 * kChunk + kk + p) * by + kTY * ty);
#pragma unroll
      for (int t1 = 0; t1 < 2; ++t1) {
        float4 av[kTX];  // A[t1, x, (kk, kk + 1)]
#pragma unroll
        for (int rr = 0; rr < kTX; ++rr)
          av[rr] = *reinterpret_cast<const float4*>(sa + (t1 * bx + tx + rr * ntx) * arow + kk);
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
          for (int rr = 0; rr < kTX; ++rr) {
            cfma(acc[t1][t2][rr][0], lo(av[rr]), lo(bv[t2][0]));
            cfma(acc[t1][t2][rr][1], lo(av[rr]), hi(bv[t2][0]));
            cfma(acc[t1][t2][rr][0], hi(av[rr]), lo(bv[t2][1]));
            cfma(acc[t1][t2][rr][1], hi(av[rr]), hi(bv[t2][1]));
          }
      }
    }
  }

  // mix with the gate and write M[s1 l + x, s2 r + y]
  const int ldo = 2 * r;
  float2* oz = out + static_cast<size_t>(z) * (2 * l) * ldo;
  const int y = y0 + kTY * ty;
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // s = s1 2 + s2
    float2 g[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) g[p] = sg[s * 4 + p];
#pragma unroll
    for (int rr = 0; rr < kTX; ++rr) {
      const int x = x0 + tx + rr * ntx;
      if (x >= l) continue;
      float2 o[kTY];
#pragma unroll
      for (int cc = 0; cc < kTY; ++cc) {
        o[cc] = make_float2(0.f, 0.f);
#pragma unroll
        for (int p = 0; p < 4; ++p) cfma(o[cc], g[p], acc[p >> 1][p & 1][rr][cc]);
      }
      float2* dst = oz + static_cast<size_t>((s >> 1) * l + x) * ldo + (s & 1) * r + y;
      if (kVec && y + 1 < r) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0].x, o[0].y, o[1].x, o[1].y);
      } else {
        if (y < r) dst[0] = o[0];
        if (y + 1 < r) dst[1] = o[1];
      }
    }
  }
}

template <bool kVec>
int launch(const float2* a, long long sa, const float2* b, long long sb, const float2* gate, long long sg,
           float2* out, int batch, int l, int m, int r, int bx, int by, cudaStream_t stream) {
  static const cudaError_t configured = prepare(bond_gate_kernel<kVec>, kSmemLimit);  // once, for every size
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const int slices_x = cdiv(l, bx);
  const dim3 grid(batch, slices_x * cdiv(r, by));
  bond_gate_kernel<kVec><<<grid, bx * by / (kTX * kTY), smem_bytes(bx, by), stream>>>(
      a, sa, b, sb, gate, sg, out, l, m, r, bx, by, slices_x);
  return static_cast<int>(cudaGetLastError());
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0; }

}  // namespace

// a: site tensors with (2, l, m) contiguous and stride_a elements between
// trajectories; b likewise (2, m, r); gate (4, 4) contiguous, stride_g
// elements (0 or 16) between trajectories' gates; out (batch, 2 l, 2 r).
// The plan (bond_gate.plan): a block owns bx x by of theta's (x, y), both
// powers of two, bx >= kTX, by >= kTY, at most kMaxThreads threads.
extern "C" int bond_gate_launch(const void* a, long long stride_a, const void* b, long long stride_b,
                                const void* gate, long long stride_g, void* out, int batch, int l, int m, int r,
                                int bx, int by, void* stream) {
  const int threads = (bx > 0 && by > 0) ? bx * by / (kTX * kTY) : 0;
  if (batch <= 0 || l <= 0 || m <= 0 || r <= 0 || l > kMaxChi || m > kMaxChi || r > kMaxChi ||
      (stride_g != 0 && stride_g != 16) || !pow2(bx) || !pow2(by) || bx < kTX || by < kTY || bx > kMaxChi ||
      by > kMaxChi || threads > kMaxThreads || smem_bytes(bx, by) > kSmemLimit || cdiv(l, bx) * cdiv(r, by) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = m % 2 == 0 && r % 2 == 0 && stride_a % 2 == 0 && stride_b % 2 == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(out);
  const auto ap = static_cast<const float2*>(a);
  const auto bp = static_cast<const float2*>(b);
  const auto gp = static_cast<const float2*>(gate);
  const auto op = static_cast<float2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(ap, stride_a, bp, stride_b, gp, stride_g, op, batch, l, m, r, bx, by, s)
             : launch<false>(ap, stride_a, bp, stride_b, gp, stride_g, op, batch, l, m, r, bx, by, s);
}
