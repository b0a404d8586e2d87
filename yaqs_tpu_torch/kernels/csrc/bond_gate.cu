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
// (a shared gate per bond) and each trajectory's two-site jump (a gate per
// trajectory: yaqs_tpu/methods/stochastic.py _apply_channel2, :122-141).
//
// What bounds it on the card: device memory.  It reads the two site tensors
// and writes M: (2 l m + 2 m r + 4 l r) * 8 bytes per trajectory, 34 MB at
// B = 512, chi = 32, i.e. about 10 us at 3.35 TB/s, against 4 chi^3 complex
// MACs of arithmetic (0.54 GFLOP, 8 us at 67 TFLOP/s fp32).  Eager
// PyTorch writes theta, the gated theta and the permuted copy to device
// memory in turn.
//
// Design: one block per trajectory.  The block stages both site tensors in
// shared memory (32 KB at chi = 32, 128 KB at chi = 64), then each thread
// owns a 2 x 2 (x, y) tile: it forms the four theta_(t1 t2) tiles in
// registers over the m loop, mixes them with the gate from shared memory,
// and writes its sixteen outputs of M straight to their permuted places.
// theta never leaves registers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChi = 64;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__global__ void __launch_bounds__(kThreads)
bond_gate_kernel(const float2* __restrict__ a, long long stride_a, const float2* __restrict__ bt,
                 long long stride_b, const float2* __restrict__ gate, long long stride_g, float2* __restrict__ out,
                 int l, int m, int r) {
  extern __shared__ float2 smem[];
  __shared__ float2 sg[16];
  float2* sa = smem;              // (2, l, m)
  float2* sb = sa + 2 * l * m;    // (2, m, r)
  const int z = blockIdx.x;
  const float2* az = a + z * stride_a;
  const float2* bz = bt + z * stride_b;
  for (int e = threadIdx.x; e < 2 * l * m; e += blockDim.x) sa[e] = az[e];
  for (int e = threadIdx.x; e < 2 * m * r; e += blockDim.x) sb[e] = bz[e];
  if (threadIdx.x < 16) sg[threadIdx.x] = gate[z * stride_g + threadIdx.x];
  __syncthreads();

  const int tl = (l + 1) / 2;
  const int tr = (r + 1) / 2;
  const int ldo = 2 * r;
  float2* oz = out + static_cast<size_t>(z) * (2 * l) * ldo;
  for (int t = threadIdx.x; t < tl * tr; t += blockDim.x) {
    const int x0 = (t / tr) * 2;
    const int y0 = (t % tr) * 2;
    const bool x1ok = x0 + 1 < l;
    const bool y1ok = y0 + 1 < r;
    float2 th[4][2][2];  // [t1 * 2 + t2][dx][dy]
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) th[p][dx][dy] = make_float2(0.f, 0.f);
    for (int k = 0; k < m; ++k) {
      float2 av[2][2], bv[2][2];  // av[t1][dx] = A[t1, x0+dx, k], bv[t2][dy] = B[t2, k, y0+dy]
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        av[s][0] = sa[(s * l + x0) * m + k];
        av[s][1] = x1ok ? sa[(s * l + x0 + 1) * m + k] : make_float2(0.f, 0.f);
        bv[s][0] = sb[(s * m + k) * r + y0];
        bv[s][1] = y1ok ? sb[(s * m + k) * r + y0 + 1] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int t1 = 0; t1 < 2; ++t1)
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
#pragma unroll
            for (int dy = 0; dy < 2; ++dy) cfma(th[t1 * 2 + t2][dx][dy], av[t1][dx], bv[t2][dy]);
    }
#pragma unroll
    for (int s1 = 0; s1 < 2; ++s1)
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            if ((dx == 1 && !x1ok) || (dy == 1 && !y1ok)) continue;
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll
            for (int p = 0; p < 4; ++p) cfma(acc, sg[(s1 * 2 + s2) * 4 + p], th[p][dx][dy]);
            oz[static_cast<size_t>(s1 * l + x0 + dx) * ldo + s2 * r + y0 + dy] = acc;
          }
  }
}

}  // namespace

// a: site tensors with (2, l, m) contiguous and stride_a elements between
// trajectories; b likewise (2, m, r); gate (4, 4) contiguous, stride_g
// elements (0 or 16) between trajectories' gates; out (batch, 2 l, 2 r)
extern "C" int bond_gate_launch(const void* a, long long stride_a, const void* b, long long stride_b,
                                const void* gate, long long stride_g, void* out, int batch, int l, int m, int r,
                                void* stream) {
  if (batch <= 0 || l <= 0 || m <= 0 || r <= 0 || l > kMaxChi || m > kMaxChi || r > kMaxChi ||
      (stride_g != 0 && stride_g != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float2) * 2 * (static_cast<size_t>(l) * m + static_cast<size_t>(m) * r);
  cudaError_t err = cudaFuncSetAttribute(bond_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bond_gate_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), stride_a, static_cast<const float2*>(b), stride_b,
      static_cast<const float2*>(gate), stride_g, static_cast<float2*>(out), l, m, r);
  return static_cast<int>(cudaGetLastError());
}
