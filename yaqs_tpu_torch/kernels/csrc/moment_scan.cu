// Kernel K7: gauge-free per-site moment matrices of a batch of MPS,
//   T[b, i, s, k] = <psi_b| (|s><k|)_i |psi_b>,  norm2[b] = <psi_b|psi_b>,
// for tensors (B, L, d, chi, chi) complex64 in any gauge and norm.
//
// Replaces: yaqs_tpu/core/mps_ops.py left_gram_environments,
// right_gram_environments, transfer_right and site_moment_matrices (the XLA
// chain K7, mps_ops.py:369-414).  On the digital path it feeds the per-gate
// jump weights (B = 512, L = 20, chi = 32); on the analog path the jump
// sampler and the gauge-free observables (B = 32, L = 100, chi = 64).
//
// What it computes, exactly as mps_ops.py: a left Gram scan
//   E_0 = 1,  E_{i+1}[rb, rk] = sum conj(A_i[s, lb, rb]) E_i[lb, lk] A_i[s, lk, rk],
// a right Gram scan
//   R_{L-1} = 1,  R_{i-1}[l, m] = sum conj(A_i[s, l, r]) A_i[s, m, t] R_i[r, t],
// then T_i[s, k] = sum conj(A_i[s, l, r]) (E_i A_i[k] R_i^T)[l, r] and
// norm2 = trace(E_L).
//
// What bounds it on the card: arithmetic.  Each scan step is two complex
// products of d chi^3 multiply-adds, each moment 2 d chi^3 more, so
// 6 d chi^3 complex MACs (8 real flops each) per site and trajectory:
// 81 GFLOP at the analog shape (1.2 ms at 67 TFLOP/s fp32) and 32 GFLOP at
// the digital one (0.48 ms).  The state is read
// three times (once per scan, once by the moment pass) and the environments
// written once and read once.  Eager PyTorch runs the scans as 4 L small
// batched products with their permute copies, a few hundred launches.
//
// Design: two launches.  (1) gram_scan_kernel, grid (B, 2): one block per
// trajectory and direction walks the chain, keeping the chi x chi
// environment, the site tensor and the d chi x chi intermediate in shared
// memory (dynamic above 48 KB: 160 KB at chi = 64), and writes each
// environment to a scratch buffer the wrapper allocates.  The scans are
// sequential over sites, so only 2 B blocks run; splitting a step over a
// cluster is the next step for speed.  (2) moments_kernel, grid (L, B): one
// block per site and trajectory loads E_i, R_i and A_i, forms P = E_i A_i[k]
// in shared memory, and folds the conjugated bra tensor into the epilogue of
// P R_i^T, so Q is never stored; a warp-shuffle reduction then writes T.
// Products use a 4x4 register micro-tile of complex outputs per thread with
// plain FP32 FMAs (TF32 off).  The chain's chi is a template parameter for
// 32 and 64 (index divisions become shifts) with a generic fallback.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChi = 64;
constexpr int kMaxD = 4;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float2 conj2(float2 a) { return make_float2(a.x, -a.y); }

// C(i, j) = sum_k A(i, k) B(k, j) for i < M, j < N, k < K.  Each thread owns a
// 4x4 micro-tile whose rows and columns are strided by a quarter of M and N;
// a(i, k) and b(k, j) read the operands, epi(i, j, value) consumes each
// output in the thread that computed it.
template <typename FA, typename FB, typename Epi>
__device__ __forceinline__ void tile_matmul(int M, int N, int K, FA a, FB b, Epi epi) {
  const int tm = (M + 3) / 4;
  const int tn = (N + 3) / 4;
  for (int t = threadIdx.x; t < tm * tn; t += blockDim.x) {
    const int it = t / tn;
    const int jt = t % tn;
    float2 acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = make_float2(0.f, 0.f);
    for (int k = 0; k < K; ++k) {
      float2 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = it + r * tm;
        av[r] = i < M ? a(i, k) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jt + c * tn;
        bv[c] = j < N ? b(k, j) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) cfma(acc[r][c], av[r], bv[c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = it + r * tm;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jt + c * tn;
        if (i < M && j < N) epi(i, j, acc[r][c]);
      }
    }
  }
}

// envs: (2, B, L, chi, chi), direction-major; norm2: (B,)
template <int CHI>
__global__ void __launch_bounds__(kThreads)
gram_scan_kernel(const float2* __restrict__ t, float2* __restrict__ envs, float* __restrict__ norm2,
                 int L, int d, int chi_arg) {
  extern __shared__ float2 smem[];
  const int chi = CHI > 0 ? CHI : chi_arg;
  const int cc = chi * chi;
  float2* senv = smem;             // chi x chi
  float2* ssite = senv + cc;       // d x chi x chi
  float2* stmp = ssite + d * cc;   // d x chi x chi
  const int b = blockIdx.x;
  const bool left = blockIdx.y == 0;
  const size_t site_elems = static_cast<size_t>(d) * cc;
  const float2* tb = t + static_cast<size_t>(b) * L * site_elems;
  float2* eb = envs + (static_cast<size_t>(blockIdx.y) * gridDim.x + b) * L * cc;

  for (int e = threadIdx.x; e < cc; e += blockDim.x) {
    senv[e] = make_float2(e / chi == e % chi ? 1.f : 0.f, 0.f);
  }
  __syncthreads();
  for (int step = 0; step < L; ++step) {
    const int i = left ? step : L - 1 - step;
    for (int e = threadIdx.x; e < cc; e += blockDim.x) eb[static_cast<size_t>(i) * cc + e] = senv[e];
    for (int e = threadIdx.x; e < site_elems; e += blockDim.x) ssite[e] = tb[i * site_elems + e];
    __syncthreads();
    if (left) {
      // tmp[s, lb, rk] = sum_lk E[lb, lk] A[s, lk, rk]; columns j = (s, rk)
      tile_matmul(
          chi, d * chi, chi, [&](int lb, int lk) { return senv[lb * chi + lk]; },
          [&](int lk, int j) { return ssite[(j / chi) * cc + lk * chi + j % chi]; },
          [&](int lb, int j, float2 v) { stmp[(j / chi) * cc + lb * chi + j % chi] = v; });
      __syncthreads();
      // E'[rb, rk] = sum_(s, lb) conj(A[s, lb, rb]) tmp[s, lb, rk]; k = s chi + lb
      tile_matmul(
          chi, chi, d * chi, [&](int rb, int k) { return conj2(ssite[k * chi + rb]); },
          [&](int k, int rk) { return stmp[k * chi + rk]; },
          [&](int rb, int rk, float2 v) { senv[rb * chi + rk] = v; });
    } else {
      // tmp[s, m, r] = sum_t A[s, m, t] R[r, t]; rows (s, m)
      tile_matmul(
          d * chi, chi, chi, [&](int sm, int tt) { return ssite[sm * chi + tt]; },
          [&](int tt, int r) { return senv[r * chi + tt]; },
          [&](int sm, int r, float2 v) { stmp[sm * chi + r] = v; });
      __syncthreads();
      // R'[l, m] = sum_(s, r) conj(A[s, l, r]) tmp[s, m, r]; k = s chi + r
      tile_matmul(
          chi, chi, d * chi,
          [&](int l, int k) { return conj2(ssite[(k / chi) * cc + l * chi + k % chi]); },
          [&](int k, int m) { return stmp[(k / chi) * cc + m * chi + k % chi]; },
          [&](int l, int m, float2 v) { senv[l * chi + m] = v; });
    }
    __syncthreads();
  }
  if (left && threadIdx.x == 0) {
    float tr = 0.f;
    for (int e = 0; e < chi; ++e) tr += senv[e * chi + e].x;
    norm2[b] = tr;
  }
}

// T: (B, L, d, d)
template <int CHI>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const float2* __restrict__ t, const float2* __restrict__ envs, float2* __restrict__ out,
               int B, int L, int d, int chi_arg) {
  extern __shared__ float2 smem[];
  __shared__ float2 red[kWarps][kMaxD];
  const int chi = CHI > 0 ? CHI : chi_arg;
  const int cc = chi * chi;
  float2* sl = smem;            // E_i
  float2* sr = sl + cc;         // R_i
  float2* sp = sr + cc;         // E_i A_i[k]
  float2* ssite = sp + cc;      // A_i
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const size_t site_elems = static_cast<size_t>(d) * cc;
  const float2* left = envs + (static_cast<size_t>(b) * L + i) * cc;
  const float2* right = envs + ((static_cast<size_t>(B) + b) * L + i) * cc;
  const float2* site = t + (static_cast<size_t>(b) * L + i) * site_elems;
  for (int e = threadIdx.x; e < cc; e += blockDim.x) {
    sl[e] = left[e];
    sr[e] = right[e];
  }
  for (int e = threadIdx.x; e < site_elems; e += blockDim.x) ssite[e] = site[e];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int k = 0; k < d; ++k) {
    // P[l, s] = sum_m E[l, m] A[k, m, s]
    tile_matmul(
        chi, chi, chi, [&](int l, int m) { return sl[l * chi + m]; },
        [&](int m, int s) { return ssite[k * cc + m * chi + s]; },
        [&](int l, int s, float2 v) { sp[l * chi + s] = v; });
    __syncthreads();
    // T[bb, k] = sum_(l, r) conj(A[bb, l, r]) (P R^T)[l, r]
    float2 part[kMaxD];
#pragma unroll
    for (int bb = 0; bb < kMaxD; ++bb) part[bb] = make_float2(0.f, 0.f);
    tile_matmul(
        chi, chi, chi, [&](int l, int s) { return sp[l * chi + s]; },
        [&](int s, int r) { return sr[r * chi + s]; },
        [&](int l, int r, float2 v) {
#pragma unroll
          for (int bb = 0; bb < kMaxD; ++bb) {
            if (bb < d) cfma(part[bb], conj2(ssite[bb * cc + l * chi + r]), v);
          }
        });
#pragma unroll
    for (int bb = 0; bb < kMaxD; ++bb) {
      float x = part[bb].x, y = part[bb].y;
      for (int off = 16; off > 0; off >>= 1) {
        x += __shfl_down_sync(0xffffffffu, x, off);
        y += __shfl_down_sync(0xffffffffu, y, off);
      }
      if (lane == 0) red[warp][bb] = make_float2(x, y);
    }
    __syncthreads();
    if (threadIdx.x < d) {
      const int bb = threadIdx.x;
      float2 acc = make_float2(0.f, 0.f);
      for (int w = 0; w < kWarps; ++w) {
        acc.x += red[w][bb].x;
        acc.y += red[w][bb].y;
      }
      out[((static_cast<size_t>(b) * L + i) * d + bb) * d + k] = acc;
    }
    __syncthreads();  // sp and red are rewritten for the next k
  }
}

template <int CHI>
cudaError_t launch_chi(const float2* t, float2* envs, float2* out, float* norm2, int batch, int L, int d,
                       int chi, cudaStream_t stream) {
  const size_t cc = static_cast<size_t>(chi) * chi;
  const size_t scan_smem = sizeof(float2) * (1 + 2 * static_cast<size_t>(d)) * cc;
  const size_t mom_smem = sizeof(float2) * (3 + static_cast<size_t>(d)) * cc;
  cudaError_t err = cudaFuncSetAttribute(gram_scan_kernel<CHI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(scan_smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(moments_kernel<CHI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(mom_smem));
  if (err != cudaSuccess) return err;
  gram_scan_kernel<CHI><<<dim3(batch, 2), kThreads, scan_smem, stream>>>(t, envs, norm2, L, d, chi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moments_kernel<CHI><<<dim3(L, batch), kThreads, mom_smem, stream>>>(t, envs, out, batch, L, d, chi);
  return cudaGetLastError();
}

}  // namespace

// t (B, L, d, chi, chi), envs scratch (2, B, L, chi, chi), out (B, L, d, d),
// norm2 (B,) float
extern "C" int moment_scan_launch(const void* t, void* envs, void* out, void* norm2, int batch, int L, int d,
                                  int chi, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || d <= 0 || d > kMaxD || chi <= 0 || chi > kMaxChi) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* tp = static_cast<const float2*>(t);
  auto* ep = static_cast<float2*>(envs);
  auto* op = static_cast<float2*>(out);
  auto* np = static_cast<float*>(norm2);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (chi == 64) {
    err = launch_chi<64>(tp, ep, op, np, batch, L, d, chi, st);
  } else if (chi == 32) {
    err = launch_chi<32>(tp, ep, op, np, batch, L, d, chi, st);
  } else {
    err = launch_chi<0>(tp, ep, op, np, batch, L, d, chi, st);
  }
  return static_cast<int>(err);
}
