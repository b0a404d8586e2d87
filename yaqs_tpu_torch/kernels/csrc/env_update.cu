// Kernel K8: the MPO environment update of TDVP, per trajectory,
//   left:  F'[m, v, k] = sum conj(Ab[t, a, m]) W[t, s, w, v] Ak[s, b, k] F[a, w, b]
//   right: G'[a, w, b] = sum conj(Ab[t, a, m]) W[t, s, w, v] Ak[s, b, k] G[m, v, k]
// for environments (B, chi, Dw, chi), site tensors (B, d, chi, chi) and one
// MPO site W (d, d, Dw, Dw) shared by the batch.  The right update is the
// left one with the two bond indices of both site tensors and the two MPO
// bond indices exchanged, so one kernel runs both, reading A and W through
// exchanged strides.
//
// Replaces: yaqs_tpu/methods/tdvp.py update_left_env, update_right_env
// (:98-109) and the scan of right_environments (:112-129) (XLA chain K8): at
// L = 100 a sweep runs 297 of them.
//
// What bounds it on the card: operations.  2 d Dw chi^3 + d^2 Dw^2 chi^2
// complex MACs per trajectory (3.29 M at chi = 64, Dw = 3, d = 2; 0.84 GFLOP
// at B = 32, 12.6 us at 67 TFLOP/s fp32) against (2 Dw + 2 d) chi^2 complex
// values moved.  Eager PyTorch runs three products and writes both
// intermediates (chi^2 d Dw complex values each) to device memory.
//
// Design: grid (tiles of TK output columns k, B), 256 threads; the ket's TK
// columns and W are staged in shared memory.  (1) Each thread owns a row
// (a, w) of F, streams it once and keeps the d TK sums of
// T1[a, w, s, k] = sum_b F[a, w, b] Ak[s, b, k] in registers; (2) T2[a, t, v,
// k] = sum_(w, s) T1 W in shared memory; (3) each thread owns a row (m, v) of
// the output and sums conj(Ab[t, a, m]) T2[a, t, v, k] over (t, a), the
// conjugation applied as the bra is read.  The intermediates never leave the
// SM.  d = 2, chi <= 64, Dw <= 8; the output may be a view with any stride
// between trajectories, so right_environments writes in place.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChi = 64;
constexpr int kMaxDw = 8;
constexpr int kD = 2;
constexpr int kTK = 8;  // output columns per block

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

__global__ void __launch_bounds__(kThreads)
env_update_kernel(const float2* __restrict__ f, long long sf, const float2* __restrict__ ab, long long sab,
                  const float2* __restrict__ ak, long long sak, const float2* __restrict__ w,
                  float2* __restrict__ out, long long so, int chi, int dw, int right) {
  extern __shared__ float2 smem[];
  float2* as = smem;                       // (d, chi, TK): Ak(s, b, k0 + kk)
  float2* ws = as + kD * chi * kTK;        // (d, d, dw, dw)
  float2* t1 = ws + kD * kD * dw * dw;     // (chi dw, d, TK)
  float2* t2 = t1 + chi * dw * kD * kTK;   // (chi, d, dw, TK)

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kTK;
  const long long z = blockIdx.y;
  const float2* fz = f + z * sf;
  const float2* abz = ab + z * sab;
  const float2* akz = ak + z * sak;
  const int cc = chi * chi;
  // A(t, i, j) = A[t cc + i si + j sj]: the right update reads the transpose
  const int si = right ? 1 : chi;
  const int sj = right ? chi : 1;

  for (int e = tid; e < kD * chi * kTK; e += kThreads) {
    const int kk = e % kTK;
    const int bb = (e / kTK) % chi;
    const int s = e / (kTK * chi);
    as[e] = k0 + kk < chi ? akz[static_cast<size_t>(s) * cc + bb * si + (k0 + kk) * sj] : make_float2(0.f, 0.f);
  }
  for (int e = tid; e < kD * kD * dw * dw; e += kThreads) {
    const int v = e % dw;
    const int wl = (e / dw) % dw;
    const int ts = e / (dw * dw);
    ws[e] = right ? w[(ts * dw + v) * dw + wl] : w[e];  // W(t, s, wl, v)
  }
  __syncthreads();

  // (1) T1[(a, w), s, kk] = sum_b F[a, w, b] Ak(s, b, k0 + kk)
  for (int row = tid; row < chi * dw; row += kThreads) {
    float2 acc[kD * kTK];
#pragma unroll
    for (int r = 0; r < kD * kTK; ++r) acc[r] = make_float2(0.f, 0.f);
    const float2* frow = fz + static_cast<size_t>(row) * chi;
    for (int b = 0; b < chi; ++b) {
      const float2 fv = frow[b];
#pragma unroll
      for (int s = 0; s < kD; ++s)
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) cfma(acc[s * kTK + kk], fv, as[(s * chi + b) * kTK + kk]);
    }
#pragma unroll
    for (int r = 0; r < kD * kTK; ++r) t1[row * kD * kTK + r] = acc[r];
  }
  __syncthreads();

  // (2) T2[a, t, v, kk] = sum_(w, s) T1[(a, w), s, kk] W(t, s, w, v)
  for (int e = tid; e < chi * kD * dw * kTK; e += kThreads) {
    const int kk = e % kTK;
    const int v = (e / kTK) % dw;
    const int t = (e / (kTK * dw)) % kD;
    const int a = e / (kTK * dw * kD);
    float2 acc = make_float2(0.f, 0.f);
    for (int wl = 0; wl < dw; ++wl)
#pragma unroll
      for (int s = 0; s < kD; ++s)
        cfma(acc, t1[((a * dw + wl) * kD + s) * kTK + kk], ws[((t * kD + s) * dw + wl) * dw + v]);
    t2[e] = acc;
  }
  __syncthreads();

  // (3) out[m, v, k0 + kk] = sum_(t, a) conj(Ab(t, a, m)) T2[a, t, v, kk]
  float2* oz = out + z * so;
  for (int item = tid; item < chi * dw; item += kThreads) {
    const int m = item % chi;
    const int v = item / chi;
    float2 acc[kTK];
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) acc[kk] = make_float2(0.f, 0.f);
    for (int t = 0; t < kD; ++t) {
      for (int a = 0; a < chi; ++a) {
        const float2 bv = abz[static_cast<size_t>(t) * cc + a * si + m * sj];
        const float2* t2row = t2 + ((a * kD + t) * dw + v) * kTK;
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) cfma_conj(acc[kk], bv, t2row[kk]);
      }
    }
    float2* orow = oz + (static_cast<size_t>(m) * dw + v) * chi + k0;
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk)
      if (k0 + kk < chi) orow[kk] = acc[kk];
  }
}

size_t smem_bytes(int chi, int dw) {
  return sizeof(float2) *
         (static_cast<size_t>(kD) * chi * kTK + kD * kD * dw * dw + 2 * static_cast<size_t>(chi) * dw * kD * kTK);
}

}  // namespace

// f: (chi, dw, chi) per trajectory, stride sf; a_bra / a_ket: (2, chi, chi)
// per trajectory, strides sab / sak (the bra is conjugated here); w: (2, 2,
// dw, dw); out: (chi, dw, chi) per trajectory, stride so.  right = 0 runs
// update_left_env, right = 1 update_right_env.
extern "C" int env_update_launch(const void* f, long long sf, const void* a_bra, long long sab, const void* a_ket,
                                 long long sak, const void* w, void* out, long long so, int batch, int chi, int dw,
                                 int right, void* stream) {
  if (batch <= 0 || batch > 65535 || chi <= 0 || chi > kMaxChi || dw <= 0 || dw > kMaxDw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t configured = cudaFuncSetAttribute(
      env_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes(kMaxChi, kMaxDw)));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((chi + kTK - 1) / kTK, batch);
  env_update_kernel<<<grid, kThreads, smem_bytes(chi, dw), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(f), sf, static_cast<const float2*>(a_bra), sab, static_cast<const float2*>(a_ket),
      sak, static_cast<const float2*>(w), static_cast<float2*>(out), so, chi, dw, right);
  return static_cast<int>(cudaGetLastError());
}
