// Kernel K20 (masked_qr): BUG's rank-masked thin Householder QR of a batch
// of complex64 (n, k) blocks, one thread block a block.
//
// Replaces: yaqs_tpu/methods/bug.py _masked_qr (:35-46), the L->R prep of
// bug_step (one launch a site: (B, d chi, chi) = (32, 64, 32) at chi = 32).
// It computes m = Q R with LAPACK's conventions and no noise floor (K14's
// blocked compact-WY body, householder.cuh), then with
//   tol = max_j |R[j, j]| * eps32 * n * 10
// zeroes Q's column j and R's row j wherever |R[j, j]| <= tol.  A floor, as
// K14 adds, would lift every |R[j, j]| above tol and defeat the mask; a
// zero column takes tau = 0 and R[j, j] = 0, never a division by zero.
//
// What bounds it on the card: latency, as K14 (the k column steps are
// sequential); a (64, 32) block is 2 * 16 KB of traffic and about 0.1 M
// complex MACs with Q.
//
// Design: K14's with the floor left out of the load and the mask applied as
// Q and R are written (the diagonal read from shared memory by every
// thread, the largest |R[j, j]| by each thread over k values).

#include <cuda_runtime.h>

#include "householder.cuh"
#include "launch.cuh"

namespace {

constexpr int kMaxRows = 128;
constexpr int kMaxCols = 64;
constexpr float kEps32 = 1.1920928955078125e-07f;

__host__ __device__ constexpr size_t smem_bytes(int n, int k) {
  const int lda = n + 1;
  return sizeof(float2) * (2 * static_cast<size_t>(k) * lda + householder_scratch(lda, k));
}

template <int kQ>
__global__ void __launch_bounds__(kThreads, 8 / kQ)
    masked_qr_kernel(const float2* __restrict__ in, long long stride_in, float2* __restrict__ q_out,
                     float2* __restrict__ r_out, int n, int k) {
  extern __shared__ float2 smem[];
  const int lda = n + 1;
  float2* sa = smem;
  float2* sq = sa + k * lda;
  float2* sy = sq + k * lda;
  float2* st = sy + kNb * lda;
  float2* sw = st + ((k + kNb - 1) / kNb) * kNb * kNb;
  float2* sw2 = sw + kNb * k;
  float2* stau = sw2 + kNb * k;
  float2* sdiag = stau + k;
  const float2* src = in + blockIdx.x * stride_in;
  const int nk = n * k;
  for (int e = threadIdx.x; e < nk; e += kThreads) sa[(e % k) * lda + e / k] = src[e];
  __syncthreads();
  householder_factor<kQ>(sa, lda, sq, sy, st, sw, sw2, stau, sdiag, n, k, true);

  float dmax = 0.f;
  for (int j = 0; j < k; ++j) dmax = fmaxf(dmax, fabsf(sdiag[j].x));
  const float tol = dmax * kEps32 * n * 10.f;
  float2* q = q_out + static_cast<long long>(blockIdx.x) * nk;
  for (int e = threadIdx.x; e < nk; e += kThreads) {
    const int c = e % k;
    q[e] = fabsf(sdiag[c].x) > tol ? sq[c * lda + e / k] : make_float2(0.f, 0.f);
  }
  float2* r = r_out + static_cast<long long>(blockIdx.x) * k * k;
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    const int i = e / k, c = e % k;
    const float2 v = c > i ? sa[c * lda + i] : (c == i ? sdiag[i] : make_float2(0.f, 0.f));
    r[e] = fabsf(sdiag[i].x) > tol ? v : make_float2(0.f, 0.f);
  }
}

}  // namespace

// in: batch row-major (n, k) blocks, stride_in elements apart; q_out (batch,
// n, k) and r_out (batch, k, k), contiguous.
extern "C" int masked_qr_launch(const void* in, long long stride_in, void* q_out, void* r_out, int batch, int n, int k,
                                void* stream) {
  if (batch <= 0 || k <= 0 || n < k || n > kMaxRows || k > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, k);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = n <= 64 ? masked_qr_kernel<2> : masked_qr_kernel<4>;
  cudaError_t err = allow_smem(kernel, smem_bytes(kMaxRows, kMaxCols));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), stride_in, static_cast<float2*>(q_out), static_cast<float2*>(r_out), n, k);
  return static_cast<int>(cudaGetLastError());
}
