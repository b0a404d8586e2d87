// Kernel K1 (recurrence): one iteration j of the fixed-k Lanczos loop, per
// trajectory, after the matvec w = A q:
//   alpha = Re <q, w>;
//   reorth:     two classical Gram-Schmidt passes of w against basis rows 0..j
//   otherwise:  w -= alpha q + beta_prev q_prev;
//   beta = ||w||;  alive' = alive & (beta > tol);
//   q_next = alive' ? w / beta : 0;  alphas[j] = alive ? alpha : 0;
//   betas[j] = alive' ? beta : 0;  basis row j + 1 = q_next (when j + 1 < k);
//   beta_prev = beta;  alive = alive'.
// The per-trajectory scalars stay on the card, so the loop never waits for
// the host.
//
// Replaces: the body of the fori_loop of yaqs_tpu/ops/krylov.py
// lanczos_expm_apply (:74-92), which eager PyTorch runs as about 20
// elementwise and reduction launches per iteration (XLA chain K1 with the
// matvec of heff.cu).
//
// What bounds it on the card: device memory.  The three-term step reads q,
// q_prev and w and writes w, q_next and the basis row: six vectors of n
// complex64 (about 5 of them at the bytes the bound counts); the
// reorthogonalizing step also reads the j + 1 basis rows twice.  About 6 us
// at B = 32, n = 16384 and 3.35 TB/s for the three-term step.
//
// Design: one block of 512 threads per trajectory, each pass over the
// vector coalesced; block reductions (warp shuffles, then one value per
// warp in shared memory) finish each pass, eight projections at a time.  w
// is overwritten with the orthogonalized vector.  k <= 64.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr int kChunk = 8;  // projections reduced together

// Sums each of v[0..NV) over the block; every thread gets the totals.
// red holds kWarps * NV floats and out NV floats of shared memory.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red, float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) red[warp * NV + i] = v[i];
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = out[i];
}

// proj[i] = <V[i], w> for rows i < rows of the basis, eight at a time.
__device__ void project(const float2* __restrict__ vb, const float2* w, int rows, int n, float* red, float* tot,
                        float2* proj) {
  for (int c0 = 0; c0 < rows; c0 += kChunk) {
    float acc[2 * kChunk];
#pragma unroll
    for (int i = 0; i < 2 * kChunk; ++i) acc[i] = 0.f;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const float2 wv = w[e];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        if (c0 + r < rows) {
          const float2 vv = vb[static_cast<size_t>(c0 + r) * n + e];
          acc[2 * r] += vv.x * wv.x + vv.y * wv.y;  // conj(v) w
          acc[2 * r + 1] += vv.x * wv.y - vv.y * wv.x;
        }
      }
    }
    block_sum<2 * kChunk>(acc, red, tot);
    if (threadIdx.x < kChunk && c0 + threadIdx.x < rows) {
      proj[c0 + threadIdx.x] = make_float2(acc[2 * threadIdx.x], acc[2 * threadIdx.x + 1]);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
lanczos_step_kernel(float2* __restrict__ w, const float2* __restrict__ q, const float2* __restrict__ q_prev,
                    float2* __restrict__ basis, float* __restrict__ alphas, float* __restrict__ betas,
                    float* __restrict__ beta_prev, unsigned char* __restrict__ alive, float2* __restrict__ q_next,
                    int k, int n, int j, int reorth, float tol) {
  __shared__ float red[kWarps * 2 * kChunk];
  __shared__ float tot[2 * kChunk];
  __shared__ float2 proj[kMaxK];

  const long long z = blockIdx.x;
  float2* wz = w + z * n;
  const float2* qz = q + z * n;
  const float2* qpz = q_prev + z * n;
  float2* vz = basis + z * static_cast<long long>(k) * n;
  float2* qnz = q_next + z * n;
  const bool alive_in = alive[z] != 0;
  const float bprev = beta_prev[z];

  float s1[1] = {0.f};
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float2 a = qz[e], b = wz[e];
    s1[0] += a.x * b.x + a.y * b.y;  // Re conj(q) w
  }
  block_sum<1>(s1, red, tot);
  const float alpha = s1[0];

  float s2[1] = {0.f};
  if (reorth) {
    const int rows = j + 1;  // rows beyond j are zero
    for (int pass = 0; pass < 2; ++pass) {
      project(vz, wz, rows, n, red, tot, proj);
      for (int e = threadIdx.x; e < n; e += kThreads) {
        float2 sum = make_float2(0.f, 0.f);
        for (int r = 0; r < rows; ++r) {
          const float2 p = proj[r], vv = vz[static_cast<size_t>(r) * n + e];
          sum.x += p.x * vv.x - p.y * vv.y;
          sum.y += p.x * vv.y + p.y * vv.x;
        }
        float2 wv = wz[e];
        wv.x -= sum.x;
        wv.y -= sum.y;
        wz[e] = wv;
        if (pass == 1) s2[0] += wv.x * wv.x + wv.y * wv.y;
      }
      __syncthreads();
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const float2 a = qz[e], p = qpz[e];
      float2 wv = wz[e];
      wv.x = wv.x - alpha * a.x - bprev * p.x;
      wv.y = wv.y - alpha * a.y - bprev * p.y;
      wz[e] = wv;
      s2[0] += wv.x * wv.x + wv.y * wv.y;
    }
  }
  block_sum<1>(s2, red, tot);
  const float beta = sqrtf(s2[0]);
  const bool alive_next = alive_in && beta > tol;
  const float inv = alive_next ? 1.f / beta : 0.f;
  float2* vnext = j + 1 < k ? vz + static_cast<size_t>(j + 1) * n : nullptr;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float2 wv = wz[e];
    const float2 out = alive_next ? make_float2(wv.x * inv, wv.y * inv) : make_float2(0.f, 0.f);
    qnz[e] = out;
    if (vnext) vnext[e] = out;
  }
  if (threadIdx.x == 0) {
    alphas[z * k + j] = alive_in ? alpha : 0.f;
    betas[z * k + j] = alive_next ? beta : 0.f;
    beta_prev[z] = beta;
    alive[z] = alive_next ? 1 : 0;
  }
}

}  // namespace

// w (batch, n): the matvec's output, overwritten; q, q_prev, q_next (batch,
// n); basis (batch, k, n); alphas, betas (batch, k) float; beta_prev (batch,)
// float; alive (batch,) bool; all contiguous.
extern "C" int lanczos_step_launch(void* w, const void* q, const void* q_prev, void* basis, void* alphas,
                                   void* betas, void* beta_prev, void* alive, void* q_next, int batch, int k, int n,
                                   int j, int reorth, float tol, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK || n <= 0 || j < 0 || j >= k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lanczos_step_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(w), static_cast<const float2*>(q), static_cast<const float2*>(q_prev),
      static_cast<float2*>(basis), static_cast<float*>(alphas), static_cast<float*>(betas),
      static_cast<float*>(beta_prev), static_cast<unsigned char*>(alive), static_cast<float2*>(q_next), k, n, j,
      reorth, tol);
  return static_cast<int>(cudaGetLastError());
}
