// Kernel K22 (lindblad_step): one step of the dense Lindblad route,
// v' = P v with the step propagator P = expm(L dt) (n x n, n = dim^2 <=
// 4096), and the trace rows of the new density matrix in the same launch.
//
// Replaces: the step of yaqs_tpu/analog/lindblad.py lindblad_expectations
// (:266-273, `prop_j @ vec_rho` and `einsum("kab,ba->k", obs, rho)`) and the
// simulator's numpy loop (yaqs_tpu/simulator.py:676-683).  With P absent it
// copies v and reads its rows (the t = 0 column).
//
// Rows: rows[k] = Re sum_{a,b} O_k[a, b] rho'[b, a] = Re sum_m Ot[k, m] v'[m]
// with Ot[k] = O_k^T flattened (the caller's table, n_obs x n).
//
// What bounds it on the card: P's bytes, read once (268 MB in complex128 at
// n = 4096, 0.08 ms at 3.35 TB/s; half in complex64).  Read by every warp
// from L2, v would move as many bytes from L2 to the SMs as P does; the
// block stages it in shared memory once where it fits (up to 96 KB: n <=
// 6144 in complex128, 12288 in complex64).
//
// Design: a warp a row of P (coalesced, four loads in flight a lane),
// sixteen rows a block; the block keeps its sixteen v' values in shared
// memory and multiplies them by the matching slice of Ot, one partial sum a
// row of the table; the last block to finish (an atomic ticket after a
// fence) adds the blocks' partial sums in block order, so the rows do not
// depend on which block finished first.

#include <cuda_runtime.h>

#include "complex.cuh"
#include "launch.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;
constexpr size_t kStageBytes = 96 * 1024;  // v staged in shared memory up to this size

template <typename C, bool kStage>
__global__ void __launch_bounds__(kThreads)
    lindblad_step_kernel(const C* __restrict__ p, const C* __restrict__ v_in, C* __restrict__ v_out, int n,
                         const C* __restrict__ obs_t, int n_obs, double* __restrict__ partial,
                         unsigned* __restrict__ counter, typename RealOf<C>::T* __restrict__ rows) {
  using R = typename RealOf<C>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ C ys[kWarps];
  const C* v = v_in;
  if (kStage) {
    C* vs = reinterpret_cast<C*>(smem_raw);
    for (int j = threadIdx.x; j < n; j += kThreads) vs[j] = v_in[j];
    __syncthreads();
    v = vs;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  C y = czero<C>();
  if (row < n) {
    if (p == nullptr) {
      y = v[row];
    } else {
      const C* prow = p + static_cast<long long>(row) * n;
      C s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[u] = czero<C>();
      int j = lane;
      for (; j + 32 * (kUnroll - 1) < n; j += 32 * kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) s[u] = cfma(prow[j + 32 * u], v[j + 32 * u], s[u]);
      }
      for (; j < n; j += 32) s[0] = cfma(prow[j], v[j], s[0]);
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) {
        s[0].x += s[u].x;
        s[0].y += s[u].y;
      }
      y.x = group_sum(s[0].x, 32);
      y.y = group_sum(s[0].y, 32);
    }
    if (lane == 0) v_out[row] = y;
  }
  if (lane == 0) ys[warp] = y;
  __syncthreads();
  const int row0 = blockIdx.x * kWarps;
  for (int k = threadIdx.x; k < n_obs; k += kThreads) {
    double s = 0.0;
    for (int w = 0; w < kWarps && row0 + w < n; ++w) s += re_mul(obs_t[static_cast<long long>(k) * n + row0 + w], ys[w]);
    partial[static_cast<long long>(blockIdx.x) * n_obs + k] = s;
  }
  if (!last_block_done(counter)) return;
  for (int k = threadIdx.x; k < n_obs; k += kThreads) {
    double s = 0.0;
    for (int blk = 0; blk < static_cast<int>(gridDim.x); ++blk) s += __ldcg(partial + static_cast<long long>(blk) * n_obs + k);
    rows[k] = static_cast<R>(s);
  }
}

template <typename C>
cudaError_t launch(const void* p, const void* v, void* v_out, int n, const void* obs_t, int n_obs, double* partial,
                   unsigned* counter, void* rows, int blocks, cudaStream_t stream) {
  using R = typename RealOf<C>::T;
  const size_t stage = static_cast<size_t>(n) * sizeof(C);
  const auto* pc = static_cast<const C*>(p);
  const auto* vc = static_cast<const C*>(v);
  const auto* oc = static_cast<const C*>(obs_t);
  auto* out = static_cast<C*>(v_out);
  auto* r = static_cast<R*>(rows);
  if (p != nullptr && stage <= kStageBytes) {
    const cudaError_t err = allow_smem(lindblad_step_kernel<C, true>, kStageBytes);
    if (err != cudaSuccess) return err;
    lindblad_step_kernel<C, true><<<blocks, kThreads, stage, stream>>>(pc, vc, out, n, oc, n_obs, partial, counter, r);
  } else {
    lindblad_step_kernel<C, false><<<blocks, kThreads, 0, stream>>>(pc, vc, out, n, oc, n_obs, partial, counter, r);
  }
  return cudaGetLastError();
}

}  // namespace

// p (n, n) row-major or null (v' = v); v, v_out (n); obs_t (n_obs, n);
// partial: (ceil(n / 16), n_obs) doubles of scratch; counter: one unsigned,
// zero, left at zero; rows (n_obs) real; complex128 where dbl, else
// complex64.
extern "C" int lindblad_step_launch(const void* p, const void* v, void* v_out, int n, const void* obs_t, int n_obs,
                                    void* partial, void* counter, void* rows, int dbl, void* stream) {
  if (n <= 0 || n_obs < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<double*>(partial);
  auto* cnt = static_cast<unsigned*>(counter);
  return static_cast<int>(
      dbl ? launch<double2>(p, v, v_out, n, obs_t, n_obs, part, cnt, rows, blocks, s)
          : launch<float2>(p, v, v_out, n, obs_t, n_obs, part, cnt, rows, blocks, s));
}
