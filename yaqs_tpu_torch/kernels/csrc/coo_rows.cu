// Kernel K23 (coo_rows): the observable rows of the sparse paths, every
// observable and every vector of a batch in one launch.
//
// Replaces: the sparse trace rows of yaqs_tpu/analog/lindblad.py
// lindblad_rk4_expectations (:189-211, `sum(data * rho[col, row])`) and the
// expectation rows of yaqs_tpu/analog/mcwf.py mcwf_trajectory_krylov
// (:136-141, `vdot(psi, o @ psi) / vdot(psi, psi)`).  Two modes, over the
// observables' COO entries (row, col, data), concatenated:
//   trace (0):       out[b, k] = Re sum_e data[e] x_b[col[e] * dim + row[e]]
//   expectation (1): out[b, k] = Re sum_e data[e] conj(x_b[row[e]]) x_b[col[e]]
//                                / sum_i |x_b[i]|^2
//
// What bounds it on the card: the bytes of the entries (read once for all B
// vectors) and of the vectors (each read once for its norm; the gathers go
// through L2).
//
// Design: the entries of each observable, and in mode 1 the n entries of
// the norm, are cut into chunks of 4096, one block a chunk; a thread keeps
// a double partial sum a vector over its 16 entries, the block adds them
// (shuffles, then shared memory) into one partial sum a (chunk, vector); the
// last block to finish adds each observable's chunks in chunk order and
// divides by the norm, so the rows do not depend on the order in which the
// blocks ran.

#include <cuda_runtime.h>

#include "complex.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;

template <typename C, int kB>
__global__ void __launch_bounds__(kThreads)
    coo_rows_kernel(const int* __restrict__ row, const int* __restrict__ col, const C* __restrict__ data,
                    const long long* __restrict__ offsets, const int* __restrict__ chunk_start, int n_obs,
                    const C* __restrict__ x, long long ldx, int nb, int mode, long long dim, long long n,
                    double* __restrict__ partial, unsigned* __restrict__ counter,
                    typename RealOf<C>::T* __restrict__ out) {
  using R = typename RealOf<C>::T;
  __shared__ double red[kWarps][kB];
  const int c = blockIdx.x;
  int lo = 0, hi = n_obs;  // the observable of chunk c: the last k with chunk_start[k] <= c (k = n_obs: the norm)
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (chunk_start[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  const int k = lo;
  double s[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) s[b] = 0.0;
  const long long first = static_cast<long long>(c - chunk_start[k]) * kChunk;
  if (k < n_obs) {
    const long long begin = offsets[k] + first;
    const long long end = min(offsets[k + 1], begin + kChunk);
    for (long long e = begin + threadIdx.x; e < end; e += kThreads) {
      const C a = data[e];
      const long long r = row[e], q = col[e];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (b >= nb) continue;
        const C* xb = x + b * ldx;
        if (mode == 0) {
          s[b] += re_mul(a, xb[q * dim + r]);
        } else {
          C bra = xb[r];
          bra.y = -bra.y;
          C t = czero<C>();
          t = cfma(a, xb[q], t);
          s[b] += re_mul(bra, t);
        }
      }
    }
  } else {
    const long long end = min(n, first + kChunk);
    for (long long i = first + threadIdx.x; i < end; i += kThreads) {
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (b >= nb) continue;
        const C v = x[b * ldx + i];
        s[b] += static_cast<double>(v.x) * v.x + static_cast<double>(v.y) * v.y;
      }
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const double t = group_sum(s[b], 32);
    if (lane == 0) red[warp][b] = t;
  }
  __syncthreads();
  if (threadIdx.x < kB) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
    partial[static_cast<long long>(c) * kB + threadIdx.x] = t;
  }
  if (!last_block_done(counter)) return;
  for (int pair = threadIdx.x; pair < n_obs * nb; pair += kThreads) {
    const int kk = pair / nb, b = pair % nb;
    double v = 0.0;
    for (int cc = chunk_start[kk]; cc < chunk_start[kk + 1]; ++cc) v += __ldcg(partial + static_cast<long long>(cc) * kB + b);
    if (mode == 1) {
      double nrm = 0.0;
      for (int cc = chunk_start[n_obs]; cc < chunk_start[n_obs + 1]; ++cc)
        nrm += __ldcg(partial + static_cast<long long>(cc) * kB + b);
      v /= nrm;
    }
    out[static_cast<long long>(b) * n_obs + kk] = static_cast<R>(v);
  }
}

template <typename C, int kB>
cudaError_t launch(const int* row, const int* col, const void* data, const long long* offsets, const int* chunk_start,
                   int n_obs, int chunks, const void* x, long long ldx, int nb, int mode, long long dim, long long n,
                   double* partial, unsigned* counter, void* out, cudaStream_t stream) {
  using R = typename RealOf<C>::T;
  coo_rows_kernel<C, kB><<<chunks, kThreads, 0, stream>>>(row, col, static_cast<const C*>(data), offsets,
                                                           chunk_start, n_obs, static_cast<const C*>(x), ldx, nb,
                                                           mode, dim, n, partial, counter, static_cast<R*>(out));
  return cudaGetLastError();
}

template <typename C>
cudaError_t dispatch(const int* row, const int* col, const void* data, const long long* offsets, const int* chunk_start,
                     int n_obs, int chunks, const void* x, long long ldx, int nb, int mode, long long dim, long long n,
                     double* partial, unsigned* counter, void* out, cudaStream_t s) {
  if (nb <= 1)
    return launch<C, 1>(row, col, data, offsets, chunk_start, n_obs, chunks, x, ldx, nb, mode, dim, n, partial,
                        counter, out, s);
  if (nb <= 4)
    return launch<C, 4>(row, col, data, offsets, chunk_start, n_obs, chunks, x, ldx, nb, mode, dim, n, partial,
                        counter, out, s);
  if (nb <= 16)
    return launch<C, 16>(row, col, data, offsets, chunk_start, n_obs, chunks, x, ldx, nb, mode, dim, n, partial,
                         counter, out, s);
  return launch<C, 32>(row, col, data, offsets, chunk_start, n_obs, chunks, x, ldx, nb, mode, dim, n, partial,
                       counter, out, s);
}

}  // namespace

// row, col (nnz) int32 and data (nnz): the observables' COO entries, one
// after the other; offsets (n_obs + 1) int64: observable k's entries;
// chunk_start (n_obs + 2) int32: observable k's chunks of 4096 entries,
// [chunk_start[n_obs], chunk_start[n_obs + 1]) the norm's (empty in mode
// 0), `chunks` = chunk_start[n_obs + 1]; x: nb vectors ldx elements apart,
// n entries each; partial (chunks, the template's vectors) doubles of
// scratch; counter: one unsigned, zero, left at zero; out (nb, n_obs) real;
// complex128 where dbl, else complex64.
extern "C" int coo_rows_launch(const void* row, const void* col, const void* data, const void* offsets,
                               const void* chunk_start, int n_obs, int chunks, const void* x, long long ldx, int nb,
                               int mode, long long dim, long long n, void* partial, void* counter, void* out, int dbl,
                               void* stream) {
  if (chunks <= 0 || nb <= 0 || nb > 32 || (mode != 0 && mode != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const int*>(row);
  const auto* c = static_cast<const int*>(col);
  const auto* off = static_cast<const long long*>(offsets);
  const auto* cs = static_cast<const int*>(chunk_start);
  auto* part = static_cast<double*>(partial);
  auto* cnt = static_cast<unsigned*>(counter);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dbl ? dispatch<double2>(r, c, data, off, cs, n_obs, chunks, x, ldx, nb, mode, dim, n, part, cnt, out, s)
          : dispatch<float2>(r, c, data, off, cs, n_obs, chunks, x, ldx, nb, mode, dim, n, part, cnt, out, s);
  return static_cast<int>(err);
}
