// Kernel K21 (csr_spmm): a complex CSR matrix times B vectors, with the
// RK4 stage's vector updates fused into the same pass.
//
// Replaces: the sparse Liouvillian matvec inside the RK4 substeps of
// yaqs_tpu/analog/lindblad.py lindblad_rk4_expectations (:182-187, :214-219;
// a real/imaginary BCOO split there, complex CSR here), and the BCOO H_eff
// and jump-operator matvecs of yaqs_tpu/analog/mcwf.py mcwf_trajectory_krylov
// (:145, :159), over B trajectories at once.
//
// For each row r and vector b (y = A x):
//   out1[b, r] = base[b, r] + c1 * y[b, r]   (base absent: 0; out1 optional)
//   acc[b, r] = acc_in[b, r] + c2 * y[b, r]  (optional; acc_in absent: acc)
// An RK4 substep v' = v + h/6 (k1 + 2 k2 + 2 k3 + k4) is four launches:
// x = v, out1 = v + h/2 k1, acc = v + h/6 k1 (acc_in = v); then x = that
// stage vector, out1 = v + h/2 k2, acc += h/3 k2; then v + h k3, acc += h/3
// k3; then acc += h/6 k4, no out1.  The stage's input is written by the
// previous pass's epilogue, so each pass gathers one vector; no launch
// writes a vector it gathers from (the caller swaps two stage buffers).
//
// What bounds it on the card: the bytes.  The matrix (16 or 8 bytes a value,
// 4 a column, 4 a row pointer) streams from device memory once a launch
// whatever B is; the gathered vectors (16 MB at the L = 10 Liouvillian in
// complex128, 8 MB a trajectory at the L = 20 H_eff in complex64) are read
// through L2.  Rows hold about 21-24 nonzeros at these sizes.
//
// Design: a group of 8 lanes a row, 32 rows a block of 256 threads.  The
// lanes of a group read consecutive nonzeros (values and columns once for
// all B vectors of the launch), each lane keeps a partial sum per vector in
// registers (B <= 32 a launch, the template's kB the next power of two), the
// group adds them by shuffles, and the epilogue writes out1 and acc, vector
// b by lane b mod 8.  Complex64 and complex128 are two instantiations.

#include <cuda_runtime.h>

#include "complex.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;
constexpr int kRowsPerBlock = kThreads / kGroup;

template <typename C, int kB>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_kernel(const int* __restrict__ crow, const int* __restrict__ col, const C* __restrict__ val, int n_rows,
                    const C* __restrict__ x, long long ldx, const C* __restrict__ base, long long ldb,
                    typename RealOf<C>::T c1, C* __restrict__ out1, long long ldo, const C* acc_in,
                    long long ldai, C* acc, long long lda, typename RealOf<C>::T c2, int nb) {
  const int lane = threadIdx.x % kGroup;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kGroup;
  const bool valid = row < n_rows;  // every lane stays for the shuffles
  C sum[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) sum[b] = czero<C>();
  if (valid) {
    const int end = crow[row + 1];
    for (int e = crow[row] + lane; e < end; e += kGroup) {
      const C a = val[e];
      const long long c = col[e];
#pragma unroll
      for (int b = 0; b < kB; ++b)
        if (b < nb) sum[b] = cfma(a, x[b * ldx + c], sum[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    sum[b].x = group_sum(sum[b].x, kGroup);
    sum[b].y = group_sum(sum[b].y, kGroup);
  }
  if (!valid) return;
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    if (b >= nb || b % kGroup != lane) continue;
    if (out1 != nullptr) {
      const C start = base != nullptr ? base[b * ldb + row] : czero<C>();
      out1[b * ldo + row] = caxpy(c1, sum[b], start);
    }
    if (acc != nullptr) {
      const C start = acc_in != nullptr ? acc_in[b * ldai + row] : acc[b * lda + row];
      acc[b * lda + row] = caxpy(c2, sum[b], start);
    }
  }
}

template <typename C, int kB>
cudaError_t launch(const int* crow, const int* col, const void* val, int n_rows, const void* x, long long ldx,
                   const void* base, long long ldb, double c1, void* out1, long long ldo, const void* acc_in,
                   long long ldai, void* acc, long long lda, double c2, int nb, cudaStream_t stream) {
  using R = typename RealOf<C>::T;
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  csr_spmm_kernel<C, kB><<<blocks, kThreads, 0, stream>>>(
      crow, col, static_cast<const C*>(val), n_rows, static_cast<const C*>(x), ldx, static_cast<const C*>(base), ldb,
      static_cast<R>(c1), static_cast<C*>(out1), ldo, static_cast<const C*>(acc_in), ldai, static_cast<C*>(acc), lda,
      static_cast<R>(c2), nb);
  return cudaGetLastError();
}

template <typename C, typename... Args>
cudaError_t dispatch(int nb, Args... args) {
  if (nb <= 1) return launch<C, 1>(args...);
  if (nb <= 2) return launch<C, 2>(args...);
  if (nb <= 4) return launch<C, 4>(args...);
  if (nb <= 8) return launch<C, 8>(args...);
  if (nb <= 16) return launch<C, 16>(args...);
  return launch<C, 32>(args...);
}

}  // namespace

// crow (n_rows + 1), col (nnz) int32; val (nnz); x: nb vectors ldx elements
// apart (the columns gathered); base, out1, acc: nb vectors of n_rows, ldb,
// ldo, lda elements apart (base and acc may be null, out1 null for none);
// acc_in: nb vectors ldai apart, or null (acc updated in place); c1, c2
// real; complex128 where dbl, else complex64.
extern "C" int csr_spmm_launch(const void* crow, const void* col, const void* val, int n_rows, const void* x,
                               long long ldx, const void* base, long long ldb, double c1, void* out1, long long ldo,
                               const void* acc_in, long long ldai, void* acc, long long lda, double c2, int nb,
                               int dbl, void* stream) {
  if (n_rows <= 0 || nb <= 0 || nb > 32) return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const int*>(crow);
  const auto* c = static_cast<const int*>(col);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dbl ? dispatch<double2>(nb, r, c, val, n_rows, x, ldx, base, ldb, c1, out1, ldo, acc_in, ldai, acc, lda, c2, nb, s)
          : dispatch<float2>(nb, r, c, val, n_rows, x, ldx, base, ldb, c1, out1, ldo, acc_in, ldai, acc, lda, c2, nb, s);
  return static_cast<int>(err);
}
