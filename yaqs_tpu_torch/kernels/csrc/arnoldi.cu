// Kernel K13: the Arnoldi exponential exp(coeff A) v over a batch of
// trajectories, in two parts.
//
// arnoldi_step: iteration j after the matvec w = A q_j, per trajectory:
//   h1 = V^H w, w -= V h1; h2 = V^H w, w -= V h2   (two classical Gram-Schmidt
//   passes against basis rows 0..j; the rows above j are zero);
//   beta = ||w||;  alive' = alive & (beta > tol);
//   H[:, j] = alive ? h1 + h2 : 0;  H[j + 1, j] = alive' ? beta : 0;
//   basis row j + 1 = alive' ? w / beta : 0 (when j + 1 < k);  alive = alive'.
// arnoldi_epilogue: out = nrm > 0 ? nrm sum_r exp(coeff H)[r, 0] V[r, :] : x.
//
// Replaces: yaqs_tpu/ops/krylov.py arnoldi_expm_apply (:145-202): the body of
// its fori_loop (the matvec aside) and the jax.scipy.linalg.expm (Pade)
// epilogue (XLA chain K13).  Here the exponential is 10 Taylor terms of
// A / 2^s with s = clip(ceil(log2(max(||A||_1, 1e-30) / 0.5)), 0, 16), then
// s squarings, as kernel K3 computes it for the tridiagonal case.
//
// What bounds it on the card: device memory.  Step j reads w and basis rows
// 0..j and writes row j + 1: (j + 3) vectors of n complex64 per trajectory,
// about 0.6 ms at B = 16, n = 2^20, j = 12.  This design reads the rows
// three times (projection; subtraction fused with the second projection;
// second subtraction fused with the norm) and w four times.  The epilogue
// streams the k rows once: about 1.0 ms at k = 25.
//
// Design: the reductions span n = 2^20 per trajectory, so one block per
// trajectory would leave most of the card idle at B = 16.  Each streaming
// pass runs on (blocks per trajectory, B) with up to 64 blocks per
// trajectory; a block writes its partial sums to scratch, and the next pass's
// blocks each add up their trajectory's partials (at most 64 x 32 values)
// before they stream.  Inside a block the rows are split over the warps
// (warp w owns rows w, w + 8, ...), so a thread holds at most 4 rows' values
// and sums whatever j is: a version that gave each thread every row held up
// to 25 rows in registers and ran at a third of the card's memory rate at
// j = 24 (PERF.md).  The basis row for the next iteration is written
// straight into the basis (it is the next matvec's input), and the final pass
// updates H and the alive mask, so the k loop never waits for the host.  The
// epilogue's small exponential runs once per trajectory in its own launch
// (one block, k <= 32 in shared memory); the combination then tiles n over
// the card and skips rows whose coefficient is exactly zero (the rows past a
// breakdown).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr int kColsPerThread = 4;
constexpr int kTaylorTerms = 10;
constexpr int kMaxSquarings = 16;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Sums each of v[0..NV) over the block into tot[0..NV) (shared memory); red
// holds kWarps * NV floats.  Ends with a barrier.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red, float* tot) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) red[warp * NV + i] = v[i];
  __syncthreads();
  for (int i = threadIdx.x; i < NV; i += kThreads) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * NV + i];
    tot[i] = s;
  }
  __syncthreads();
}

// h[r] = sum of the trajectory's per-block partials of row r, in a fixed
// order (every block gets the same numbers).
__device__ __forceinline__ void gather(const float2* part, long long z, int nblk, int rows, float2* h) {
  if (threadIdx.x < rows) {
    float2 s = make_float2(0.f, 0.f);
    for (int b = 0; b < nblk; ++b) {
      const float2 v = part[(z * nblk + b) * kMaxK + threadIdx.x];
      s.x += v.x;
      s.y += v.y;
    }
    h[threadIdx.x] = s;
  }
  __syncthreads();
}

// The streaming passes split the rows over the block's warps: warp w owns
// rows w, w + 8, w + 16, w + 24 (at most Q = 4 of them), and every warp walks
// the same tiles of kTile elements (kPerLane per lane, coalesced).  A thread
// keeps only its rows' values and sums in registers; the per-element sums
// over all rows meet in shared memory.
constexpr int kPerLane = 4;
constexpr int kTile = 32 * kPerLane;

// Sums each of v[0..NV) over the warp; lane 0 holds the totals.
template <int NV>
__device__ __forceinline__ void warp_sum(float (&v)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
}

// Pass 1: partial projections of w on rows 0..rows-1.
template <int Q>
__global__ void __launch_bounds__(kThreads)
project_kernel(const float2* __restrict__ basis, const float2* __restrict__ w, float2* __restrict__ part, int rows,
               int k, long long n, long long chunk) {
  __shared__ float2 wt[kTile];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long z = blockIdx.y;
  const float2* vz = basis + z * k * n;
  const float2* wz = w + z * n;
  const long long c0 = blockIdx.x * chunk, c1 = c0 + chunk < n ? c0 + chunk : n;
  float acc[2 * Q];
#pragma unroll
  for (int i = 0; i < 2 * Q; ++i) acc[i] = 0.f;
  for (long long t0 = c0; t0 < c1; t0 += kTile) {
    if (threadIdx.x < kTile && t0 + threadIdx.x < c1) wt[threadIdx.x] = wz[t0 + threadIdx.x];  // w read once
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const long long e = t0 + lane + 32 * i;
      if (e >= c1) break;
      const float2 wv = wt[lane + 32 * i];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int r = warp + kWarps * q;
        if (r < rows) {
          const float2 v = vz[r * n + e];
          acc[2 * q] += v.x * wv.x + v.y * wv.y;  // conj(v) w
          acc[2 * q + 1] += v.x * wv.y - v.y * wv.x;
        }
      }
    }
    __syncthreads();
  }
  warp_sum<2 * Q>(acc);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = warp + kWarps * q;
      if (r < rows) part[(z * gridDim.x + blockIdx.x) * kMaxK + r] = make_float2(acc[2 * q], acc[2 * q + 1]);
    }
  }
}

// One tile of w -= V h: each warp sums its rows' share of each element into
// share[warp], then the first kTile threads finish the elements, write them
// back, and leave them in wt.  v receives the warp's row values.  Returns
// |new w|^2 of the thread's element (0 for the others).
template <int Q>
__device__ __forceinline__ float subtract_tile(const float2* vz, float2* wz, const float2* h, int rows, long long n,
                                               long long t0, long long c1, float2 (&v)[Q][kPerLane],
                                               float2 (*share)[kTile], float2* wt) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const long long e = t0 + lane + 32 * i;
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = warp + kWarps * q;
      v[q][i] = make_float2(0.f, 0.f);
      if (r < rows && e < c1) {
        v[q][i] = vz[r * n + e];
        const float2 p = cmul(h[r], v[q][i]);
        s.x += p.x;
        s.y += p.y;
      }
    }
    share[warp][lane + 32 * i] = s;
  }
  __syncthreads();
  float norm2 = 0.f;
  if (threadIdx.x < kTile) {
    const long long e = t0 + threadIdx.x;
    if (e < c1) {
      float2 wv = wz[e];
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        wv.x -= share[wi][threadIdx.x].x;
        wv.y -= share[wi][threadIdx.x].y;
      }
      wz[e] = wv;
      wt[threadIdx.x] = wv;
      norm2 = wv.x * wv.x + wv.y * wv.y;
    } else {
      wt[threadIdx.x] = make_float2(0.f, 0.f);
    }
  }
  __syncthreads();
  return norm2;
}

// Pass 2: w -= V h1 (h1 from pass 1's partials), then the partial
// projections of the new w on the same row values.
template <int Q>
__global__ void __launch_bounds__(kThreads)
subtract_project_kernel(const float2* __restrict__ basis, float2* __restrict__ w, const float2* __restrict__ part_in,
                        float2* __restrict__ part_out, int rows, int k, long long n, long long chunk) {
  __shared__ float2 h[kMaxK];
  __shared__ float2 share[kWarps][kTile];
  __shared__ float2 wt[kTile];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long z = blockIdx.y;
  gather(part_in, z, gridDim.x, rows, h);
  const float2* vz = basis + z * k * n;
  float2* wz = w + z * n;
  const long long c0 = blockIdx.x * chunk, c1 = c0 + chunk < n ? c0 + chunk : n;
  float acc[2 * Q];
#pragma unroll
  for (int i = 0; i < 2 * Q; ++i) acc[i] = 0.f;
  float2 v[Q][kPerLane];
  for (long long t0 = c0; t0 < c1; t0 += kTile) {
    subtract_tile<Q>(vz, wz, h, rows, n, t0, c1, v, share, wt);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float2 wv = wt[lane + 32 * i];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        acc[2 * q] += v[q][i].x * wv.x + v[q][i].y * wv.y;
        acc[2 * q + 1] += v[q][i].x * wv.y - v[q][i].y * wv.x;
      }
    }
  }
  warp_sum<2 * Q>(acc);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = warp + kWarps * q;
      if (r < rows) part_out[(z * gridDim.x + blockIdx.x) * kMaxK + r] = make_float2(acc[2 * q], acc[2 * q + 1]);
    }
  }
}

// Pass 3: w -= V h2, and the partial squared norm of the result.
template <int Q>
__global__ void __launch_bounds__(kThreads)
subtract_norm_kernel(const float2* __restrict__ basis, float2* __restrict__ w, const float2* __restrict__ part_in,
                     float* __restrict__ norm_part, int rows, int k, long long n, long long chunk) {
  __shared__ float2 h[kMaxK];
  __shared__ float2 share[kWarps][kTile];
  __shared__ float2 wt[kTile];
  __shared__ float red[kWarps];
  __shared__ float tot[1];
  const long long z = blockIdx.y;
  gather(part_in, z, gridDim.x, rows, h);
  const float2* vz = basis + z * k * n;
  float2* wz = w + z * n;
  const long long c0 = blockIdx.x * chunk, c1 = c0 + chunk < n ? c0 + chunk : n;
  float acc[1] = {0.f};
  float2 v[Q][kPerLane];
  for (long long t0 = c0; t0 < c1; t0 += kTile) acc[0] += subtract_tile<Q>(vz, wz, h, rows, n, t0, c1, v, share, wt);
  block_sum<1>(acc, red, tot);
  if (threadIdx.x == 0) norm_part[z * gridDim.x + blockIdx.x] = tot[0];
}

// Pass 4: beta, the breakdown mask, basis row j + 1, and (block 0) column j
// of H and the mask itself.  A block that reads the mask after block 0 wrote
// it computes the same alive' (alive' & (beta > tol) == alive').
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float2* __restrict__ w, float2* __restrict__ basis, float2* __restrict__ hess,
              unsigned char* __restrict__ alive, const float2* __restrict__ part1, const float2* __restrict__ part2,
              const float* __restrict__ norm_part, int j, int k, long long n, long long chunk, float tol) {
  __shared__ float sbeta;
  __shared__ int salive;
  const long long z = blockIdx.y;
  const int nblk = gridDim.x;
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += norm_part[z * nblk + b];
    sbeta = sqrtf(s);
    salive = alive[z] != 0;
  }
  __syncthreads();
  const float beta = sbeta;
  const bool alive_in = salive != 0;
  const bool alive_next = alive_in && beta > tol;
  if (j + 1 < k) {
    const float scale = alive_next ? 1.f / beta : 0.f;
    const float2* wz = w + z * n;
    float2* vnext = basis + (z * k + j + 1) * n;
    const long long c0 = blockIdx.x * chunk, c1 = c0 + chunk < n ? c0 + chunk : n;
    for (long long e = c0 + threadIdx.x; e < c1; e += kThreads) {
      const float2 wv = wz[e];
      vnext[e] = make_float2(wv.x * scale, wv.y * scale);
    }
  }
  if (blockIdx.x == 0) {
    float2* hz = hess + z * k * k;
    if (threadIdx.x <= j) {
      float2 s = make_float2(0.f, 0.f);
      for (int b = 0; b < nblk; ++b) {
        const float2 a = part1[(z * nblk + b) * kMaxK + threadIdx.x];
        const float2 c = part2[(z * nblk + b) * kMaxK + threadIdx.x];
        s.x += a.x + c.x;
        s.y += a.y + c.y;
      }
      hz[threadIdx.x * k + j] = alive_in ? s : make_float2(0.f, 0.f);
    }
    if (threadIdx.x == 0) {
      if (j + 1 < k) hz[(j + 1) * k + j] = make_float2(alive_next ? beta : 0.f, 0.f);
      alive[z] = alive_next ? 1 : 0;
    }
  }
}

template <int Q>
int step_passes(float2* w, float2* basis, float2* hess, unsigned char* alive, float* scratch, int batch, int k,
                long long n, int j, int nblk, float tol, cudaStream_t stream) {
  const long long chunk = (n + nblk - 1) / nblk;
  const dim3 grid(nblk, batch);
  float2* part1 = reinterpret_cast<float2*>(scratch);
  float2* part2 = part1 + static_cast<long long>(batch) * nblk * kMaxK;
  float* norm_part = reinterpret_cast<float*>(part2 + static_cast<long long>(batch) * nblk * kMaxK);
  const int rows = j + 1;
  project_kernel<Q><<<grid, kThreads, 0, stream>>>(basis, w, part1, rows, k, n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  subtract_project_kernel<Q><<<grid, kThreads, 0, stream>>>(basis, w, part1, part2, rows, k, n, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  subtract_norm_kernel<Q><<<grid, kThreads, 0, stream>>>(basis, w, part2, norm_part, rows, k, n, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<<<grid, kThreads, 0, stream>>>(w, basis, hess, alive, part1, part2, norm_part, j, k, n, chunk, tol);
  return static_cast<int>(cudaGetLastError());
}

// Entry e = (i, j) of lhs @ rhs for k x k complex matrices in shared memory.
__device__ __forceinline__ float2 small_matmul_entry(const float2* lhs, const float2* rhs, int k, int e) {
  const int i = e / k, jj = e % k;
  float2 acc = make_float2(0.f, 0.f);
  for (int l = 0; l < k; ++l) {
    const float2 p = cmul(lhs[i * k + l], rhs[l * k + jj]);
    acc.x += p.x;
    acc.y += p.y;
  }
  return acc;
}

// small[z, r] = exp(coeff H_z)[r, 0], one block per trajectory; a thread owns
// entries tid, tid + 256, ... (at most 4 for k <= 32) of each product.
__global__ void __launch_bounds__(kThreads)
arnoldi_small_kernel(const float2* __restrict__ hess, float cre, float cim, float2* __restrict__ small, int k) {
  constexpr int kEntries = kMaxK * kMaxK / kThreads;
  __shared__ float2 sa[kMaxK * kMaxK];    // A / 2^s
  __shared__ float2 sm[kMaxK * kMaxK];    // A^p / (2^(s p))
  __shared__ float2 sacc[kMaxK * kMaxK];  // Taylor sum, then its squarings
  __shared__ float colsum[kMaxK];
  __shared__ int ssq;
  __shared__ float sscale;
  const int kk = k * k;
  const int tid = threadIdx.x;
  const long long z = blockIdx.x;
  const float2 c = make_float2(cre, cim);
  for (int e = tid; e < kk; e += kThreads) sa[e] = cmul(c, hess[z * kk + e]);
  __syncthreads();
  if (tid < k) {
    float col = 0.f;
    for (int i = 0; i < k; ++i) col += hypotf(sa[i * k + tid].x, sa[i * k + tid].y);
    colsum[tid] = col;
  }
  __syncthreads();
  if (tid == 0) {
    float norm1 = 0.f;
    for (int jj = 0; jj < k; ++jj) norm1 = fmaxf(norm1, colsum[jj]);
    const float s = fminf(fmaxf(ceilf(log2f(fmaxf(norm1, 1e-30f) / 0.5f)), 0.f), float(kMaxSquarings));
    ssq = static_cast<int>(s);
    sscale = exp2f(s);
  }
  __syncthreads();
  for (int e = tid; e < kk; e += kThreads) {
    sa[e] = make_float2(sa[e].x / sscale, sa[e].y / sscale);
    const float one = (e / k == e % k) ? 1.f : 0.f;
    sm[e] = make_float2(one, 0.f);
    sacc[e] = make_float2(one, 0.f);
  }
  __syncthreads();
  float2 ent[kEntries];
  float fact = 1.f;
  for (int term = 1; term <= kTaylorTerms; ++term) {
#pragma unroll
    for (int r = 0; r < kEntries; ++r) {
      const int idx = tid + r * kThreads;
      ent[r] = idx < kk ? small_matmul_entry(sm, sa, k, idx) : make_float2(0.f, 0.f);
    }
    __syncthreads();
    fact *= static_cast<float>(term);
#pragma unroll
    for (int r = 0; r < kEntries; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < kk) {
        sm[idx] = ent[r];
        sacc[idx] = make_float2(sacc[idx].x + ent[r].x / fact, sacc[idx].y + ent[r].y / fact);
      }
    }
    __syncthreads();
  }
  const int nsq = ssq;
  for (int q = 0; q < nsq; ++q) {
#pragma unroll
    for (int r = 0; r < kEntries; ++r) {
      const int idx = tid + r * kThreads;
      ent[r] = idx < kk ? small_matmul_entry(sacc, sacc, k, idx) : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kEntries; ++r) {
      const int idx = tid + r * kThreads;
      if (idx < kk) sacc[idx] = ent[r];
    }
    __syncthreads();
  }
  if (tid < k) small[z * k + tid] = sacc[tid * k];
}

// out = nrm > 0 ? nrm sum_r small[r] V[r, :] : x, over (chunks of n, B).
__global__ void __launch_bounds__(kThreads)
arnoldi_combine_kernel(const float2* __restrict__ basis, const float2* __restrict__ small,
                       const float* __restrict__ nrm, const float2* __restrict__ x, float2* __restrict__ out, int k,
                       long long n) {
  __shared__ float2 ss[kMaxK];
  const long long z = blockIdx.y;
  if (threadIdx.x < k) ss[threadIdx.x] = small[z * k + threadIdx.x];
  __syncthreads();
  const float nb = nrm[z];
  const float2* vz = basis + z * k * n;
  const long long col0 = static_cast<long long>(blockIdx.x) * kThreads * kColsPerThread + threadIdx.x;
#pragma unroll
  for (int p = 0; p < kColsPerThread; ++p) {
    const long long e = col0 + p * kThreads;
    if (e >= n) break;
    float2 res;
    if (nb > 0.f) {
      float2 acc = make_float2(0.f, 0.f);
      for (int r = 0; r < k; ++r) {
        const float2 c = ss[r];
        if (c.x == 0.f && c.y == 0.f) continue;  // a row past a breakdown
        const float2 t = cmul(c, vz[r * n + e]);
        acc.x += t.x;
        acc.y += t.y;
      }
      res = make_float2(acc.x * nb, acc.y * nb);
    } else {
      res = x[z * n + e];
    }
    out[z * n + e] = res;
  }
}

}  // namespace

// w (batch, n): the matvec's output, overwritten with the orthogonalized
// vector; basis (batch, k, n); hess (batch, k, k) complex; alive (batch,)
// bool; scratch: batch * nblk * (4 kMaxK + 1) floats; all contiguous.
extern "C" int arnoldi_step_launch(void* w, void* basis, void* hess, void* alive, void* scratch, int batch, int k,
                                   long long n, int j, int nblk, float tol, void* stream) {
  if (batch <= 0 || batch > 65535 || k <= 0 || k > kMaxK || n <= 0 || j < 0 || j >= k || nblk <= 0 || nblk > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto ww = static_cast<float2*>(w);
  const auto vb = static_cast<float2*>(basis);
  const auto hh = static_cast<float2*>(hess);
  const auto al = static_cast<unsigned char*>(alive);
  const auto sc = static_cast<float*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = j + 1;
  if (rows <= kWarps) return step_passes<1>(ww, vb, hh, al, sc, batch, k, n, j, nblk, tol, s);
  if (rows <= 2 * kWarps) return step_passes<2>(ww, vb, hh, al, sc, batch, k, n, j, nblk, tol, s);
  if (rows <= 3 * kWarps) return step_passes<3>(ww, vb, hh, al, sc, batch, k, n, j, nblk, tol, s);
  return step_passes<4>(ww, vb, hh, al, sc, batch, k, n, j, nblk, tol, s);
}

// hess (batch, k, k) complex; basis (batch, k, n); nrm (batch,) float; x, out
// (batch, n); small: batch * k complex scratch; all contiguous.
extern "C" int arnoldi_epilogue_launch(const void* hess, float coeff_re, float coeff_im, const void* basis,
                                       const void* nrm, const void* x, void* out, void* small, int batch, int k,
                                       long long n, void* stream) {
  if (batch <= 0 || batch > 65535 || k <= 0 || k > kMaxK || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sm = static_cast<float2*>(small);
  arnoldi_small_kernel<<<batch, kThreads, 0, s>>>(static_cast<const float2*>(hess), coeff_re, coeff_im, sm, k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(kThreads) * kColsPerThread;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block), batch);
  arnoldi_combine_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float2*>(basis), sm,
                                                   static_cast<const float*>(nrm), static_cast<const float2*>(x),
                                                   static_cast<float2*>(out), k, n);
  return static_cast<int>(cudaGetLastError());
}
