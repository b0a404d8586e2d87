// Kernel K13: the Arnoldi exponential exp(coeff A) v over a batch of
// trajectories, in two parts.
//
// arnoldi_step: iteration j after the matvec, per trajectory, as delayed
// classical Gram-Schmidt with reorthogonalization (DCGS2: Swirydowicz et
// al., Numer. Linear Algebra Appl. 2021; Bielich et al., Parallel Computing
// 2022).  On entry basis rows 0..j-1 are final (orthonormal), row j holds
// y_j, the residual of step j - 1 after one Gram-Schmidt pass (unnormalized;
// at j = 0 the start vector), w = A y_j, and column j - 1 of H holds step
// j - 1's first-pass projections.  The step
//   a = V^H y_j, s = |y_j|^2, c = V^H w, d = y_j^H w     (one pass, V = rows 0..j-1)
//   r = sqrt(s - |a|^2); alive' = alive & (r > tol)     (Pythagoras: |y_j - V a|)
//   H[0:j, j-1] += a, H[j, j-1] = alive' ? r : 0        (column j - 1 completed)
//   q_j = (y_j - V a) / r                                (row j, reorthogonalized)
// and, since A q_j = (w - [V q_j] b) / r with b = H[0:j+1, 0:j] a (the Arnoldi
// relation), the projections of A q_j on rows 0..j without another pass:
//   h[i] = (c_i - b_i) / r (i < j),  h[j] = ((d - a^H c) / r - b_j) / r,
//   H[0:j+1, j] = alive' ? h : 0,
//   y_{j+1} = A q_j - [V q_j] h = w / r - V f - g y_j   (row j + 1, when j + 1 < k)
// with e = b / r + h, f = e[0:j] - a e_j / r, g = e_j / r; rows j and j + 1
// are zero where the trajectory is not alive'.  So H's column j is complete
// at step j + 1 (its second pass is the a of that step), and the last
// column keeps its first pass: the second pass of the last residual would
// change exp(coeff H)[:, 0] only at order k of the series.  alive holds
// whether row j is alive: CGS2's mask one step later (the JAX breakdown rule,
// r <= 100 eps at the step that finds it).
// arnoldi_epilogue: out = nrm > 0 ? nrm sum_r exp(coeff H)[r, 0] V[r, :] : x.
//
// Replaces: yaqs_tpu/ops/krylov.py arnoldi_expm_apply (:145-202): the body of
// its fori_loop (the matvec aside; JAX runs CGS2) and the
// jax.scipy.linalg.expm (Pade) epilogue (XLA chain K13).  Here the exponential
// is 10 Taylor terms of A / 2^s with s = clip(ceil(log2(max(||A||_1, 1e-30) /
// 0.5)), 0, 16), then s squarings, as kernel K3 computes it for the
// tridiagonal case.
//
// What bounds it on the card: device memory.  The step's own bytes (those of
// the CGS2 body it replaces) are w and rows 0..j in, row j + 1 out: (j + 3)
// vectors of n complex64 per trajectory, (j + 2) at the last step.  This
// design reads the basis twice and writes row j again: the projection pass
// reads rows 0..j and w ((j + 2) vectors), the update pass reads them again
// and writes rows j and j + 1 ((j + 4)): 2j + 6 vectors (2j + 4 at the last
// step, which skips w and row j + 1), against CGS2's 3j + 10 in the earlier
// four-launch design: at B = 16, n = 2^20, j = 12, 30 vectors (4.0 GB, 1.2 ms
// at 3.35 TB/s) instead of 46.  The epilogue streams the k rows once: about
// 1.0 ms at k = 25.
//
// Design: two launches a step.  The projection pass runs on (blocks per
// trajectory, B), up to 64 blocks a trajectory; w and row j are staged
// through shared memory a tile at a time and the rows 0..j-1 split over the
// warps (warp w owns rows w, w + 8, ...), so a thread holds at most 4 rows'
// sums whatever j is.  A block writes its partial sums to scratch and counts
// itself done on the trajectory's counter; the last block of a trajectory
// adds the partials up in block order, updates H and the alive mask, resets
// the counter and leaves the update pass's coefficients (1/r, a/r, f, g) in
// scratch, so no value travels to the host and no third launch gathers.
// The update pass tiles n over the card, a thread four elements, each read
// of a row feeding both row j and row j + 1.  The epilogue's small
// exponential runs once per trajectory in its own launch (one block, k <= 32
// in shared memory); the combination then tiles n over the card and skips
// rows whose coefficient is exactly zero (the rows past a breakdown).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr int kColsPerThread = 4;
constexpr int kTaylorTerms = 10;
constexpr int kMaxSquarings = 16;
// the projection pass's tile: each lane takes kPerLane elements of it
constexpr int kPerLane = 8;
constexpr int kTile = 32 * kPerLane;
// per (trajectory, block) partial sums: c = V^H w and a = V^H y (kMaxK each),
// then d = y^H w and (s, 0)
constexpr int kPart = 2 * kMaxK + 2;
// per trajectory, the update pass's coefficients: (mode, 1/r), a/r and f
// (kMaxK each), then g.  mode: 0 dead before (nothing to write), 1 dies now
// (rows j and j + 1 zeroed), 2 alive
constexpr int kCoef = 2 * kMaxK + 2;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) b
__device__ __forceinline__ float2 cdot(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 cdiv_real(float2 a, float r) { return make_float2(a.x / r, a.y / r); }

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

// Sums each of v[0..NV) over the warp; every lane holds the totals.
template <int NV>
__device__ __forceinline__ void warp_sum(float (&v)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
}

// The last block of trajectory z: add the partials, complete column j - 1
// of H, form column j, the mask and the update pass's coefficients.
__device__ void finish_step(const float2* part, float2* coef, float2* hess, unsigned char* alive, long long z,
                            int nblk, int j, int k, float tol) {
  __shared__ float2 sa[kMaxK], sc[kMaxK], sb[kMaxK + 1], se[kMaxK + 1];
  __shared__ float2 sd;
  __shared__ float sr, srs;
  __shared__ int salive_in, salive;
  const int tid = threadIdx.x;
  const float2* pz = part + z * nblk * kPart;
  if (tid < 2 * j || tid == 2 * kMaxK || tid == 2 * kMaxK + 1) {  // c_i, a_i, d, s: in block order
    const int slot = tid < j ? tid : tid < 2 * j ? kMaxK + tid - j : tid;
    float2 acc = make_float2(0.f, 0.f);
    for (int b = 0; b < nblk; ++b) {
      const float2 v = __ldcg(pz + b * kPart + slot);
      acc.x += v.x;
      acc.y += v.y;
    }
    if (tid < j) sc[tid] = acc;
    else if (tid < 2 * j) sa[tid - j] = acc;
    else if (tid == 2 * kMaxK) sd = acc;
    else sr = acc.x;  // s for now
  }
  __syncthreads();
  if (tid == 0) {
    float norm_a = 0.f;
    for (int m = 0; m < j; ++m) norm_a += sa[m].x * sa[m].x + sa[m].y * sa[m].y;
    const float r = sqrtf(fmaxf(sr - norm_a, 0.f));
    salive_in = alive[z] != 0;
    salive = salive_in && r > tol;
    sr = r;
    srs = salive ? r : 1.f;
  }
  __syncthreads();
  const bool alive_in = salive_in != 0, alive_next = salive != 0;
  const float r = sr, rs = srs;
  float2* hz = hess + z * k * k;
  // b = H[0:j+1, 0:j] a with column j - 1 completed (its row j is r)
  if (tid < j) {
    float2 acc = make_float2(0.f, 0.f);
    for (int m = 0; m < j; ++m) {
      float2 h = hz[tid * k + m];
      if (m == j - 1 && alive_in) h = make_float2(h.x + sa[tid].x, h.y + sa[tid].y);
      const float2 p = cmul(h, sa[m]);
      acc.x += p.x;
      acc.y += p.y;
    }
    sb[tid] = acc;
  } else if (tid == j) {
    sb[j] = j > 0 ? make_float2(r * sa[j - 1].x, r * sa[j - 1].y) : make_float2(0.f, 0.f);
  }
  __syncthreads();
  // h (into column j), e = b / r + h
  float2 h = make_float2(0.f, 0.f);
  if (tid < j) {
    h = cdiv_real(make_float2(sc[tid].x - sb[tid].x, sc[tid].y - sb[tid].y), rs);
  } else if (tid == j) {
    float2 qw = sd;  // (d - a^H c) / r
    for (int m = 0; m < j; ++m) {
      const float2 p = cdot(sa[m], sc[m]);
      qw.x -= p.x;
      qw.y -= p.y;
    }
    qw = cdiv_real(qw, rs);
    h = cdiv_real(make_float2(qw.x - sb[j].x, qw.y - sb[j].y), rs);
  }
  if (tid <= j) {
    const float2 bt = cdiv_real(sb[tid], rs);
    se[tid] = make_float2(bt.x + h.x, bt.y + h.y);
  }
  __syncthreads();
  float2* cz = coef + z * kCoef;
  if (tid < j) {  // a / r and f
    const float2 ar = cdiv_real(sa[tid], rs);
    const float2 t = cmul(ar, se[j]);
    cz[1 + tid] = ar;
    cz[1 + kMaxK + tid] = make_float2(se[tid].x - t.x, se[tid].y - t.y);
    if (alive_in) hz[tid * k + j - 1] = make_float2(hz[tid * k + j - 1].x + sa[tid].x,
                                                    hz[tid * k + j - 1].y + sa[tid].y);
  }
  if (tid <= j) hz[tid * k + j] = alive_next ? h : make_float2(0.f, 0.f);
  if (tid == 0) {
    if (j > 0) hz[j * k + j - 1] = make_float2(alive_next ? r : 0.f, 0.f);
    cz[0] = make_float2(alive_next ? 2.f : alive_in ? 1.f : 0.f, 1.f / rs);
    cz[1 + 2 * kMaxK] = cdiv_real(se[j], rs);
    alive[z] = alive_next ? 1 : 0;
  }
}

// Projection pass: partial sums of c = V^H w, a = V^H y (rows 0..j-1 split
// over the warps), d = y^H w and s = |y|^2, per block; the trajectory's last
// block finishes the step.
template <int Q>
__global__ void __launch_bounds__(kThreads)
project_kernel(const float2* __restrict__ basis, const float2* __restrict__ w, float2* __restrict__ part,
               float2* __restrict__ coef, float2* __restrict__ hess, unsigned char* __restrict__ alive,
               unsigned* __restrict__ counter, int j, int k, long long n, long long chunk, float tol) {
  __shared__ float2 wt[kTile], yt[kTile];
  __shared__ float red[kWarps * 3];
  __shared__ float tot[3];
  __shared__ bool last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long z = blockIdx.y;
  const int nblk = gridDim.x;
  const float2* vz = basis + z * k * n;
  const float2* wz = w + z * n;
  const float2* yz = vz + j * n;
  const long long c0 = blockIdx.x * chunk, c1 = c0 + chunk < n ? c0 + chunk : n;
  float acc[4 * Q];  // row q: c (re, im), a (re, im)
#pragma unroll
  for (int i = 0; i < 4 * Q; ++i) acc[i] = 0.f;
  float own[3] = {0.f, 0.f, 0.f};  // d (re, im), s
  for (long long t0 = c0; t0 < c1; t0 += kTile) {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {  // w and y read once
      const long long e = t0 + i;
      const float2 wv = e < c1 ? wz[e] : make_float2(0.f, 0.f);
      const float2 yv = e < c1 ? yz[e] : make_float2(0.f, 0.f);
      wt[i] = wv;
      yt[i] = yv;
      const float2 p = cdot(yv, wv);
      own[0] += p.x;
      own[1] += p.y;
      own[2] += yv.x * yv.x + yv.y * yv.y;
    }
    __syncthreads();
    float2 v[Q][kPerLane];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = warp + kWarps * q;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const long long e = t0 + lane + 32 * i;
        v[q][i] = r < j && e < c1 ? vz[r * n + e] : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float2 wv = wt[lane + 32 * i], yv = yt[lane + 32 * i];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float2 pc = cdot(v[q][i], wv), pa = cdot(v[q][i], yv);
        acc[4 * q] += pc.x;
        acc[4 * q + 1] += pc.y;
        acc[4 * q + 2] += pa.x;
        acc[4 * q + 3] += pa.y;
      }
    }
    __syncthreads();
  }
  warp_sum<4 * Q>(acc);
  float2* pb = part + (z * nblk + blockIdx.x) * kPart;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = warp + kWarps * q;
      if (r < j) {
        pb[r] = make_float2(acc[4 * q], acc[4 * q + 1]);
        pb[kMaxK + r] = make_float2(acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
  }
  block_sum<3>(own, red, tot);
  if (threadIdx.x == 0) {
    pb[2 * kMaxK] = make_float2(tot[0], tot[1]);
    pb[2 * kMaxK + 1] = make_float2(tot[2], 0.f);
  }
  __threadfence();  // the partials before the count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter + z, 1u) == static_cast<unsigned>(nblk - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish_step(part, coef, hess, alive, z, nblk, j, k, tol);
  if (threadIdx.x == 0) counter[z] = 0;  // for the next step
}

// Update pass: row j = y / r - V (a / r) and row j + 1 = w / r - V f - g y
// (when j + 1 < k), or zeros where the trajectory dies now.
__global__ void __launch_bounds__(kThreads)
update_kernel(float2* __restrict__ basis, const float2* __restrict__ w, const float2* __restrict__ coef, int j, int k,
              long long n) {
  __shared__ float2 sal[kMaxK], sf[kMaxK];
  __shared__ float2 sg;
  __shared__ float sinv;
  __shared__ int smode;
  const long long z = blockIdx.y;
  const float2* cz = coef + z * kCoef;
  if (threadIdx.x < j) {
    sal[threadIdx.x] = cz[1 + threadIdx.x];
    sf[threadIdx.x] = cz[1 + kMaxK + threadIdx.x];
  }
  if (threadIdx.x == 0) {
    smode = static_cast<int>(cz[0].x);
    sinv = cz[0].y;
    sg = cz[1 + 2 * kMaxK];
  }
  __syncthreads();
  const int mode = smode;
  if (mode == 0) return;
  const bool next = j + 1 < k;
  const float inv = sinv;
  const float2 g = sg;
  float2* vz = basis + z * k * n;
  float2* yz = vz + j * n;
  float2* nz = vz + (j + 1) * n;
  const float2* wz = w + z * n;
  const long long e0 = static_cast<long long>(blockIdx.x) * kThreads * kColsPerThread + threadIdx.x;
  if (mode == 1) {
#pragma unroll
    for (int p = 0; p < kColsPerThread; ++p) {
      const long long e = e0 + p * kThreads;
      if (e < n) {
        yz[e] = make_float2(0.f, 0.f);
        if (next) nz[e] = make_float2(0.f, 0.f);
      }
    }
    return;
  }
  float2 q[kColsPerThread], y[kColsPerThread];
#pragma unroll
  for (int p = 0; p < kColsPerThread; ++p) {
    const long long e = e0 + p * kThreads;
    if (e < n) {
      const float2 yv = yz[e];
      q[p] = make_float2(yv.x * inv, yv.y * inv);
      if (next) {
        const float2 wv = wz[e], gy = cmul(g, yv);
        y[p] = make_float2(wv.x * inv - gy.x, wv.y * inv - gy.y);
      }
    }
  }
  for (int m = 0; m < j; ++m) {
    const float2 al = sal[m], f = sf[m];
    const float2* vm = vz + m * n;
#pragma unroll
    for (int p = 0; p < kColsPerThread; ++p) {
      const long long e = e0 + p * kThreads;
      if (e < n) {
        const float2 v = vm[e];
        const float2 t = cmul(al, v);
        q[p].x -= t.x;
        q[p].y -= t.y;
        if (next) {
          const float2 u = cmul(f, v);
          y[p].x -= u.x;
          y[p].y -= u.y;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kColsPerThread; ++p) {
    const long long e = e0 + p * kThreads;
    if (e < n) {
      yz[e] = q[p];
      if (next) nz[e] = y[p];
    }
  }
}

template <int Q>
int step_passes(const float2* w, float2* basis, float2* hess, unsigned char* alive, float2* scratch,
                unsigned* counter, int batch, int k, long long n, int j, int nblk, float tol, cudaStream_t stream) {
  const long long chunk = (n + nblk - 1) / nblk;
  float2* part = scratch;
  float2* coef = part + static_cast<long long>(batch) * nblk * kPart;
  project_kernel<Q><<<dim3(nblk, batch), kThreads, 0, stream>>>(basis, w, part, coef, hess, alive, counter, j, k, n,
                                                                 chunk, tol);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(kThreads) * kColsPerThread;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block), batch);
  update_kernel<<<grid, kThreads, 0, stream>>>(basis, w, coef, j, k, n);
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

// w (batch, n): the matvec's output A y_j, read only; basis (batch, k, n);
// hess (batch, k, k) complex; alive (batch,) bool; scratch: batch * (nblk *
// kPart + kCoef) complex; counter: batch zeros (left zero); all contiguous.
extern "C" int arnoldi_step_launch(const void* w, void* basis, void* hess, void* alive, void* scratch, void* counter,
                                   int batch, int k, long long n, int j, int nblk, float tol, void* stream) {
  if (batch <= 0 || batch > 65535 || k <= 0 || k > kMaxK || n <= 0 || j < 0 || j >= k || nblk <= 0 || nblk > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto ww = static_cast<const float2*>(w);
  const auto vb = static_cast<float2*>(basis);
  const auto hh = static_cast<float2*>(hess);
  const auto al = static_cast<unsigned char*>(alive);
  const auto sc = static_cast<float2*>(scratch);
  const auto ct = static_cast<unsigned*>(counter);
  const auto s = static_cast<cudaStream_t>(stream);
  if (j <= kWarps) return step_passes<1>(ww, vb, hh, al, sc, ct, batch, k, n, j, nblk, tol, s);
  if (j <= 2 * kWarps) return step_passes<2>(ww, vb, hh, al, sc, ct, batch, k, n, j, nblk, tol, s);
  if (j <= 3 * kWarps) return step_passes<3>(ww, vb, hh, al, sc, ct, batch, k, n, j, nblk, tol, s);
  return step_passes<4>(ww, vb, hh, al, sc, ct, batch, k, n, j, nblk, tol, s);
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
