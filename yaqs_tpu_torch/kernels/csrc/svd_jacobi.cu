// Kernel K9: batched thin SVD of complex64 blocks by one-sided (Hestenes)
// Jacobi, one thread block per block.
//
// Replaces: the `jnp.linalg.svd` of yaqs_tpu/ops/decomp.py
// split_matrix_truncated (the exact split of every two-site block, (d*chi,
// d*chi) = (128, 128) at B = 32 on the analog path, (64, 64) at B = 512 in the
// digital sweeps, (d*chi, Dw*chi) = (128, 256) in the zip-up of a long-range
// gate's MPO at chi = 64) and the values-only `svd(r, compute_uv=False)` of
// yaqs_tpu/core/mps_ops.py bond_spectra ((chi, chi) = (64, 64)).
//
// What it computes: for a (rows, cols) block with rows >= cols (the wrapper
// passes the adjoint of a wide block), W V = U S with V unitary: columns p, q
// of W (and of V) are rotated by the 2x2 unitary that zeroes w_p^H w_q, for
// the pairs of a round-robin ordering (cols/2 disjoint pairs a round,
// cols - 1 rounds a sweep), until a whole sweep finds every pair with
// |w_p^H w_q| <= tol ||w_p|| ||w_q|| or max_sweeps sweeps have run.  Then
// s_j = ||w_j|| sorted descending, U's columns w_j / s_j, Vh = V^H.  Pairs
// with a (numerically) zero column are skipped, so padded, exactly
// rank-deficient blocks never divide 0 by 0; a zero column's U column is an
// orthonormal completion (a unit vector e_i, Gram-Schmidt'ed twice against
// the other columns), so U stays an isometry at every rank: the truncated
// split keeps at least two directions (min_keep) and puts U's kept columns,
// unscaled, into the left-canonical site tensor.
//
// What bounds it on the card: latency.  A (128, 128) block is 128 KB in and
// 256 KB out but about 2 * 128^3 * 10 (sweeps) real FMAs in 1,270 dependent
// rounds; at B = 32 only 32 SMs have work.  Design: the block is scaled by its
// largest entry (so no column norm under- or overflows) and is held
// column-major; a warp rotates one pair at a time, the three column
// reductions done with warp shuffles.  W lives in shared memory (leading
// dimension rows + 1) when it fits (132 KB at (128, 128)); a taller block
// (the adjoint of the zip-up split's (d chi, Dw chi) = (128, 256) block at
// chi = 64, up to kMaxRows rows) keeps W in device scratch (L2-resident: 8 MB
// at (32, 256, 128)).  V (cols x cols) takes the shared memory that is left
// when it fits there (132 KB at 128 columns, so at (64, 64) and beside a
// device-memory W) and device scratch otherwise (at (128, 128): 4 MB at
// B = 32); device-memory columns are touched only by pairs that rotate.  The
// values-only mode keeps no V.  Every launch can also fold its largest sweep
// count and largest final off-diagonal ratio over tol into a device-side
// record (atomic maxima), so a whole run's convergence is read once at its
// end without a host sync per launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 128;     // columns (the short side)
constexpr int kMaxRows = 4096;   // rows (the long side)
constexpr float kTiny = 1e-30f;     // a column with ||w||^2 below it (scaled units) counts as zero
constexpr size_t kSmemLimit = 227 * 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) * b
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

// alpha += |a|^2, beta += |c|^2, (gr, gi) += conj(a) c
__device__ __forceinline__ void accumulate_pair(float2 a, float2 c, float& alpha, float& beta, float& gr, float& gi) {
  alpha = fmaf(a.x, a.x, fmaf(a.y, a.y, alpha));
  beta = fmaf(c.x, c.x, fmaf(c.y, c.y, beta));
  gr = fmaf(a.x, c.x, fmaf(a.y, c.y, gr));
  gi = fmaf(a.x, c.y, fmaf(-a.y, c.x, gi));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// [x_p, x_q] <- [x_p, x_q] J, J = [[c, s e], [-s conj(e), c]], over n
// entries of two columns, one warp
__device__ __forceinline__ void rotate_columns(float2* xp, float2* xq, int n, float c, float2 se) {
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < n; i += 32) {
    const float2 a = xp[i];
    const float2 b = xq[i];
    const float2 sb = cmulc(se, b);
    const float2 sa = cmul(se, a);
    xp[i] = make_float2(c * a.x - sb.x, c * a.y - sb.y);
    xq[i] = make_float2(sa.x + c * b.x, sa.y + c * b.y);
  }
}

size_t w_bytes(int rows, int cols) { return sizeof(float2) * static_cast<size_t>(cols) * (rows + 1); }
size_t v_bytes(int cols) { return sizeof(float2) * static_cast<size_t>(cols) * (cols + 1); }
size_t misc_bytes() {
  return sizeof(float2) * kMaxDim + sizeof(float) * (kMaxDim + kWarps) + sizeof(int) * (3 * kMaxDim + 4);
}

// where W and V live: in shared memory when they fit, W first
struct Placement {
  bool w_in_smem;
  bool v_in_smem;
  size_t smem;
};

Placement place(int rows, int cols, bool vectors) {
  Placement p{};
  p.smem = misc_bytes();
  p.w_in_smem = p.smem + w_bytes(rows, cols) <= kSmemLimit;
  if (p.w_in_smem) p.smem += w_bytes(rows, cols);
  p.v_in_smem = vectors && p.smem + v_bytes(cols) <= kSmemLimit;
  if (p.v_in_smem) p.smem += v_bytes(cols);
  return p;
}

long long w_scratch(int batch, int rows, int cols, const Placement& p) {
  return p.w_in_smem ? 0 : static_cast<long long>(batch) * cols * rows;
}

// kWShared: W in shared memory, so its loads and stores in the sweeps are
// shared-memory instructions, not generic ones
template <bool kWShared>
__global__ void __launch_bounds__(kThreads, 1)
    svd_jacobi_kernel(const float2* __restrict__ in, long long stride_in, float2* __restrict__ u_out,
                      float* __restrict__ s_out, float2* __restrict__ vh_out, float2* __restrict__ work,
                      int* __restrict__ sweeps_out, float* __restrict__ off_out, int* __restrict__ record,
                      int rows, int cols, int v_in_smem, float tol, int max_sweeps) {
  extern __shared__ float2 smem[];
  const bool vectors = u_out != nullptr;
  const long long b = blockIdx.x;
  float2* next = smem;
  float2* sa;  // W, column-major
  int lda;
  if constexpr (kWShared) {
    sa = next;
    lda = rows + 1;
    next += cols * lda;
  } else {
    sa = work + b * cols * rows;
    lda = rows;
  }
  float2* v = nullptr;  // V, column-major
  int ldv = cols;
  if (vectors && v_in_smem) {
    v = next;
    ldv = cols + 1;
    next += cols * ldv;
  } else if (vectors) {
    v = work + (kWShared ? 0 : static_cast<long long>(gridDim.x) * cols * rows) + b * cols * cols;
  }
  float2* sdot = next;
  float* ssig = reinterpret_cast<float*>(sdot + kMaxDim);
  float* sred = ssig + kMaxDim;
  int* srank = reinterpret_cast<int*>(sred + kWarps);
  int* sinv = srank + kMaxDim;
  int* svalid = sinv + kMaxDim;
  int* sflag = svalid + kMaxDim;  // [0] a pair rotated this sweep, [1] largest ratio (float bits)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float2* src = in + b * stride_in;
  const int rc = rows * cols;

  // load (row-major in, column-major into W) and scale by the
  // largest |Re|, |Im|
  float mx = 0.f;
  for (int e = tid; e < rc; e += kThreads) {
    const float2 x = src[e];
    sa[(e % cols) * lda + e / cols] = x;
    mx = fmaxf(mx, fmaxf(fabsf(x.x), fabsf(x.y)));
  }
  mx = warp_max(mx);
  if (lane == 0) sred[warp] = mx;
  __syncthreads();
  float amax = 0.f;
  for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, sred[w]);
  if (amax > 0.f) {
    const float inv = 1.f / amax;
    for (int e = tid; e < rc; e += kThreads) {
      float2& x = sa[(e % cols) * lda + e / cols];
      x.x *= inv;
      x.y *= inv;
    }
  } else {
    amax = 1.f;
  }
  if (vectors) {
    for (int e = tid; e < cols * cols; e += kThreads) {
      const int c = e / cols;
      const int i = e % cols;
      v[c * ldv + i] = make_float2(c == i ? 1.f : 0.f, 0.f);
    }
  }
  __syncthreads();

  // sweeps of round-robin rounds
  const int n_even = cols + (cols & 1);
  int sweep = 0;
  float off_last = 0.f;
  while (sweep < max_sweeps) {
    if (tid == 0) {
      sflag[0] = 0;
      sflag[1] = 0;
    }
    __syncthreads();
    for (int r = 0; r < n_even - 1; ++r) {
      for (int pi = warp; pi < n_even / 2; pi += kWarps) {
        int p, q;
        if (pi == 0) {
          p = r;
          q = n_even - 1;
        } else {
          p = (r + pi) % (n_even - 1);
          q = (r - pi + n_even - 1) % (n_even - 1);
        }
        if (p > q) {
          const int t = p;
          p = q;
          q = t;
        }
        if (q >= cols) continue;  // the dummy column of an odd count
        float2* wp = sa + p * lda;
        float2* wq = sa + q * lda;
        float alpha = 0.f, beta = 0.f, gr = 0.f, gi = 0.f;
        if (rows <= kMaxDim) {  // at most four rows a lane: unrolled, the loads issued together
#pragma unroll
          for (int t = 0; t < kMaxDim / 32; ++t) {
            const int i = lane + 32 * t;
            if (i < rows) accumulate_pair(wp[i], wq[i], alpha, beta, gr, gi);
          }
        } else {
          for (int i = lane; i < rows; i += 32) accumulate_pair(wp[i], wq[i], alpha, beta, gr, gi);
        }
        alpha = warp_sum(alpha);
        beta = warp_sum(beta);
        gr = warp_sum(gr);
        gi = warp_sum(gi);
        if (alpha < kTiny || beta < kTiny) continue;
        const float gabs = hypotf(gr, gi);
        const float ratio = gabs / (sqrtf(alpha) * sqrtf(beta));
        if (lane == 0) atomicMax(&sflag[1], __float_as_int(ratio));
        if (!(ratio > tol)) continue;
        if (lane == 0) sflag[0] = 1;
        const float zeta = (beta - alpha) / (2.f * gabs);
        const float t = copysignf(1.f, zeta) / (fabsf(zeta) + hypotf(1.f, zeta));
        const float c = 1.f / sqrtf(1.f + t * t);
        const float s = t * c;
        const float2 se = make_float2(s * gr / gabs, s * gi / gabs);
        rotate_columns(wp, wq, rows, c, se);
        if (vectors) rotate_columns(v + p * ldv, v + q * ldv, cols, c, se);
      }
      __syncthreads();
    }
    const int rotated = sflag[0];
    off_last = __int_as_float(sflag[1]);
    ++sweep;
    __syncthreads();
    if (!rotated) break;
  }

  // singular values, their order, and (with vectors) U's columns
  for (int c = warp; c < cols; c += kWarps) {
    float nrm = 0.f;
    for (int i = lane; i < rows; i += 32) {
      const float2 x = sa[c * lda + i];
      nrm = fmaf(x.x, x.x, fmaf(x.y, x.y, nrm));
    }
    nrm = warp_sum(nrm);
    if (lane == 0) {
      ssig[c] = sqrtf(nrm);
      svalid[c] = nrm >= kTiny;
    }
  }
  __syncthreads();
  if (tid < cols) {
    const float mine = ssig[tid];
    int rank = 0;
    for (int i = 0; i < cols; ++i) {
      const float other = ssig[i];
      rank += (other > mine) || (other == mine && i < tid);
    }
    srank[tid] = rank;
    sinv[rank] = tid;
    s_out[b * cols + rank] = mine * amax;
  }
  if (tid == 0) {
    if (sweeps_out != nullptr) sweeps_out[b] = sweep;
    if (off_out != nullptr) off_out[b] = off_last;
    if (record != nullptr) {  // non-negative floats order as their bits
      atomicMax(&record[0], sweep);
      atomicMax(&record[1], __float_as_int(off_last / tol));
    }
  }
  if (!vectors) return;
  for (int e = tid; e < rc; e += kThreads) {
    const int c = e / rows;
    if (svalid[c]) {
      float2& x = sa[c * lda + e % rows];
      const float inv = 1.f / ssig[c];
      x.x *= inv;
      x.y *= inv;
    }
  }
  __syncthreads();

  // orthonormal completion of the zero columns, in the order of their rank:
  // candidates e_0, e_1, ... (each tried once), projected out of the valid
  // columns twice and taken when ||residual||^2 > 1 / (4 rows).  Such a
  // candidate always remains: the residuals' squares sum to rows minus the
  // valid count, and a rejected one only shrinks.
  const float accept = 0.25f / rows;
  int cand = 0;
  for (int rk = 0; rk < cols; ++rk) {
    const int c = sinv[rk];
    if (svalid[c]) continue;
    float2* x = sa + c * lda;
    while (cand < rows) {
      for (int i = tid; i < rows; i += kThreads) x[i] = make_float2(i == cand ? 1.f : 0.f, 0.f);
      ++cand;
      __syncthreads();
      for (int pass = 0; pass < 2; ++pass) {
        for (int j = warp; j < cols; j += kWarps) {
          float2 d = make_float2(0.f, 0.f);
          if (svalid[j]) {
            for (int i = lane; i < rows; i += 32) {
              const float2 t = cmulc(sa[j * lda + i], x[i]);
              d.x += t.x;
              d.y += t.y;
            }
            d.x = warp_sum(d.x);
            d.y = warp_sum(d.y);
          }
          if (lane == 0) sdot[j] = d;
        }
        __syncthreads();
        for (int i = tid; i < rows; i += kThreads) {
          float2 acc = x[i];
          for (int j = 0; j < cols; ++j) {
            const float2 t = cmul(sdot[j], sa[j * lda + i]);
            acc.x -= t.x;
            acc.y -= t.y;
          }
          x[i] = acc;
        }
        __syncthreads();
      }
      float nrm = 0.f;
      for (int i = tid; i < rows; i += kThreads) nrm = fmaf(x[i].x, x[i].x, fmaf(x[i].y, x[i].y, nrm));
      nrm = warp_sum(nrm);
      if (lane == 0) sred[warp] = nrm;
      __syncthreads();
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += sred[w];
      __syncthreads();
      if (total > accept) {
        const float inv = 1.f / sqrtf(total);
        for (int i = tid; i < rows; i += kThreads) {
          x[i].x *= inv;
          x[i].y *= inv;
        }
        if (tid == 0) svalid[c] = 1;
        __syncthreads();
        break;
      }
    }
  }

  // U (rows, cols) and Vh (cols, cols), row-major, columns in rank order
  float2* u = u_out + b * rc;
  for (int e = tid; e < rc; e += kThreads) {
    const int i = e / cols;
    u[e] = sa[sinv[e % cols] * lda + i];
  }
  float2* vh = vh_out + b * cols * cols;
  for (int e = tid; e < cols * cols; e += kThreads) {
    const float2 x = v[sinv[e / cols] * ldv + e % cols];
    vh[e] = make_float2(x.x, -x.y);
  }
}

}  // namespace

// Complex64 elements of device scratch the launch needs for W and V: 0 when
// both fit in shared memory (or V is not wanted and W fits).
extern "C" long long svd_jacobi_workspace(int batch, int rows, int cols, int vectors) {
  const Placement p = place(rows, cols, vectors != 0);
  const long long v = vectors && !p.v_in_smem ? static_cast<long long>(batch) * cols * cols : 0;
  return w_scratch(batch, rows, cols, p) + v;
}

// in: batch row-major (rows, cols) blocks, cols <= rows, stride_in elements
// apart; u_out (batch, rows, cols), s_out (batch, cols), vh_out (batch, cols,
// cols), contiguous, or u_out = vh_out = null for values only; work the
// scratch svd_jacobi_workspace asks for (or null); sweeps_out (batch,) int32
// and off_out (batch,) float32 (the largest |w_p^H w_q| / (||w_p|| ||w_q||) of
// the last sweep), each optional; record (2,) int32, optional: atomic maxima
// of the sweeps and of the final ratio over tol (float bits) over the batch.
extern "C" int svd_jacobi_launch(const void* in, long long stride_in, void* u_out, void* s_out, void* vh_out,
                                 void* work, void* sweeps_out, void* off_out, void* record, int batch, int rows,
                                 int cols, float tol, int max_sweeps, void* stream) {
  if (batch <= 0 || cols <= 0 || rows < cols || cols > kMaxDim || rows > kMaxRows || max_sweeps <= 0 ||
      (u_out == nullptr) != (vh_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vectors = u_out != nullptr;
  const Placement p = place(rows, cols, vectors);
  if (svd_jacobi_workspace(batch, rows, cols, vectors) > 0 && work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = p.w_in_smem ? svd_jacobi_kernel<true> : svd_jacobi_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), stride_in, static_cast<float2*>(u_out), static_cast<float*>(s_out),
      static_cast<float2*>(vh_out), static_cast<float2*>(work), static_cast<int*>(sweeps_out),
      static_cast<float*>(off_out), static_cast<int*>(record), rows, cols, p.v_in_smem ? 1 : 0, tol, max_sweeps);
  return static_cast<int>(cudaGetLastError());
}
