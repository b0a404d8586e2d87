// Kernel K3: the Lanczos epilogue, per trajectory
//   out = nrm > 0 ? nrm * sum_i exp(coeff T)[i, 0] V[i, :] : x
// for the k x k real symmetric tridiagonal T of the Lanczos recurrence.
//
// Replaces: yaqs_tpu/ops/krylov.py _expm_col_tridiag (float32 branch) and the
// combination (small @ V) * nrm at the end of lanczos_expm_apply (XLA chain
// K3).  On the TJM slice it ends every two-site solve (n = d^2 chi^2 = 16384)
// and every one-site back-evolution (n = d chi^2 = 8192), with k = 4, and
// the digital TDVP gate windows with k = 25.
//
// What it computes, exactly as krylov.py:123-142: A = coeff T;
// s = clip(ceil(log2(max(||A||_1, 1e-30) / 0.5)), 0, 12); 10 Taylor terms of
// exp(A / 2^s); s squarings; column 0.
//
// What bounds it on the card: device memory.  The small exponential is a few
// thousand flops; streaming V (k n complex64) and x and writing out is
// (k + 2) n * 8 bytes per trajectory: 453 MB at B = 512, k = 25, n = 4096
// (0.135 ms at 3.35 TB/s), 25 MB at B = 32, k = 4, n = 16384.
//
// Design: grid (column blocks, B); a block streams `stages` stages of `cw`
// (up to 1024) columns of its trajectory's V, all k rows of a stage, by
// cp.async (16-byte copies where n is even, else 8-byte), through a ring of
// `slots` (1 to 4) stages in shared memory.  The wrapper sizes the stage so
// that four blocks share an SM, and gives a trajectory one block where the
// batch fills the card (B = 512 at k = 25: the exponential once a
// trajectory, every block resident at once) and more where it does not
// (B = 32 at k = 4: 16, each one stage of 1024 columns).  Before anything
// else every thread issues its copies of the first `slots` stages; then
// warp 0 alone forms the exponential in warp-private shared memory while
// they are in flight, with __syncwarp between products and no block
// barrier:
//  - the column sums of |A| (three entries a column), lane j owning column j;
//  - the 10 Taylor terms m <- m (A / 2^s), acc += m / n!: a^n has bandwidth
//    n and a row of m times the tridiagonal A is the same row's three
//    neighbours, so the band's entries are dealt to the lanes, each from
//    the last term's buffer into the other;
//  - s - 1 squarings acc <- acc acc, lane j owning column j, four rows at a
//    time; then column 0 of the last square alone, lane i owning row i.
// Every product entry is summed in ascending order of its inner index, the
// zeros of the tridiagonal and of the band skipped (adding an exact zero
// changes no bit), and the Taylor sum takes its terms in the reference's
// order.  The one block barrier publishes column 0.  Each thread copies and
// combines its own columns of every stage (two with 16-byte copies, the k
// rows in order), waiting for its own copies only, and refills its own
// slots with the next stage, so the stream needs no further barrier.  Where
// nrm <= 0 the block copies x's row instead and touches neither V nor the
// exponential.  k runs from 1 to 64.

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;
constexpr int kTaylorTerms = 10;
constexpr int kMaxSquarings = 12;
constexpr int kMaxCols = 4 * kThreads;  // columns of a stage

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Row pitch of the k x k matrices: odd, so a warp's accesses down a column
// fall in distinct banks.
__host__ __device__ constexpr int pitch(int k) { return k | 1; }

// Shared memory of a block, in float2: `slots` ring stages of k x cw; the
// diagonal and off-diagonal of A / 2^s and column 0; three k x k matrices.
__host__ __device__ inline size_t smem_bytes(int k, int cw, int slots) {
  return sizeof(float2) * (static_cast<size_t>(slots) * k * cw + 3 * k + 3 * static_cast<size_t>(k) * pitch(k));
}

// Wait until at most n (0 .. 3) committed copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Column 0 of exp(A), A = coeff T, into small[0, k), computed by one warp.
// da, od: the diagonal and off-diagonal of A / 2^s; m0, m1, acc: k x k
// matrices of row pitch pitch(k).
__device__ void expm_col_warp(const float* __restrict__ alphas, const float* __restrict__ betas, float cre,
                              float cim, int k, float2* da, float2* od, float2* m0, float2* m1, float2* acc,
                              float2* small) {
  const int lane = threadIdx.x & 31;
  const int p = pitch(k);
  // ||A||_1: column j holds A[j-1, j] = c beta_{j-1}, A[j, j] = c alpha_j, A[j+1, j] = c beta_j
  float norm1 = 0.f;
  for (int j = lane; j < k; j += 32) {
    float col = 0.f;
    if (j > 0) col += hypotf(cre * betas[j - 1], cim * betas[j - 1]);
    col += hypotf(cre * alphas[j], cim * alphas[j]);
    if (j + 1 < k) col += hypotf(cre * betas[j], cim * betas[j]);
    norm1 = fmaxf(norm1, col);
  }
  norm1 = warp_max(norm1);
  const float sf = fminf(fmaxf(ceilf(log2f(fmaxf(norm1, 1e-30f) / 0.5f)), 0.f), float(kMaxSquarings));
  const int nsq = static_cast<int>(sf);
  const float scale = exp2f(sf);
  for (int j = lane; j < k; j += 32) {
    da[j] = make_float2(cre * alphas[j] / scale, cim * alphas[j] / scale);
    od[j] = j + 1 < k ? make_float2(cre * betas[j] / scale, cim * betas[j] / scale) : make_float2(0.f, 0.f);
    for (int i = 0; i < k; ++i) {
      const float2 one = make_float2(i == j ? 1.f : 0.f, 0.f);
      m0[i * p + j] = one;
      m1[i * p + j] = make_float2(0.f, 0.f);
      acc[i * p + j] = one;
    }
  }
  __syncwarp();
  // Taylor: m <- m a, acc += m / n!.  m = a^n has bandwidth n, and
  // (m a)[i, j] = m[i, j-1] a[j-1, j] + m[i, j] a[j, j] + m[i, j+1] a[j+1, j];
  // the buffer written held a^(n-2), whose band lies inside a^n's.  The
  // entries (i, j) of the band are dealt to the lanes in turn.
  float fact = 1.f;
  float2* cur = m0;
  float2* nxt = m1;
  for (int term = 1; term <= kTaylorTerms; ++term) {
    fact *= static_cast<float>(term);
    const float2* __restrict__ src = cur;
    float2* __restrict__ dst = nxt;
    float2* __restrict__ sum = acc;
    const int width = min(k, 2 * term + 1);  // entries of a band row
    for (int e = lane; e < k * width; e += 32) {
      const int i = e / width;
      const int j = max(0, min(i - term, k - width)) + (e - i * width);
      if (j < i - term || j > i + term) continue;
      const float2* row = src + i * p + j;
      float2 v = make_float2(0.f, 0.f);
      if (j > 0) cfma(v, row[-1], od[j - 1]);
      cfma(v, row[0], da[j]);
      if (j + 1 < k) cfma(v, row[1], od[j]);
      dst[i * p + j] = v;
      const float2 a = sum[i * p + j];
      sum[i * p + j] = make_float2(a.x + v.x / fact, a.y + v.y / fact);
    }
    __syncwarp();
    float2* t = cur;
    cur = nxt;
    nxt = t;
  }
  // s squarings of acc; the last one needs only column 0: (acc acc)[i, 0]
  float2* src = acc;
  float2* dst = cur;
  for (int q = 0; q + 1 < nsq; ++q) {
    for (int j = lane; j < k; j += 32) {
      for (int i0 = 0; i0 < k; i0 += 4) {
        const float2* rows[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rows[r] = src + min(i0 + r, k - 1) * p;
        float2 v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = make_float2(0.f, 0.f);
#pragma unroll 2
        for (int l = 0; l < k; ++l) {
          const float2 bl = src[l * p + j];
#pragma unroll
          for (int r = 0; r < 4; ++r) cfma(v[r], rows[r][l], bl);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (i0 + r < k) dst[(i0 + r) * p + j] = v[r];
      }
    }
    __syncwarp();
    float2* t = src;
    src = dst;
    dst = t;
  }
  for (int i = lane; i < k; i += 32) {
    if (nsq == 0) {
      small[i] = src[i * p];
    } else {
      float2 v = make_float2(0.f, 0.f);
      for (int l = 0; l < k; ++l) cfma(v, src[i * p + l], src[l * p]);
      small[i] = v;
    }
  }
}

// alphas, betas: (batch, k); v: (batch, k, n); nrm: (batch,); x rows sx
// apart; out: (batch, n).  Block (bx, b) streams columns [bx stages cw,
// ...) of trajectory b, `stages` stages of cw columns, through `slots`
// stages of shared memory.
__global__ void __launch_bounds__(kThreads, 4)
lanczos_epilogue_kernel(const float* __restrict__ alphas, const float* __restrict__ betas, float cre, float cim,
                        const float2* __restrict__ v, const float* __restrict__ nrm, const float2* __restrict__ x,
                        long long sx, float2* __restrict__ out, int k, int n, int cw, int stages, int slots,
                        int vec16) {
  extern __shared__ float4 smem4[];
  float2* ring = reinterpret_cast<float2*>(smem4);
  float2* da = ring + slots * k * cw;
  float2* od = da + k;
  float2* small = od + k;
  float2* m0 = small + k;
  float2* m1 = m0 + k * pitch(k);
  float2* macc = m1 + k * pitch(k);

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const long long col0 = static_cast<long long>(blockIdx.x) * stages * cw;
  const long long col_end = min(static_cast<long long>(n), col0 + static_cast<long long>(stages) * cw);
  const int nst = static_cast<int>((col_end - col0 + cw - 1) / cw);
  const float nb = nrm[b];
  float2* ob = out + static_cast<size_t>(b) * n;
  if (!(nb > 0.f)) {  // x passes through
    const float2* xb = x + static_cast<size_t>(b) * sx;
    for (long long j = col0 + tid; j < col_end; j += kThreads) ob[j] = xb[j];
    return;
  }
  const float2* vb = v + static_cast<size_t>(b) * k * n;

  // A thread copies, and alone reads, its own units of each stage (two
  // columns with 16-byte copies, else one): units tid, tid + kThreads, ...
  // of the stage's cw columns, all k rows.  So it waits for its own copies
  // only, and refills its own slots without a block barrier.
  const int unit = vec16 ? 2 : 1;
  const int units = cw / unit;
  auto load_stage = [&](int q) {
    float2* dst = ring + (q % slots) * k * cw;
    const long long c0 = col0 + static_cast<long long>(q) * cw;
    for (int u = tid; u < units; u += kThreads) {
      const int c = u * unit;
      const bool valid = c0 + c < col_end;
      for (int i = 0; i < k; ++i) {
        const long long off = static_cast<long long>(i) * n + c0 + c;
        if (vec16) {
          cp_async16(reinterpret_cast<float4*>(dst + i * cw + c), reinterpret_cast<const float4*>(vb), off / 2, valid);
        } else {
          cp_async8(dst + i * cw + c, vb, off, valid);
        }
      }
    }
    cp_async_commit();
  };
  for (int q = 0; q < min(slots, nst); ++q) load_stage(q);
  if (tid < 32) expm_col_warp(alphas + b * k, betas + b * k, cre, cim, k, da, od, m0, m1, macc, small);
  __syncthreads();  // column 0 of the exponential

  for (int q = 0; q < nst; ++q) {
    cp_async_wait_at_most(min(nst - 1 - q, slots - 1));  // this thread's copies of stage q have landed
    const long long c0 = col0 + static_cast<long long>(q) * cw;
    const float2* stage = ring + (q % slots) * k * cw;
    for (int u = tid; u < units; u += kThreads) {
      const int c = u * unit;
      if (c0 + c >= col_end) break;
      if (vec16) {
        float2 a0 = make_float2(0.f, 0.f), a1 = make_float2(0.f, 0.f);
        for (int i = 0; i < k; ++i) {
          const float4 pair = *reinterpret_cast<const float4*>(stage + i * cw + c);
          cfma(a0, small[i], make_float2(pair.x, pair.y));
          cfma(a1, small[i], make_float2(pair.z, pair.w));
        }
        *reinterpret_cast<float4*>(ob + c0 + c) = make_float4(a0.x * nb, a0.y * nb, a1.x * nb, a1.y * nb);
      } else {
        float2 acc = make_float2(0.f, 0.f);
        for (int i = 0; i < k; ++i) cfma(acc, small[i], stage[i * cw + c]);
        ob[c0 + c] = make_float2(acc.x * nb, acc.y * nb);
      }
    }
    if (q + slots < nst) load_stage(q + slots);  // into this thread's own slots of stage q
  }
}

}  // namespace

// alphas, betas (batch, k) float; v (batch, k, n); nrm (batch,) float; out
// (batch, n), all contiguous; x (batch, n) with contiguous rows, sx elements
// apart (a start vector handed over in place, such as a site of the MPS).
// The plan (lanczos_epilogue.plan): cw, the columns of a stage (an even
// number up to 1024); stages, the stages of a block (grid.x = ceil(n /
// (stages cw))); slots, the stages in shared memory (1 .. 4).
extern "C" int lanczos_epilogue_launch(const void* alphas, const void* betas, float coeff_re, float coeff_im,
                                       const void* v, const void* nrm, const void* x, long long sx, void* out, int batch,
                                       int k, int n, int cw, int stages, int slots, void* stream) {
  if (batch <= 0 || batch > 65535 || k <= 0 || k > kMaxK || n <= 0 || cw <= 0 || cw > kMaxCols || cw % 2 != 0 ||
      stages <= 0 || slots <= 0 || slots > 4 || smem_bytes(k, cw, slots) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t configured = prepare(lanczos_epilogue_kernel, kSmemLimit);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const long long span = static_cast<long long>(stages) * cw;
  const dim3 grid(static_cast<unsigned>((n + span - 1) / span), batch);
  const int vec16 = n % 2 == 0 && reinterpret_cast<size_t>(v) % 16 == 0;
  lanczos_epilogue_kernel<<<grid, kThreads, smem_bytes(k, cw, slots), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alphas), static_cast<const float*>(betas), coeff_re, coeff_im,
      static_cast<const float2*>(v), static_cast<const float*>(nrm), static_cast<const float2*>(x), sx,
      static_cast<float2*>(out), k, n, cw, stages, slots, vec16);
  return static_cast<int>(cudaGetLastError());
}
