// Kernel K9: batched thin SVD of complex64 blocks by a rank-adaptive
// one-sided (Hestenes) Jacobi, one thread block per block.
//
// Replaces: the `jnp.linalg.svd` of yaqs_tpu/ops/decomp.py
// split_matrix_truncated (the exact split of every two-site block, (d*chi,
// d*chi) = (128, 128) at B = 32 on the analog path, (64, 64) at B = 512 in the
// digital sweeps, (d*chi, Dw*chi) = (128, 256) in the zip-up of a long-range
// gate's MPO at chi = 64) and the values-only `svd(r, compute_uv=False)` of
// yaqs_tpu/core/mps_ops.py bond_spectra ((chi, chi) = (64, 64)).
//
// What it computes: for a (rows, cols) block A with rows >= cols (the wrapper
// passes the adjoint of a wide block), A = U diag(s) V^H with s descending, U
// (rows, cols) an isometry at every rank and V (cols, cols) unitary.
//  1. Scale by the largest |Re|, |Im| and drop the rows and the columns whose
//     squared norm (scaled units) is below kTiny: the rule by which the
//     sweeps leave a column alone, so no rotation changes.  The kept
//     r_eff x c_eff block is compacted into W, or its adjoint when r_eff <
//     c_eff, so the sweeps run on n = min(r_eff, c_eff) columns, n - 1
//     rounds a sweep.  Each block finds its own sizes on the card.
//  2. Round-robin sweeps: every pair of a round at once, a group of lanes a
//     pair (16 at 128 columns, a warp up to 32), the pair's |w_p|^2,
//     |w_q|^2 and w_p^H w_q reduced by shuffles inside the group; where
//     their cosine exceeds tol the 2x2 unitary that zeroes it rotates W's and
//     V's two columns.  A sweep with no cosine above tol ends the run; so
//     does max_sweeps.  Columns whose norm^2 is below kTiny are never
//     rotated.  A block whose W does not fit one thread block's shared
//     memory (the zip-up's tall adjoints) is split by rows over a cluster of
//     four when the batch leaves SMs idle; the pair sums are then added over
//     the cluster every round.
//  3. s_j = ||w_j||, sorted.  Completion in one pass: the dropped rows give
//     U's completion columns as exact unit vectors and the dropped columns
//     Vh's; the directions left inside the kept subspace (a zero column of
//     the compacted block) come from one Householder QR of the valid columns
//     applied to unit vectors.  The completion columns follow the valid ones
//     in rank order (the split's min_keep takes U's first columns).
//
// What bounds it on the card: latency.  The blocks of the analog path are
// mostly zero (a padded left bond): about 5 x 65 nonzero of 128 x 128, so
// step 1 leaves a few rounds a sweep.  A dense (128, 128) block is about
// 10 sweeps of 127 rounds, each round a barrier, on one SM (32 of 132 at
// B = 32).  W lives in shared memory (leading dimension m + 1) when it fits,
// else split over a cluster (the zip-up's (256, 128) adjoint at B = 32) or
// in device scratch; V in the shared memory left, else in device scratch (at
// (128, 128), where its rotations stream 256 KB a round through L2).  The
// values-only mode keeps no V.  Every launch can fold its largest sweep
// count, its largest final cosine over tol and the largest and summed
// min(r_eff, c_eff) into a device-side record (atomics), read once at the
// end of a run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWideThreads = 1024;   // blocks with more than 64 columns: 16 lanes a pair at 128
constexpr int kNarrowThreads = 512;  // up to 64 columns: more blocks an SM
constexpr int kCluster = 4;          // blocks a matrix when the batch leaves SMs idle
constexpr int kSms = 132;
constexpr int kMaxDim = 128;     // columns (the short side)
constexpr int kMaxRows = 4096;   // rows (the long side)
constexpr float kTiny = 1e-30f;  // a column with ||w||^2 below it (scaled units) counts as zero

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) * b
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

// acc += conj(a) * b
__device__ __forceinline__ void cfmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the round-robin pair pi of round r over n_even slots (slot n_even - 1 stays put), p < q
__device__ __forceinline__ void rr_pair(int r, int pi, int n_even, int& p, int& q) {
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
}

// The pair's cosine (w_p^H w_q) / (|w_p| |w_q|) as (re, im), scaled before
// it is squared so that no product of small norms underflows.
__device__ __forceinline__ float2 pair_cosine(float alpha, float beta, float gr, float gi) {
  const float r = rsqrtf(alpha) * rsqrtf(beta);
  return make_float2(gr * r, gi * r);
}

// The 2x2 unitary [[c, s e], [-s conj(e), c]] that zeroes w_p^H w_q, from
// the pair's cosine k (|k| = rho > 0) and norms^2: zeta = (beta - alpha) /
// (2 |g|) = (beta - alpha) / (2 rho sqrt(alpha beta)), e = k / rho.  The
// tangent t may carry a few ulp; c = 1 / sqrt(1 + t^2), s = t c and e are
// rounded correctly, so the rotation stays unitary to an ulp: V takes about
// a thousand rotations a column at 128 columns.
__device__ __forceinline__ void rotation(float alpha, float beta, float2 k, float rho, float& c, float2& se) {
  const float zeta = __fdividef((beta - alpha) * rsqrtf(alpha) * rsqrtf(beta), 2.f * rho);
  const float az = fabsf(zeta);  // sqrt(1 + zeta^2) = |zeta| where zeta^2 would overflow
  const float t = __fdividef(copysignf(1.f, zeta), az + (az > 1e18f ? az : sqrtf(fmaf(zeta, zeta, 1.f))));
  c = __frsqrt_rn(fmaf(t, t, 1.f));
  const float f = t * c * __frcp_rn(rho);
  se = make_float2(f * k.x, f * k.y);
}

int threads_for(int cols) { return cols > 64 ? kWideThreads : kNarrowThreads; }

// a block's share of n rows when a cluster of k blocks splits them
int share(int n, int k) { return (n + k - 1) / k; }

size_t misc_bytes(int rows, int cols, int cluster) {
  const int threads = threads_for(cols), warps = threads / 32;
  return sizeof(float2) + sizeof(float4) * (cluster > 1 ? kMaxDim : 0) + sizeof(float) * (2 * threads + rows + 3 * cols + warps) +
         sizeof(int) * (2 * rows + 3 * cols + 4 + 2 * warps);
}

// How a block is laid out: W and V in shared memory when they fit, W first.
// A block W does not fit (the zip-up's tall adjoints) is split by rows over
// a cluster of kCluster blocks when the batch leaves SMs idle: a barrier a
// round over the cluster costs more than it saves where W fits one block.
struct Placement {
  int cluster;
  bool w_in_smem;
  bool v_in_smem;
  size_t smem;
};

Placement place_in(int k, int rows, int cols, bool vectors) {
  Placement p{};
  p.cluster = k;
  const size_t w = sizeof(float2) * static_cast<size_t>(cols) * (share(rows, k) + 1);
  const size_t v = sizeof(float2) * static_cast<size_t>(cols) * (share(cols, k) + 1);
  p.smem = misc_bytes(rows, cols, k);
  p.w_in_smem = p.smem + w <= kSmemLimit;
  if (p.w_in_smem) p.smem += w;
  p.v_in_smem = vectors && p.smem + v <= kSmemLimit;
  if (p.v_in_smem) p.smem += v;
  return p;
}

Placement place(int batch, int rows, int cols, bool vectors) {
  const Placement single = place_in(1, rows, cols, vectors);
  if (single.w_in_smem || batch * kCluster > 2 * kSms) return single;
  const Placement split = place_in(kCluster, rows, cols, vectors);
  return split.w_in_smem && (split.v_in_smem || !vectors) ? split : single;
}

// Stable partition of [0, n) into the indices with sq[i] >= kTiny (first,
// in order) and the rest (in order): perm[position] = index, pos[index] =
// position.  Returns the count of the first kind.  scan: 2 kWarps ints.
template <int kThreads>
__device__ int partition(const float* sq, int n, int* perm, int* pos, int* scan) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int total = 0;
  for (int base = 0; base < n; base += kThreads) total += __syncthreads_count(base + tid < n && sq[base + tid] >= kTiny);
  int kept_base = 0, drop_base = total;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool keep = i < n && sq[i] >= kTiny;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) scan[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int mine = lane < kWarps ? scan[lane] : 0;
      int v = mine;
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      if (lane < kWarps) scan[kWarps + lane] = v - mine;  // exclusive
    }
    __syncthreads();
    const int chunk_kept = scan[kWarps + kWarps - 1] + scan[kWarps - 1];
    if (i < n) {
      const int k = scan[kWarps + warp] + __popc(ballot & ((1u << lane) - 1u));
      const int p = keep ? kept_base + k : drop_base + (tid - k);
      perm[p] = i;
      pos[i] = p;
    }
    kept_base += chunk_kept;
    drop_base += min(kThreads, n - base) - chunk_kept;
    __syncthreads();
  }
  return total;
}

// kWShared: W in shared memory, so its loads and stores in the sweeps are
// shared-memory instructions, not generic ones.  kBlocks: the blocks of a
// cluster that share one matrix, each holding a contiguous share of W's and
// V's rows; a pair's three sums are added over the cluster in rank order, so
// every block takes the same rotations.  With kBlocks > 1, W and V are in
// shared memory and `work` holds a gather of W for the QR completion.
template <bool kWShared, int kThreads, int kBlocks>
__global__ void __launch_bounds__(kThreads, 1)
    svd_jacobi_kernel(const float2* __restrict__ in, long long stride_in, float2* __restrict__ u_out,
                      float* __restrict__ s_out, float2* __restrict__ vh_out, float2* __restrict__ work,
                      int* __restrict__ sweeps_out, float* __restrict__ off_out, int* __restrict__ record,
                      int rows, int cols, int v_in_smem, float tol, int max_sweeps) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float2 smem[];
  const bool vectors = u_out != nullptr;
  int rank = 0;
  if constexpr (kBlocks > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long b = blockIdx.x / kBlocks;
  float2* next = smem;
  float2* sa = nullptr;  // this block's rows of W, column-major
  if constexpr (kWShared) {
    sa = next;
    next += static_cast<size_t>(cols) * ((rows + kBlocks - 1) / kBlocks + 1);
  } else {
    sa = work + b * cols * rows;
  }
  float2* v = nullptr;  // this block's rows of V, column-major
  if (vectors && v_in_smem) {
    v = next;
    next += static_cast<size_t>(cols) * ((cols + kBlocks - 1) / kBlocks + 1);
  } else if (vectors) {
    v = work + (kWShared ? 0 : static_cast<long long>(gridDim.x) * cols * rows) + b * cols * cols;
  }
  next += (next - smem) & 1;  // 16-byte alignment for the float4 pair sums
  float4* spair = reinterpret_cast<float4*>(next);  // cluster: the pair sums of two rounds
  float* spart = reinterpret_cast<float*>(spair + (kBlocks > 1 ? kMaxDim : 0));  // 2 kThreads
  float* rowsq = spart + 2 * kThreads;
  float* colsq = rowsq + rows;
  float* ssig = colsq + cols;
  float* stau = ssig + cols;
  float* sred = stau + cols;
  int* rperm = reinterpret_cast<int*>(sred + kWarps);
  int* rpos = rperm + rows;
  int* cperm = rpos + rows;
  int* cpos = cperm + cols;
  int* sinv = cpos + cols;
  int* sflag = sinv + cols;  // [0] a pair rotated this sweep, [1] largest cosine (float bits)
  int* sscan = sflag + 4;     // 2 kWarps

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float2* src = in + b * stride_in;
  const int rc = rows * cols;
  auto cluster_sync = [] {
    if constexpr (kBlocks > 1) cg::this_cluster().sync();
  };

  // 1. scale, norms of rows and columns, compaction (every block of a
  // cluster the same)
  float mx = 0.f;
  for (int e = tid; e < rc; e += kThreads) {
    const float2 x = src[e];
    mx = fmaxf(mx, fmaxf(fabsf(x.x), fabsf(x.y)));
  }
  mx = warp_max(mx);
  if (lane == 0) sred[warp] = mx;
  __syncthreads();
  float amax = 0.f;
  for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, sred[w]);
  if (!(amax > 0.f)) amax = 1.f;
  const float inv = 1.f / amax;
  for (int i = warp; i < rows; i += kWarps) {
    float acc = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float2 x = src[static_cast<size_t>(i) * cols + c];
      const float xr = x.x * inv, xi = x.y * inv;
      acc = fmaf(xr, xr, fmaf(xi, xi, acc));
    }
    acc = warp_sum(acc);
    if (lane == 0) rowsq[i] = acc;
  }
  {
    const int parts = kThreads / cols;  // cols <= 128: at least 8
    float* part = spart;
    if (tid < parts * cols) {
      const int c = tid % cols, k = tid / cols;
      float acc = 0.f;
      for (int i = k; i < rows; i += parts) {
        const float2 x = src[static_cast<size_t>(i) * cols + c];
        const float xr = x.x * inv, xi = x.y * inv;
        acc = fmaf(xr, xr, fmaf(xi, xi, acc));
      }
      part[tid] = acc;
    }
    __syncthreads();
    if (tid < cols) {
      float acc = 0.f;
      for (int k = 0; k < parts; ++k) acc += part[k * cols + tid];
      colsq[tid] = acc;
    }
    __syncthreads();
  }
  const int r_eff = partition<kThreads>(rowsq, rows, rperm, rpos, sscan);
  const int c_eff = partition<kThreads>(colsq, cols, cperm, cpos, sscan);
  const bool trans = r_eff < c_eff;  // run on the adjoint: fewer columns
  const int m = trans ? c_eff : r_eff;
  const int n = trans ? r_eff : c_eff;
  // this block's rows: [lo, lo + ml) of W, [vlo, vlo + nl) of V
  const int lo = m * rank / kBlocks, ml = m * (rank + 1) / kBlocks - lo;
  const int vlo = n * rank / kBlocks, nl = n * (rank + 1) / kBlocks - vlo;
  const int lda = kWShared ? ml + 1 : m;
  const int ldv = v_in_smem ? nl + 1 : n;
  if (!trans) {
    for (int e = tid; e < ml * n; e += kThreads) {
      const int i = e / n, j = e % n;
      const float2 x = src[static_cast<size_t>(rperm[lo + i]) * cols + cperm[j]];
      sa[j * lda + i] = make_float2(x.x * inv, x.y * inv);
    }
  } else {
    for (int e = tid; e < ml * n; e += kThreads) {
      const int j = e / ml, i = e % ml;
      const float2 x = src[static_cast<size_t>(rperm[j]) * cols + cperm[lo + i]];
      sa[j * lda + i] = make_float2(x.x * inv, -x.y * inv);
    }
  }
  if (vectors) {
    for (int e = tid; e < nl * n; e += kThreads) {
      const int c = e / nl, i = e % nl;
      v[c * ldv + i] = make_float2(c == vlo + i ? 1.f : 0.f, 0.f);
    }
  }
  __syncthreads();

  // 2. sweeps of round-robin rounds: all n / 2 pairs of a round at once, a
  // group of `lanes` lanes a pair (a power of two, at most a warp, as many
  // as the block holds), the pair's three column sums reduced by shuffles
  // inside the group and, in a cluster, added over its blocks
  const int n_even = n + (n & 1);
  const int npairs = n_even / 2;
  int lanes = 32;
  while (lanes > 1 && lanes * npairs > kThreads) lanes >>= 1;
  const int pi = tid / lanes;  // this thread's pair
  const int lg = tid % lanes;
  int sweep = 0, parity = 0;
  float off_last = 0.f;
  while (sweep < max_sweeps) {
    if (tid == 0) {
      sflag[0] = 0;
      sflag[1] = 0;
    }
    __syncthreads();
    for (int r = 0; r < n_even - 1; ++r) {
      int p = 0, q = n;
      if (pi < npairs) rr_pair(r, pi, n_even, p, q);
      const bool real = pi < npairs && q < n;  // not the dummy column of an odd count
      float2* wp = sa + p * lda;
      float2* wq = sa + q * lda;
      float alpha = 0.f, beta = 0.f, gr = 0.f, gi = 0.f;
      if (real) {
        for (int i = lg; i < ml; i += lanes) {
          const float2 x = wp[i], y = wq[i];
          alpha = fmaf(x.x, x.x, fmaf(x.y, x.y, alpha));
          beta = fmaf(y.x, y.x, fmaf(y.y, y.y, beta));
          gr = fmaf(x.x, y.x, fmaf(x.y, y.y, gr));
          gi = fmaf(x.x, y.y, fmaf(-x.y, y.x, gi));
        }
      }
      for (int off = lanes / 2; off > 0; off >>= 1) {  // every lane takes part; groups are aligned
        alpha += __shfl_xor_sync(0xffffffffu, alpha, off);
        beta += __shfl_xor_sync(0xffffffffu, beta, off);
        gr += __shfl_xor_sync(0xffffffffu, gr, off);
        gi += __shfl_xor_sync(0xffffffffu, gi, off);
      }
      if constexpr (kBlocks > 1) {
        float4* slot = spair + parity * (kMaxDim / 2);
        if (real && lg == 0) slot[pi] = make_float4(alpha, beta, gr, gi);
        cluster_sync();
        if (real) {
          alpha = beta = gr = gi = 0.f;
          for (int k = 0; k < kBlocks; ++k) {
            const float4 t = *cg::this_cluster().map_shared_rank(slot + pi, k);
            alpha += t.x;
            beta += t.y;
            gr += t.z;
            gi += t.w;
          }
        }
        parity ^= 1;
      }
      if (real && alpha >= kTiny && beta >= kTiny) {
        const float2 k = pair_cosine(alpha, beta, gr, gi);
        const float rho = sqrtf(fmaf(k.x, k.x, k.y * k.y));
        if (lg == 0) atomicMax(&sflag[1], __float_as_int(rho));
        if (rho > tol) {
          if (lg == 0) sflag[0] = 1;
          float c;
          float2 se;
          rotation(alpha, beta, k, rho, c, se);
          // [x_p, x_q] <- [x_p, x_q] [[c, s e], [-s conj(e), c]] for W's and V's rows
          for (int i = lg; i < ml; i += lanes) {
            const float2 x = wp[i], y = wq[i];
            const float2 sy = cmulc(se, y), sx = cmul(se, x);
            wp[i] = make_float2(c * x.x - sy.x, c * x.y - sy.y);
            wq[i] = make_float2(sx.x + c * y.x, sx.y + c * y.y);
          }
          if (vectors) {
            float2* vp = v + p * ldv;
            float2* vq = v + q * ldv;
            for (int i = lg; i < nl; i += lanes) {
              const float2 x = vp[i], y = vq[i];
              const float2 sy = cmulc(se, y), sx = cmul(se, x);
              vp[i] = make_float2(c * x.x - sy.x, c * x.y - sy.y);
              vq[i] = make_float2(sx.x + c * y.x, sx.y + c * y.y);
            }
          }
        }
      }
      __syncthreads();
    }
    const int rotated = sflag[0];
    off_last = __int_as_float(sflag[1]);
    ++sweep;
    __syncthreads();
    if (!rotated) break;
  }

  // 3. singular values (norms added over the cluster in rank order), their
  // order, and (with vectors) U and Vh
  for (int c = warp; c < n; c += kWarps) {
    float nrm = 0.f;
    for (int i = lane; i < ml; i += 32) {
      const float2 x = sa[c * lda + i];
      nrm = fmaf(x.x, x.x, fmaf(x.y, x.y, nrm));
    }
    nrm = warp_sum(nrm);
    if (lane == 0) (kBlocks > 1 ? stau : ssig)[c] = nrm;
  }
  if constexpr (kBlocks > 1) {
    cluster_sync();
    if (tid < n) {
      float nrm = 0.f;
      for (int k = 0; k < kBlocks; ++k) nrm += cg::this_cluster().map_shared_rank(stau, k)[tid];
      ssig[tid] = nrm;
    }
    cluster_sync();  // no block reads another's norms past here
  }
  __syncthreads();
  if (tid < n) ssig[tid] = sqrtf(ssig[tid]);
  __syncthreads();
  const int nv = __syncthreads_count(tid < n && ssig[tid] * ssig[tid] >= kTiny);
  if (tid < n) {
    const float mine = ssig[tid];
    int pos = 0;
    for (int i = 0; i < n; ++i) {
      const float other = ssig[i];
      pos += (other > mine) || (other == mine && i < tid);
    }
    sinv[pos] = tid;
    if (rank == 0) s_out[b * cols + pos] = mine * amax;
  } else if (tid < cols && rank == 0) {
    s_out[b * cols + tid] = 0.f;
  }
  if (tid == 0 && rank == 0) {
    if (sweeps_out != nullptr) sweeps_out[b] = sweep;
    if (off_out != nullptr) off_out[b] = off_last;
    if (record != nullptr) {  // non-negative floats order as their bits
      atomicMax(&record[0], sweep);
      atomicMax(&record[1], __float_as_int(off_last / tol));
      atomicMax(&record[2], n);
      auto* sums = reinterpret_cast<unsigned long long*>(record + 4);
      atomicAdd(&sums[0], static_cast<unsigned long long>(n));
      atomicAdd(&sums[1], 1ull);
    }
  }
  if (!vectors) return;
  __syncthreads();
  for (int e = tid; e < ml * n; e += kThreads) {
    const int c = e / ml;
    const float sg = ssig[c];
    if (sg * sg >= kTiny) {
      float2& x = sa[c * lda + e % ml];
      x.x /= sg;
      x.y /= sg;
    }
  }
  __syncthreads();

  // The square side is V_x (n x n unitary) on n kept indices, then unit
  // vectors of the dropped ones; the W side is the nv valid columns of W on
  // m kept indices, then unit vectors of the dropped ones, then QR
  // directions inside the kept ones (written below, by one block).  U is
  // the W side (rows) and V the square side (columns), or the other way
  // round for the adjoint.  A block writes the output rows its share holds
  // and a share of the dropped ones.
  const int w_dim = trans ? cols : rows;
  const int n_qr = (cols - nv) - (w_dim - m);
  auto owner = [&](int p, int kept) {  // the block holding row p of a side with `kept` kept rows
    if (p >= kept) return (p - kept) % kBlocks;
    int o = 0;
    while (o + 1 < kBlocks && kept * (o + 1) / kBlocks <= p) ++o;
    return o;
  };
  // value of a side's output column r at index i (dim indices, kept first);
  // false where this block does not write it
  auto square_side = [&](int i, int r, const int* perm, const int* pos, float2& x) {
    const int p = pos[i];
    if (owner(p, n) != rank) return false;
    if (r < n) {
      x = p < n ? v[sinv[r] * ldv + (p - vlo)] : make_float2(0.f, 0.f);
    } else {
      x = make_float2(i == perm[r] ? 1.f : 0.f, 0.f);  // perm[n + (r - n)]: the (r - n)-th dropped
    }
    return true;
  };
  auto w_side = [&](int i, int r, const int* perm, const int* pos, int dim, float2& x) {
    const int p = pos[i];
    if (owner(p, m) != rank || r >= nv + (dim - m)) return false;  // a QR direction: below
    if (r < nv) {
      x = p < m ? sa[sinv[r] * lda + (p - lo)] : make_float2(0.f, 0.f);
    } else {
      x = make_float2(i == perm[m + r - nv] ? 1.f : 0.f, 0.f);
    }
    return true;
  };
  float2* u = u_out + b * rc;
  for (int e = tid; e < rc; e += kThreads) {
    const int i = e / cols, r = e % cols;
    float2 x;
    if (trans ? square_side(i, r, rperm, rpos, x) : w_side(i, r, rperm, rpos, rows, x)) u[e] = x;
  }
  float2* vh = vh_out + b * cols * cols;
  for (int e = tid; e < cols * cols; e += kThreads) {
    const int r = e / cols, i = e % cols;
    float2 x;
    if (trans ? w_side(i, r, cperm, cpos, cols, x) : square_side(i, r, cperm, cpos, x)) vh[e] = make_float2(x.x, -x.y);
  }
  if (n_qr <= 0) return;

  // Householder QR of the valid columns (in rank order, in place) by one
  // block: in a cluster, on a gather of W's rows in `work`.  Reflector k is
  // u_k = x + phase ||x|| e_k on rows k..m-1, H_k = 1 - tau_k u_k u_k^H.
  float2* qa = sa;
  int ldq = lda;
  if constexpr (kBlocks > 1) {
    qa = work + b * rows * cols;
    ldq = m;
    for (int e = tid; e < ml * n; e += kThreads) qa[(e / ml) * ldq + lo + e % ml] = sa[(e / ml) * lda + e % ml];
    cluster_sync();
    if (rank != 0) return;
  }
  __syncthreads();
  for (int k = 0; k < nv; ++k) {
    float2* x = qa + sinv[k] * ldq;
    if (warp == 0) {
      float nrm = 0.f;
      for (int i = k + lane; i < m; i += 32) nrm = fmaf(x[i].x, x[i].x, fmaf(x[i].y, x[i].y, nrm));
      nrm = sqrtf(warp_sum(nrm));
      const float2 x0 = x[k];
      const float a0 = hypotf(x0.x, x0.y);
      const float2 phase = a0 > 0.f ? make_float2(x0.x / a0, x0.y / a0) : make_float2(1.f, 0.f);
      if (lane == 0) {
        x[k] = make_float2(x0.x + phase.x * nrm, x0.y + phase.y * nrm);
        stau[k] = 1.f / (nrm * (nrm + a0));  // 2 / ||u||^2, ||u||^2 = 2 nrm (nrm + |x0|)
      }
    }
    __syncthreads();
    for (int c = k + 1 + warp; c < nv; c += kWarps) {
      float2* y = qa + sinv[c] * ldq;
      float2 d = make_float2(0.f, 0.f);
      for (int i = k + lane; i < m; i += 32) cfmac(d, x[i], y[i]);
      d = make_float2(warp_sum(d.x) * stau[k], warp_sum(d.y) * stau[k]);
      for (int i = k + lane; i < m; i += 32) {
        const float2 t = cmul(x[i], d);
        y[i].x -= t.x;
        y[i].y -= t.y;
      }
    }
    __syncthreads();
  }
  // completion t = Q e_(nv + t) = H_0 ... H_(nv-1) e_(nv + t), a warp a
  // column, held in its output column (conjugated in Vh), zero on the
  // dropped indices
  const int* w_perm = trans ? cperm : rperm;
  for (int t = warp; t < n_qr; t += kWarps) {
    const int r = nv + (w_dim - m) + t;
    auto at = [&](int p) -> float2* { return trans ? vh + static_cast<size_t>(r) * cols + w_perm[p]
                                                   : u + static_cast<size_t>(w_perm[p]) * cols + r; };
    for (int p = lane; p < w_dim; p += 32) *at(p) = make_float2(p == nv + t ? 1.f : 0.f, 0.f);
    __syncwarp();
    for (int k = nv - 1; k >= 0; --k) {
      const float2* x = qa + sinv[k] * ldq;
      float2 d = make_float2(0.f, 0.f);
      for (int p = k + lane; p < m; p += 32) {
        float2 y = *at(p);
        if (trans) y.y = -y.y;
        cfmac(d, x[p], y);
      }
      d = make_float2(warp_sum(d.x) * stau[k], warp_sum(d.y) * stau[k]);
      for (int p = k + lane; p < m; p += 32) {
        float2 y = *at(p);
        if (trans) y.y = -y.y;
        const float2 tt = cmul(x[p], d);
        y.x -= tt.x;
        y.y -= tt.y;
        if (trans) y.y = -y.y;
        *at(p) = y;
      }
      __syncwarp();
    }
  }
}


template <bool kWShared, int kThreads, int kBlocks>
cudaError_t launch(const Placement& p, int batch, cudaStream_t stream, const float2* in, long long stride_in,
                   float2* u_out, float* s_out, float2* vh_out, float2* work, int* sweeps_out, float* off_out,
                   int* record, int rows, int cols, float tol, int max_sweeps) {
  auto kernel = svd_jacobi_kernel<kWShared, kThreads, kBlocks>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  if constexpr (kBlocks == 1) {
    kernel<<<batch, kThreads, p.smem, stream>>>(in, stride_in, u_out, s_out, vh_out, work, sweeps_out, off_out,
                                                 record, rows, cols, p.v_in_smem ? 1 : 0, tol, max_sweeps);
    return cudaSuccess;
  }
  cudaLaunchAttribute attribute[1];
  const cudaLaunchConfig_t config = cluster_config(batch, kBlocks, kThreads, p.smem, stream, attribute);
  return cudaLaunchKernelEx(&config, kernel, in, stride_in, u_out, s_out, vh_out, work, sweeps_out, off_out, record,
                            rows, cols, p.v_in_smem ? 1 : 0, tol, max_sweeps);
}

}  // namespace

// Complex64 elements of device scratch the launch needs: W and V where they
// do not fit in shared memory, or, in a cluster, W's gather for the QR
// completion; 0 when none is needed.
extern "C" long long svd_jacobi_workspace(int batch, int rows, int cols, int vectors) {
  const Placement p = place(batch, rows, cols, vectors != 0);
  const long long w = p.cluster > 1 ? (vectors ? static_cast<long long>(batch) * rows * cols : 0)
                                    : (p.w_in_smem ? 0 : static_cast<long long>(batch) * cols * rows);
  const long long v = vectors && !p.v_in_smem ? static_cast<long long>(batch) * cols * cols : 0;
  return w + v;
}


// in: batch row-major (rows, cols) blocks, cols <= rows, stride_in elements
// apart; u_out (batch, rows, cols), s_out (batch, cols), vh_out (batch, cols,
// cols), contiguous, or u_out = vh_out = null for values only; work the
// scratch svd_jacobi_workspace asks for (or null); sweeps_out (batch,) int32
// and off_out (batch,) float32 (the largest cosine |w_p^H w_q| / (||w_p||
// ||w_q||) of the last sweep), each optional; record (8,) int32, optional:
// [0] the most sweeps, [1] the largest final cosine over tol (float bits),
// [2] the largest min(r_eff, c_eff), [4:6] their sum and [6:8] the blocks
// counted (unsigned 64-bit each), over every launch since it was zeroed.
extern "C" int svd_jacobi_launch(const void* in, long long stride_in, void* u_out, void* s_out, void* vh_out,
                                 void* work, void* sweeps_out, void* off_out, void* record, int batch, int rows,
                                 int cols, float tol, int max_sweeps, void* stream) {
  if (batch <= 0 || cols <= 0 || rows < cols || cols > kMaxDim || rows > kMaxRows || max_sweeps <= 0 ||
      (u_out == nullptr) != (vh_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vectors = u_out != nullptr;
  const Placement p = place(batch, rows, cols, vectors);
  if (p.smem > kSmemLimit || (svd_jacobi_workspace(batch, rows, cols, vectors) > 0 && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* x = static_cast<const float2*>(in);
  auto* u = static_cast<float2*>(u_out);
  auto* s = static_cast<float*>(s_out);
  auto* vh = static_cast<float2*>(vh_out);
  auto* w = static_cast<float2*>(work);
  auto* sw = static_cast<int*>(sweeps_out);
  auto* off = static_cast<float*>(off_out);
  auto* rec = static_cast<int*>(record);
  auto st = static_cast<cudaStream_t>(stream);
  const bool wide = threads_for(cols) == kWideThreads;
  cudaError_t err;
  if (p.cluster > 1) {
    err = wide ? launch<true, kWideThreads, kCluster>(p, batch, st, x, stride_in, u, s, vh, w, sw, off, rec, rows, cols,
                                                      tol, max_sweeps)
               : launch<true, kNarrowThreads, kCluster>(p, batch, st, x, stride_in, u, s, vh, w, sw, off, rec, rows,
                                                        cols, tol, max_sweeps);
  } else if (p.w_in_smem) {
    err = wide ? launch<true, kWideThreads, 1>(p, batch, st, x, stride_in, u, s, vh, w, sw, off, rec, rows, cols, tol,
                                               max_sweeps)
               : launch<true, kNarrowThreads, 1>(p, batch, st, x, stride_in, u, s, vh, w, sw, off, rec, rows, cols, tol,
                                                 max_sweeps);
  } else {
    err = wide ? launch<false, kWideThreads, 1>(p, batch, st, x, stride_in, u, s, vh, w, sw, off, rec, rows, cols, tol,
                                                max_sweeps)
               : launch<false, kNarrowThreads, 1>(p, batch, st, x, stride_in, u, s, vh, w, sw, off, rec, rows, cols,
                                                  tol, max_sweeps);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
