// Kernel K7: gauge-free per-site moment matrices of a batch of MPS,
//   T[b, i, s, k] = <psi_b| (|s><k|)_i |psi_b>,  norm2[b] = <psi_b|psi_b>,
// for tensors (B, L, d, chi, chi) complex64 in any gauge and norm.
//
// Replaces: yaqs_tpu/core/mps_ops.py left_gram_environments,
// right_gram_environments, transfer_right and site_moment_matrices (the XLA
// chain K7, mps_ops.py:369-414).  On the digital path it feeds the per-gate
// jump weights (B = 512, L = 20, chi = 32); on the analog path the jump
// sampler and the gauge-free observables (B = 32, L = 100, chi = 64).
//
// What it computes, exactly as mps_ops.py: a left Gram scan
//   E_0 = 1,  E_{i+1}[rb, rk] = sum conj(A_i[s, lb, rb]) E_i[lb, lk] A_i[s, lk, rk],
// a right Gram scan
//   R_{L-1} = 1,  R_{i-1}[l, m] = sum conj(A_i[s, l, r]) A_i[s, m, t] R_i[r, t],
// then T_i[s, k] = sum conj(A_i[s, l, r]) (E_i A_i[k] R_i^T)[l, r] and
// norm2 = trace(E_L).  With X_s = A_i[s]^T the right step is the left one,
// R_{i-1} = sum_s X_s^H R_i X_s, so one scan routine serves both: it reads
// the site through a pair of strides (row, column) or (column, row).
//
// What bounds it on the card: arithmetic.  Each scan step is two complex
// products of d chi^3 multiply-adds, each moment 2 d chi^3 more, so
// 6 d chi^3 complex MACs (8 real flops each) per site and trajectory:
// 81 GFLOP at the analog shape (1.2 ms at 67 TFLOP/s fp32) and 32 GFLOP at
// the digital one (0.48 ms).  The scans are sequential over sites, so at
// B = 32 only 64 chains exist to fill 132 SMs; a step is two products of
// about 0.5 M complex MACs, a few microseconds of one SM.
//
// Design: two launches.
//  (1) gram_scan_cluster_kernel<C>: each (trajectory, direction) chain runs
//      on a thread block cluster of C blocks, C the largest of 4, 3 and 2
//      whose clusters the card holds all at once for the 2 B chains
//      (moment_scan_max_clusters, the wrapper's rule), else 1.  Block r owns
//      the columns [r cs, r cs + w) of the environment, cs = ceil(chi / C):
//        tmp[s, lb, j] = sum_lk E[lb, lk] X_s[lk, c0 + j]     (chi x d w)
//        E'[rb, c0 + j] = sum_(s, lb) conj(X_s[lb, rb]) tmp[s, lb, j]
//      from the whole E and the whole site, so each output is summed whole
//      by one thread, in the same order for every C: no partial sums cross
//      the cluster.  The blocks then gather the other columns of E' through
//      distributed shared memory from a double-buffered slot, one cluster
//      barrier a step (226 KB of shared memory at C = 2, chi = 64, one
//      block an SM).  The next site is copied by cp.async into a second
//      buffer while the current one is contracted; its rows are padded to
//      chi + 1 elements so that both strides are free of bank conflicts (at
//      a stride of chi, the right scan's column walks would put a warp's
//      loads in one bank, 16 ways).
//      Where two site buffers do not fit in shared memory (d chi^2 large, or
//      C = 1 at chi = 64), one buffer is reloaded after the step's products,
//      during the barrier and the gather; where a tmp of d blocks does not
//      fit, the step runs s by s, the E' sums added in place by the thread
//      that owns them.
//  (2) moments_kernel, grid (L, B): one block per site and trajectory loads
//      E_i, R_i (rows padded, read by columns) and A_i, forms P = E_i A_i[k]
//      in shared memory and folds the conjugated bra tensor into the
//      epilogue of P R_i^T, so Q is never stored; a warp-shuffle reduction
//      then writes T.
// Products are ns_polar.cuh's (K4-K6's): a register tile of TM x 4 complex
// outputs a thread (TM = 8, 4 or 2 by size), consecutive threads on
// consecutive columns, the A rows broadcast, with plain FP32 FMAs (TF32 off).

#include "ns_polar.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = kNsThreads;  // the block size the products' tile choice assumes
constexpr int kMaxChi = 64;
constexpr int kMaxD = 4;
constexpr int kWarps = kThreads / 32;

// True when no product of a (d, chi) chain takes a tile of more than 2 rows
// (the widest is the scan's first, chi x d chi at C = 1): the kernels are
// then built with kTM = 2, which computes the same sums in the same threads
// with fewer registers, so more blocks share an SM.
__host__ __device__ constexpr bool fits_small_tiles(int d, int chi) { return ns_fits_small_tiles(chi, d * chi); }

// Shared memory of a scan block, in float2: `stages` site buffers of d chi
// rows of chi + 1, the environment (chi x chi), tmp (sd blocks of chi x cs:
// the s values contracted at once), and the slot that E' is summed into
// (two of chi x cs with a cluster, one of chi x chi without).
struct ScanLayout {
  int stages, sd, site, env, tmp, slot;
  __host__ __device__ ScanLayout(int d, int chi, int c, int stages_, int sd_) : stages(stages_), sd(sd_) {
    const int cs = (chi + c - 1) / c;
    site = d * chi * (chi + 1);
    env = chi * chi;
    tmp = sd * chi * cs;
    slot = c > 1 ? 2 * chi * cs : chi * chi;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float2) * (static_cast<size_t>(stages) * site + env + tmp + slot);
  }
};

// The layout a chain of (d, chi) takes on clusters of c blocks: two site
// buffers and all d blocks of tmp where they fit, else one site buffer,
// else the s values one at a time.  stages = 0: nothing fits.  (Two site
// buffers with one s at a time never fit where one buffer with all d does:
// a site is larger than d - 1 blocks of tmp.)
__host__ __device__ inline ScanLayout scan_layout(int d, int chi, int c) {
  const int tries[3][2] = {{2, d}, {1, d}, {1, 1}};
  for (const auto& t : tries) {
    const ScanLayout ly(d, chi, c, t[0], t[1]);
    if (ly.bytes() <= kSmemLimit) return ly;
  }
  return ScanLayout(d, chi, c, 0, 1);
}

// Copy site A (d, chi, chi) into a shared buffer whose rows are chi + 1 long.
__device__ __forceinline__ void load_site(float2* dst, const float2* src, int d, int chi) {
  const int cc = chi * chi;
  for (int e = threadIdx.x; e < d * cc; e += blockDim.x) {
    const int row = e / chi;  // (s, p)
    cp_async8(dst + row * (chi + 1) + (e - row * chi), src + e);
  }
  cp_async_commit();
}

// envs: (2, B, L, chi, chi), direction-major; norm2: (B,).  Grid: 2 B C
// blocks, clusters of kC; cluster u takes direction u / B, trajectory u % B.
template <int kC, int kTM>
__global__ void __launch_bounds__(kThreads, kTM == 2 ? 3 : 1)
gram_scan_cluster_kernel(const float2* __restrict__ t, float2* __restrict__ envs, float* __restrict__ norm2,
                         int batch, int L, int d, int chi, int stages, int sd) {
  extern __shared__ float4 smem4[];
  int rank = 0;
  if constexpr (kC > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int u = blockIdx.x / kC;
  const bool left = u < batch;
  const int b = left ? u : u - batch;
  const int cc = chi * chi, pitch = chi + 1, sp = chi * pitch;  // sp: one s block of the padded site
  const int cs = (chi + kC - 1) / kC, c0 = min(rank * cs, chi), w = min(cs, chi - c0);
  const ScanLayout ly(d, chi, kC, stages, sd);
  float2* site_buf = reinterpret_cast<float2*>(smem4);
  float2* env = site_buf + stages * ly.site;
  float2* tmp = env + ly.env;
  float2* slot = tmp + ly.tmp;
  // X_s[p, q] = site[s sp + p xi + q xj]: A_s itself (left) or its transpose (right)
  const int xi = left ? pitch : 1, xj = left ? 1 : pitch;
  const size_t site_elems = static_cast<size_t>(d) * cc;
  const float2* tb = t + static_cast<size_t>(b) * L * site_elems;
  float2* eb = envs + (static_cast<size_t>(left ? 0 : 1) * batch + b) * L * cc;
  const int rows = (chi + kC - 1) / kC, r0 = min(rank * rows, chi), rn = min(rows, chi - r0);

  // a chain of L steps; the right scan's last (site 0) contracts nothing
  const int work = left ? L : L - 1;
  auto site_of = [&](int step) { return left ? step : L - 1 - step; };
  for (int e = threadIdx.x; e < cc; e += blockDim.x) env[e] = make_float2(e / chi == e % chi ? 1.f : 0.f, 0.f);
  if (work > 0) load_site(site_buf, tb + site_of(0) * site_elems, d, chi);
  int cur = 0;
  for (int step = 0; step < L; ++step) {
    const int i = site_of(step);
    __syncthreads();  // env complete
    for (int e = threadIdx.x; e < rn * chi; e += blockDim.x) {
      eb[static_cast<size_t>(i) * cc + r0 * chi + e] = env[r0 * chi + e];
    }
    if (step >= work) break;
    const bool next = step + 1 < work;
    if (stages == 2 && next) {
      load_site(site_buf + (cur ^ 1) * ly.site, tb + site_of(step + 1) * site_elems, d, chi);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float2* x = site_buf + cur * ly.site;
    float2* out = kC > 1 ? slot + (step & 1) * chi * cs : slot;
    for (int s0 = 0; s0 < d; s0 += sd) {
      const int ns = min(sd, d - s0);
      // tmp[(s, lb), j] = sum_lk E[lb, lk] X_(s0+s)[lk, c0 + j]; columns n = (s, j)
      product<false, kTM>(
          env, [&](int i_) { return i_ * chi; }, 0, 1, x + s0 * sp,
          [&](int n) { return (n / w) * sp + (c0 + n % w) * xj; }, 0, xi, chi, ns * w, 1, chi,
          [&](int lb, int n, float2 v) { tmp[((n / w) * chi + lb) * w + n % w] = v; });
      __syncthreads();
      // out[rb, j] (+)= sum_(s, lb) conj(X_(s0+s)[lb, rb]) tmp[(s, lb), j]
      product<true, kTM>(
          x + s0 * sp, [&](int rb) { return rb * xj; }, sp, xi, tmp, [](int j) { return j; }, chi * w, w, chi, w,
          ns, chi, [&](int rb, int j, float2 v) {
            float2* o = out + rb * (kC > 1 ? w : chi) + (kC > 1 ? 0 : c0) + j;
            if (s0 == 0) {
              *o = v;
            } else {
              const float2 p = *o;
              *o = make_float2(p.x + v.x, p.y + v.y);
            }
          });
      __syncthreads();
    }
    if (stages == 1 && next) load_site(site_buf, tb + site_of(step + 1) * site_elems, d, chi);
    if constexpr (kC > 1) {
      // gather E' = the blocks' column slices, from slot (step & 1) of each
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      const float2* part[kC];
#pragma unroll
      for (int k = 0; k < kC; ++k) part[k] = cl.map_shared_rank(slot + (step & 1) * chi * cs, k);
      constexpr int kU = 4;  // remote loads in flight a thread
      for (int e0 = threadIdx.x; e0 < cc; e0 += kU * blockDim.x) {
        float2 v[kU];
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int e = min(e0 + q * static_cast<int>(blockDim.x), cc - 1);
          const int rb = e / chi, col = e - rb * chi, k = col / cs, j = col - k * cs;
          const float2* src = part[0];
#pragma unroll
          for (int kk = 1; kk < kC; ++kk) {
            if (k == kk) src = part[kk];
          }
          v[q] = src[rb * min(cs, chi - k * cs) + j];
        }
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int e = e0 + q * static_cast<int>(blockDim.x);
          if (e < cc) env[e] = v[q];
        }
      }
    } else {
      float2* swap = env;
      env = slot;
      slot = swap;
    }
    if (stages == 2) cur ^= 1;
  }
  __syncthreads();
  if (left && rank == 0 && threadIdx.x == 0) {
    float tr = 0.f;
    for (int e = 0; e < chi; ++e) tr += env[e * chi + e].x;
    norm2[b] = tr;
  }
  if constexpr (kC > 1) cg::this_cluster().sync();  // no block leaves while another reads its slots
}

// T: (B, L, d, d)
template <int kTM>
__global__ void __launch_bounds__(kThreads, kTM == 2 ? 4 : 1)
moments_kernel(const float2* __restrict__ t, const float2* __restrict__ envs, float2* __restrict__ out, int B, int L,
               int d, int chi) {
  extern __shared__ float4 smem4[];
  __shared__ float2 red[kWarps][kMaxD];
  const int cc = chi * chi, pitch = chi + 1;
  float2* sl = reinterpret_cast<float2*>(smem4);  // E_i
  float2* sr = sl + cc;                           // R_i, rows of chi + 1
  float2* sp = sr + chi * pitch;                  // E_i A_i[k]
  float2* ssite = sp + cc;                        // A_i
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const size_t site_elems = static_cast<size_t>(d) * cc;
  const float2* left = envs + (static_cast<size_t>(b) * L + i) * cc;
  const float2* right = envs + ((static_cast<size_t>(B) + b) * L + i) * cc;
  const float2* site = t + (static_cast<size_t>(b) * L + i) * site_elems;
  for (int e = threadIdx.x; e < cc; e += blockDim.x) {
    cp_async8(sl + e, left + e);
    cp_async8(sr + (e / chi) * pitch + e % chi, right + e);
  }
  for (int e = threadIdx.x; e < site_elems; e += blockDim.x) cp_async8(ssite + e, site + e);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int k = 0; k < d; ++k) {
    // P[l, s] = sum_m E[l, m] A[k, m, s]
    product<false, kTM>(
        sl, [&](int l) { return l * chi; }, 0, 1, ssite + k * cc, [](int s) { return s; }, 0, chi, chi, chi, 1, chi,
        [&](int l, int s, float2 v) { sp[l * chi + s] = v; });
    __syncthreads();
    // T[bb, k] = sum_(l, r) conj(A[bb, l, r]) (P R^T)[l, r]
    float2 part[kMaxD];
#pragma unroll
    for (int bb = 0; bb < kMaxD; ++bb) part[bb] = make_float2(0.f, 0.f);
    product<false, kTM>(
        sp, [&](int l) { return l * chi; }, 0, 1, sr, [&](int r) { return r * pitch; }, 0, 1, chi, chi, 1, chi,
        [&](int l, int r, float2 v) {
#pragma unroll
          for (int bb = 0; bb < kMaxD; ++bb) {
            if (bb < d) cfma(part[bb], conj2(ssite[bb * cc + l * chi + r]), v);
          }
        });
#pragma unroll
    for (int bb = 0; bb < kMaxD; ++bb) {
      float x = part[bb].x, y = part[bb].y;
      for (int off = 16; off > 0; off >>= 1) {
        x += __shfl_down_sync(0xffffffffu, x, off);
        y += __shfl_down_sync(0xffffffffu, y, off);
      }
      if (lane == 0) red[warp][bb] = make_float2(x, y);
    }
    __syncthreads();
    if (threadIdx.x < d) {
      const int bb = threadIdx.x;
      float2 acc = make_float2(0.f, 0.f);
      for (int w = 0; w < kWarps; ++w) {
        acc.x += red[w][bb].x;
        acc.y += red[w][bb].y;
      }
      out[((static_cast<size_t>(b) * L + i) * d + bb) * d + k] = acc;
    }
    __syncthreads();  // sp and red are rewritten for the next k
  }
}

size_t moments_smem(int d, int chi) {
  return sizeof(float2) * (static_cast<size_t>(chi) * (chi + 1) + (2 + static_cast<size_t>(d)) * chi * chi);
}

template <int kC, int kTM>
const void* scan_kernel() {
  return reinterpret_cast<const void*>(gram_scan_cluster_kernel<kC, kTM>);
}

const void* scan_kernel_for(int cluster, bool small) {
  return cluster == 4   ? scan_kernel<4, 8>()
         : cluster == 3 ? scan_kernel<3, 8>()
         : cluster == 2 ? scan_kernel<2, 8>()
         : small        ? scan_kernel<1, 2>()
                        : scan_kernel<1, 8>();
}

}  // namespace

// The clusters of `cluster` blocks (2, 3 or 4) of the Gram scan at (d, chi)
// that the card holds at once (cudaOccupancyMaxActiveClusters), or minus a
// CUDA error.
extern "C" int moment_scan_max_clusters(int d, int chi, int cluster) {
  if (cluster < 2 || cluster > 4 || d <= 0 || d > kMaxD || chi <= 0 || chi > kMaxChi) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const ScanLayout ly = scan_layout(d, chi, cluster);
  if (ly.stages == 0) return 0;
  const void* kernel = scan_kernel_for(cluster, false);
  cudaError_t err = prepare(kernel, ly.bytes());
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(1, cluster, kThreads, ly.bytes(), nullptr, attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &config);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

// t (B, L, d, chi, chi), envs scratch (2, B, L, chi, chi), out (B, L, d, d),
// norm2 (B,) float; cluster: the Gram scan's blocks a chain, 1 to 4 (the
// wrapper's rule).  A cluster the card cannot place is an error, never a
// fall back to another size.
extern "C" int moment_scan_launch(const void* t, void* envs, void* out, void* norm2, int batch, int L, int d,
                                  int chi, int cluster, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || d <= 0 || d > kMaxD || chi <= 0 || chi > kMaxChi || cluster < 1 ||
      cluster > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool small = fits_small_tiles(d, chi);
  const ScanLayout ly = scan_layout(d, chi, cluster);
  const size_t mom_smem = moments_smem(d, chi);
  if (ly.stages == 0 || mom_smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const void* scan = scan_kernel_for(cluster, small);
  cudaError_t err = prepare(scan, ly.bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(2 * batch, cluster, kThreads, ly.bytes(), st, attr);
  const auto* tp = static_cast<const float2*>(t);
  auto* ep = static_cast<float2*>(envs);
  auto* op = static_cast<float2*>(out);
  auto* np = static_cast<float*>(norm2);
  int stages = ly.stages, sd = ly.sd;
  void* scan_args[] = {&tp, &ep, &np, &batch, &L, &d, &chi, &stages, &sd};
  err = cudaLaunchKernelExC(&config, scan, scan_args);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* moments = small ? reinterpret_cast<const void*>(moments_kernel<2>)
                              : reinterpret_cast<const void*>(moments_kernel<8>);
  err = prepare(moments, mom_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* mom_args[] = {&tp, &ep, &op, &batch, &L, &d, &chi};
  err = cudaLaunchKernel(moments, dim3(L, batch), dim3(kThreads), mom_args, mom_smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
