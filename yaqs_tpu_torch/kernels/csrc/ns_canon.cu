// Kernel K6: the Newton canonicalization scan of a batch of padded MPS,
// each trajectory's chain walked from right to left on a thread block
// cluster of C blocks (C = 1: one block).
//
// Replaces: yaqs_tpu/core/mps_ops.py canonicalize_right(method="newton")
// (:240-250, the XLA chain K6): on the fast knob set every canonicalization
// of the jump step and of the digital half-layers.
//
// What it computes, for tensors (L, d, chi, chi) and the carry c = 1, at
// each site i = L-1 ... 1 (exactly the JAX scan):
//   t[s, l, m] = sum_r A_i[s, l, r] c[r, m]        absorb the carry
//   M[l, (s, m)] = t[s, l, m]                       the (chi, d chi) block
//   x = NS(M^H)                                     (d chi, chi) isometry
//   out_i[s, l, m] = conj(x[(s, m), l])             the site, x^H
//   c = M x                                         the next carry
// then out_0 = A_0 c, and the contraction-unreachable boundary pads
// (out_0[:, 1:, :] and out_{L-1}[:, :, 1:]) are zeroed.
//
// What bounds it on the card: arithmetic.  Each site takes one polar factor
// of 22 * (d chi) * chi * chi complex MACs and two products of d chi^3:
// 12.6 M complex MACs a site at chi = 64, 99 sites and 32 trajectories,
// against 2 * 52 MB of device traffic.  The scan is sequential over sites,
// so one block a trajectory puts the analog B = 32 on 32 of 132 SMs.
//
// Design.  The launch takes C blocks a trajectory, by the wrapper's rule
// (K5's): the largest of 4, 3 and 2 whose clusters the card holds all at
// once for the whole batch (ns_canon_max_clusters), else 1.  Block r holds
// the rows [r nl, r nl + rn) of M^H (d chi rows, nl = ceil(d chi / C)):
//  - the absorb forms only those rows, from the whole carry and the site's
//    d blocks read from device memory (L2);
//  - the polar factor is ns_polar_rows<C> of ns_polar.cuh, the schedule of
//    K4 and K5, its Gram of every step an all-reduce of the blocks' partial
//    sums through distributed shared memory, added in rank order;
//  - the carry c = M x = (M^H)^H x is the same kind of sum over the rows:
//    each block's partial, added over the cluster in rank order, so every
//    block holds the same c for the next site (the Gram's slot, free after
//    the polar factor's last step, and one cluster barrier);
//  - each block writes its rows of x as the columns of out_i.
// Shared memory a block: M^H, x, x g (rn x chi each), g (which holds the
// carry between sites, and the polar factor's scale scratch) and, with a
// cluster, the two Gram partials (chi x chi each): 160 KB at C = 3, chi = 64.
// At C = 1 (the digital B = 512, which fills the card) a block needs 56 KB
// at chi = 32, and the kernel is built with tiles of at most 2 rows where
// its products take no taller ones (ns_fits_small_tiles), and with the
// polar factor's smallest tensor-core tile: with the taller tiles built in
// it holds 195 registers a thread, one block an SM, while four blocks of
// 56 KB fit in shared memory.  The polar factor's products run on the
// tensor cores in 3xTF32 (ns_polar.cuh); the absorb and the carry on its
// FP32 product.

#include "ns_polar.cuh"

namespace {

namespace cg = cooperative_groups;

// Shared memory of a block, in float2: M^H, x, x g (rows x chi each), g
// (at least the scale's scratch), and with a cluster the Gram partials.
struct CanonLayout {
  int rows, g, part;
  __host__ __device__ CanonLayout(int d, int chi, int c) {
    rows = (d * chi + c - 1) / c * chi;
    g = chi * chi > (ns_scratch_floats(chi) + 1) / 2 ? chi * chi : (ns_scratch_floats(chi) + 1) / 2;
    part = c > 1 ? chi * chi : 0;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float2) * (3 * static_cast<size_t>(rows) + g + 2 * part); }
};

template <int kC, int kTM>
__global__ void __launch_bounds__(kNsThreads, kTM == 2 ? 4 : 1)
ns_canon_kernel(const float2* __restrict__ in, float2* __restrict__ out, int L, int d, int chi) {
  extern __shared__ float4 smem4[];
  int rank = 0;
  if constexpr (kC > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int dchi = d * chi;
  const int cc = chi * chi;
  const int nl = (dchi + kC - 1) / kC, r0 = min(rank * nl, dchi), rn = min(nl, dchi - r0);
  const CanonLayout ly(d, chi, kC);
  float2* smh = reinterpret_cast<float2*>(smem4);  // (rn, chi): this block's rows of M^H
  float2* sx = smh + ly.rows;                      // (rn, chi): M^H, then x
  float2* sxg = sx + ly.rows;                      // (rn, chi): the polar factor's x g
  float2* sg = sxg + ly.rows;                      // (chi, chi): g; the carry between sites
  float2* part = sg + ly.g;                        // 2 x (chi, chi): Gram partials (kC > 1)
  float* scratch = reinterpret_cast<float*>(sg);
  const size_t site = static_cast<size_t>(d) * cc;
  const long long b = blockIdx.x / kC;
  const float2* tz = in + b * L * site;
  float2* oz = out + b * L * site;

  for (int e = threadIdx.x; e < cc; e += blockDim.x) sg[e] = make_float2(e / chi == e % chi ? 1.f : 0.f, 0.f);
  __syncthreads();
  for (int i = L - 1; i >= 1; --i) {
    const float2* a = tz + i * site;
    // M^H[(s, m), l] = conj(sum_r A[s, l, r] c[r, m]) for this block's rows (s, m)
    for (int s = r0 / chi; s * chi < r0 + rn; ++s) {
      const int ma = max(r0 - s * chi, 0), mb = min(r0 + rn - s * chi, chi);
      product<false, kTM>(a + s * cc, chi, 1, sg + ma, chi, chi, mb - ma, chi, [&](int l, int j, float2 v) {
        const int row = s * chi + ma + j - r0;
        smh[row * chi + l] = conj2(v);
        sx[row * chi + l] = conj2(v);
      });
    }
    __syncthreads();
    ns_polar_rows<kC, kTM>(sx, sxg, sg, part, cc, scratch, rn, chi);
    // c = M x = sum over the rows (s, m) of conj(M^H[(s, m), l]) x[(s, m), l']:
    // this block's partial, added over the cluster in rank order, into g
    if constexpr (kC > 1) {
      // part's first slot: its last readers (step 6's Gram sums) passed step 7's barrier
      product<true, kTM>(smh, 1, chi, sx, chi, chi, chi, rn, [&](int l, int j, float2 v) { part[l * chi + j] = v; });
      cg::this_cluster().sync();
      cluster_sum<kC>(sg, part, cc);
    } else {
      product<true, kTM>(smh, 1, chi, sx, chi, chi, chi, rn, [&](int l, int j, float2 v) { sg[l * chi + j] = v; });
    }
    // out_i[s, l, m] = conj(x[(s, m), l]) for this block's rows (s, m)
    float2* o = oz + i * site;
    for (int s = r0 / chi; s * chi < r0 + rn; ++s) {
      const int ma = max(r0 - s * chi, 0), w = min(r0 + rn - s * chi, chi) - ma;
      for (int e = threadIdx.x; e < chi * w; e += blockDim.x) {
        const int l = e / w, mm = ma + e % w;
        o[s * cc + l * chi + mm] =
            (i == L - 1 && mm >= 1) ? make_float2(0.f, 0.f) : conj2(sx[(s * chi + mm - r0) * chi + l]);
      }
    }
    __syncthreads();
  }
  // out_0 = A_0 c, of which only the row l = 0 survives the pads: this block's (s, m)
  for (int e = threadIdx.x; e < rn * chi; e += blockDim.x) {
    const int row = r0 + e / chi, l = e % chi, s = row / chi, mm = row % chi;
    float2 v = make_float2(0.f, 0.f);
    if (l == 0) {
      const float2* a0 = tz + s * cc;
      for (int r = 0; r < chi; ++r) cfma(v, a0[r], sg[r * chi + mm]);
    }
    oz[s * cc + l * chi + mm] = v;
  }
  if constexpr (kC > 1) cg::this_cluster().sync();  // no block leaves while another reads its shared memory
}

template <int kC, int kTM>
const void* canon_kernel() {
  return reinterpret_cast<const void*>(ns_canon_kernel<kC, kTM>);
}

const void* canon_kernel_for(int cluster, bool small) {
  return cluster == 4 ? canon_kernel<4, 8>()
         : cluster == 3 ? canon_kernel<3, 8>()
         : cluster == 2 ? canon_kernel<2, 8>()
         : small        ? canon_kernel<1, 2>()
                        : canon_kernel<1, 8>();
}

}  // namespace

// The clusters of `cluster` blocks (2, 3 or 4) of a (d, chi) chain that the
// card holds at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int ns_canon_max_clusters(int d, int chi, int cluster) {
  if (cluster < 2 || cluster > 4 || d <= 0 || chi <= 0 || chi > kNsMaxCols || d * chi > kNsMaxRows) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = CanonLayout(d, chi, cluster).bytes();
  const void* kernel = canon_kernel_for(cluster, false);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(1, cluster, kNsThreads, smem, nullptr, attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &config);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

// Blocks of one SM at C = 1 (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus a CUDA error.
extern "C" int ns_canon_blocks_per_sm(int d, int chi) {
  if (d <= 0 || chi <= 0 || chi > kNsMaxCols || d * chi > kNsMaxRows) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = CanonLayout(d, chi, 1).bytes();
  const void* kernel = canon_kernel_for(1, ns_fits_small_tiles(d * chi, chi));
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int count = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, kNsThreads, smem);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

// in, out: (batch, L, d, chi, chi) contiguous, L >= 2, d * chi <= 128;
// cluster: the blocks a trajectory, 1 to 4 (the wrapper's rule).  A cluster
// the card cannot place is an error, never a fall back to another size.
extern "C" int ns_canon_launch(const void* in, void* out, int batch, int L, int d, int chi, int cluster,
                               void* stream) {
  if (batch <= 0 || L < 2 || d <= 0 || chi <= 0 || chi > kNsMaxCols || d * chi > kNsMaxRows || cluster < 1 ||
      cluster > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = CanonLayout(d, chi, cluster).bytes();
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = canon_kernel_for(cluster, ns_fits_small_tiles(d * chi, chi));
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      cluster_config(batch, cluster, kNsThreads, smem, static_cast<cudaStream_t>(stream), attr);
  const auto* ip = static_cast<const float2*>(in);
  auto* op = static_cast<float2*>(out);
  void* args[] = {&ip, &op, &L, &d, &chi};
  err = cudaLaunchKernelExC(&config, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
