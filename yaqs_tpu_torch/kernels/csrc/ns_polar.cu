// Kernel A: Newton–Schulz polar orthogonalization of a batch of complex64
// blocks, each on a thread block cluster of C blocks (C = 1: one block).
//
// Replaces: yaqs_tpu/ops/decomp.py newton_schulz_orthogonalize (the XLA chain
// K4) where a polar factor is taken on its own.  The subspace split (K5,
// subspace_split.cu) and the Newton canonicalization (K6, ns_canon.cu) run
// the same schedule inside their own kernels, so on the analog and digital
// paths this kernel is no longer launched; it stays as the standalone polar
// factor and as the reference shape of the schedule, (d*chi, chi) =
// (128, 64).
//
// What it computes, in this order (the schedule must never change: in
// complex64 an extra lift promotes sub-eps noise directions into the basis):
//   1. x /= min(frobenius, sqrt(norm1 * norminf)) + 1e-30
//   2. 4 quintics  x = a x + b x g + c x g g,  g = x^H x, (a,b,c) = (3.4445, -4.7750, 2.0315)
//   3. 2 quintics  with (2, -1.3333, 0.3333)
//   4. 2 cubics    x = 1.5 x - 0.5 x g
//
// What bounds it on the card: arithmetic.  One (128, 64) block needs 22
// complex products of 128*64*64 multiply-adds, about 46 M real FMAs, and
// reads and writes only 2 * 64 KB of device memory.  Eager PyTorch runs the
// same schedule as ~40 launches with ~24 round trips of the iterate through
// device memory.
//
// Design.  The launch takes C blocks a matrix, by K5's rule: the largest of
// 4, 3 and 2 whose clusters the card holds all at once for the whole batch
// (ns_polar_max_clusters), else 1.  Block r of a cluster holds the rows [r
// nl, r nl + rn) of the matrix (nl = ceil(m / C)) with their x g, g and the
// two Gram partials in shared memory (140 KB at (128, 64), C = 3), loads
// its rows once, runs ns_polar_rows<C> of ns_polar.cuh (the schedule of K5
// and K6: the scale's statistics and each step's Gram are the blocks'
// partial sums added in rank order through distributed shared memory) and
// writes its rows back.  At B = 32 and (128, 64) that is clusters of three
// on 96 SMs, not 32 lone blocks.  The products run on the tensor cores in
// 3xTF32 (ns_polar.cuh).  Where a shape passes the test K6 and K5 take
// for their four-blocks-an-SM builds (ns_fits_small_tiles: (64, 32), the
// digital shape, 40 KB a block), the one-block kernel is built for four
// blocks an SM too (64 registers a thread, the smallest warp tile).

#include "ns_polar.cuh"

namespace {

// Shared memory of a block, in float2: its rows of x and of x g, g, and with
// a cluster the two Gram partials; then the polar factor's scratch in float.
struct PolarLayout {
  int rows, g, part, scratch;
  __host__ __device__ PolarLayout(int m, int n, int c) {
    rows = (m + c - 1) / c * n;
    rows += rows & 1;  // keep every buffer 16-byte aligned
    g = n * n + (n & 1);
    part = c > 1 ? g : 0;
    scratch = ns_scratch_floats(n);
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float2) * (2 * static_cast<size_t>(rows) + g + 2 * part) + sizeof(float) * scratch;
  }
};

template <int kC, int kTM>
__global__ void __launch_bounds__(kNsThreads, kTM == 2 ? 4 : 1)
ns_polar_kernel(const float2* __restrict__ in, float2* __restrict__ out, int m, int n) {
  extern __shared__ float4 smem4[];
  int rank = 0;
  if constexpr (kC > 1) rank = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const PolarLayout ly(m, n, kC);
  const int nl = (m + kC - 1) / kC, r0 = min(rank * nl, m), rn = min(nl, m - r0);
  float2* sx = reinterpret_cast<float2*>(smem4);  // (rn, n): this block's rows
  float2* sxg = sx + ly.rows;                      // (rn, n): x g
  float2* sg = sxg + ly.rows;                      // (n, n): g
  float2* part = sg + ly.g;                        // 2 x (n, n): Gram partials (kC > 1)
  float* scratch = reinterpret_cast<float*>(part + 2 * ly.part);

  const size_t base = (static_cast<size_t>(blockIdx.x / kC) * m + r0) * n;
  for (int e = threadIdx.x; e < rn * n; e += blockDim.x) sx[e] = in[base + e];
  __syncthreads();
  ns_polar_rows<kC, kTM>(sx, sxg, sg, part, ly.part, scratch, rn, n);
  for (int e = threadIdx.x; e < rn * n; e += blockDim.x) out[base + e] = sx[e];
  if constexpr (kC > 1) cooperative_groups::this_cluster().sync();  // no block leaves while another reads its memory
}

template <int kC, int kTM>
const void* polar_kernel() {
  return reinterpret_cast<const void*>(ns_polar_kernel<kC, kTM>);
}

const void* polar_kernel_for(int cluster, bool small) {
  return cluster == 4   ? polar_kernel<4, 8>()
         : cluster == 3 ? polar_kernel<3, 8>()
         : cluster == 2 ? polar_kernel<2, 8>()
         : small        ? polar_kernel<1, 2>()
                        : polar_kernel<1, 8>();
}

}  // namespace

// The clusters of `cluster` blocks (2, 3 or 4) of (m, n) matrices that the
// card holds at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int ns_polar_max_clusters(int m, int n, int cluster) {
  if (cluster < 2 || cluster > 4 || m <= 0 || n <= 0 || m > kNsMaxRows || n > kNsMaxCols) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = PolarLayout(m, n, cluster).bytes();
  const void* kernel = polar_kernel_for(cluster, false);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config = cluster_config(1, cluster, kNsThreads, smem, nullptr, attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &config);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

// in, out: (batch, m, n) contiguous; cluster: the blocks a matrix, 1 to 4
// (the wrapper's rule).  A cluster the card cannot place is an error, never
// a fall back to another size.
extern "C" int ns_polar_launch(const void* in, void* out, int batch, int m, int n, int cluster, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || m > kNsMaxRows || n > kNsMaxCols || cluster < 1 || cluster > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = PolarLayout(m, n, cluster).bytes();
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = polar_kernel_for(cluster, ns_fits_small_tiles(m, n));
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t config =
      cluster_config(batch, cluster, kNsThreads, smem, static_cast<cudaStream_t>(stream), attr);
  const auto* ip = static_cast<const float2*>(in);
  auto* op = static_cast<float2*>(out);
  void* args[] = {&ip, &op, &m, &n};
  err = cudaLaunchKernelExC(&config, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
