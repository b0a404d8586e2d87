// Kernel K5: the Newton half-step subspace split of a batch of complex64
// matrices, over a thread block cluster of C blocks a matrix when the batch
// leaves SMs idle, else one thread block a matrix.
//
// Replaces: yaqs_tpu/ops/decomp.py split_matrix_subspace with
// qr_method="newton" (:181-308, the XLA chain K5): on the fast knob set every
// two-site split of the TDVP sweeps (the (2 chi, 2 chi) = (128, 128) block at
// B = 32 on the analog path) and of the digital bond sweeps and bond
// dissipators ((64, 64) at B = 512, chi = 32).
//
// What it computes, for m (rows, cols), the range-finder start omega and
// chi kept columns, exactly as the JAX function (NS = the Newton-Schulz
// polar factor of ns_polar.cuh):
//   "right": y = m omega (omega (cols, chi)); per iteration q = NS(y),
//            z = NS(m^H q), y = m z; left = NS(y), right = left^H m,
//            s = the row norms of right;
//   "left":  y = m^H omega (omega (rows, chi)); per iteration v0 = NS(y),
//            z = NS(m v0), y = m^H z; v = NS(y), left = m v, right = v^H,
//            s = the column norms of left.
//
// What bounds it on the card: arithmetic.  At (128, 128), chi = 64 and one
// iteration: three polar factors of 22 * 128 * 64 * 64 complex MACs and four
// products of 128 * 128 * 64, 38.8 M complex MACs a matrix, against 256 KB of
// device traffic.  One block a matrix puts B = 32 matrices on 32 of 132 SMs,
// whose FP32 share sets a floor of about 0.61 ms.
//
// Design.  The launch takes C blocks a matrix, by the wrapper's rule: the
// largest of 4, 3 and 2 whose clusters the card holds all at once for the
// whole batch (subspace_split_max_clusters), else 1.  An H100 holds 30
// clusters of four at (128, 128), chi = 64 (clusters stay within a GPC), so
// the analog B = 32 runs on clusters of three (96 SMs): four would take two
// waves.  The digital B = 512 runs on single blocks.
//  - C = 1 (subspace_split_kernel): the iterate, x g and g of the polar
//    factor stay in shared memory (two max(rows, cols) x chi buffers and one
//    chi x chi: 160 KB at (128, 128), chi = 64), and every product reads m
//    from device memory (L2).  Where no product takes a tile of more than
//    two rows (ns_fits_small_tiles: the digital (64, 64), chi = 32, 40 KB a
//    block), the kernel is built with those tiles for four blocks an SM
//    (64 registers a thread), as K6's one-block kernel is.
//  - C > 1 (subspace_split_cluster_kernel): block r of a cluster holds a
//    contiguous share of m's rows in its own shared memory (32 KB at C = 4),
//    read from device memory once.  A (rows, chi) iterate is split by the
//    same rows, a (cols, chi) iterate by its own rows.  The two products
//    that sum over the split rows, the Gram g = x^H x of every Newton-Schulz
//    step and m^H X, are partial sums in each block added through
//    distributed shared memory, in rank order, so every block holds the same
//    g: an all-reduce for g (double-buffered, one cluster barrier a step),
//    a reduce-scatter for m^H X.  m X gathers X the same way.  About 33
//    cluster barriers a split at one iteration, each between products of
//    about 130 k complex MACs a block at C = 4.  Distributed shared memory
//    reads at a fraction of the block's own rate, so the all-reduces cost
//    more than the barriers; reading only g's upper triangle measured
//    slower than this plain sum, and 16 bytes a load no faster.
// Both kernels run the polar factor of ns_polar.cuh (ns_polar_rows, on one
// block or over the cluster), whose products run on the tensor cores in
// 3xTF32 (see ns_polar.cuh).  The products with m run on ns_polar.cuh's
// FP32 product, a register tile of 8, 4 or 2 rows by 4 columns of complex
// outputs a thread, with the offsets computed once and an unrolled k loop.

#include "ns_polar.cuh"

namespace {

template <int kTM>
__global__ void __launch_bounds__(kNsThreads, kTM == 2 ? 4 : 1)
subspace_split_kernel(const float2* __restrict__ m, const float2* __restrict__ omega, float2* __restrict__ left,
                      float2* __restrict__ right, float* __restrict__ s, int rows, int cols, int chi, int iters,
                      int left_isometric) {
  extern __shared__ float2 smem[];
  const int big = (rows > cols ? rows : cols) * chi;
  float2* buf_a = smem;
  float2* buf_b = buf_a + big;
  float2* sg = buf_b + big;
  float* red = reinterpret_cast<float*>(sg + chi * chi);
  const float2* mz = m + static_cast<size_t>(blockIdx.x) * rows * cols;
  float2* lz = left + static_cast<size_t>(blockIdx.x) * rows * chi;
  float2* rz = right + static_cast<size_t>(blockIdx.x) * chi * cols;
  float* sz = s + static_cast<size_t>(blockIdx.x) * chi;

  // products with m read from device memory; X is a row-major buffer with chi columns
  auto m_times = [&](const float2* x, float2* out) {  // m X: (rows, chi)
    product<false, kTM>(mz, cols, 1, x, chi, rows, chi, cols, [&](int i, int j, float2 v) { out[i * chi + j] = v; });
    __syncthreads();
  };
  auto mh_times = [&](const float2* x, float2* out) {  // m^H X: (cols, chi)
    product<true, kTM>(mz, 1, cols, x, chi, cols, chi, rows, [&](int i, int j, float2 v) { out[i * chi + j] = v; });
    __syncthreads();
  };

  if (left_isometric) {
    // left factor isometric: the dominant column subspace of m
    m_times(omega, buf_a);
    for (int it = 0; it < iters; ++it) {
      ns_polar_block<kTM>(buf_a, buf_b, sg, red, rows, chi);  // q
      mh_times(buf_a, buf_b);
      ns_polar_block<kTM>(buf_b, buf_a, sg, red, cols, chi);  // z
      m_times(buf_b, buf_a);
    }
    ns_polar_block<kTM>(buf_a, buf_b, sg, red, rows, chi);  // left
    for (int e = threadIdx.x; e < rows * chi; e += blockDim.x) lz[e] = buf_a[e];
    // right = left^H m: (chi, cols), into buf_b
    product<true, kTM>(buf_a, 1, chi, mz, cols, chi, cols, rows, [&](int i, int j, float2 v) { buf_b[i * cols + j] = v; });
    __syncthreads();
    for (int e = threadIdx.x; e < chi * cols; e += blockDim.x) rz[e] = buf_b[e];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = warp; i < chi; i += blockDim.x / 32) {
      float acc = 0.f;
      for (int j = lane; j < cols; j += 32) {
        const float2 v = buf_b[i * cols + j];
        acc = fmaf(v.x, v.x, fmaf(v.y, v.y, acc));
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) sz[i] = sqrtf(acc);
    }
  } else {
    // right factor isometric: the dominant row subspace of m
    mh_times(omega, buf_a);
    for (int it = 0; it < iters; ++it) {
      ns_polar_block<kTM>(buf_a, buf_b, sg, red, cols, chi);  // v0
      m_times(buf_a, buf_b);
      ns_polar_block<kTM>(buf_b, buf_a, sg, red, rows, chi);  // z
      mh_times(buf_b, buf_a);
    }
    ns_polar_block<kTM>(buf_a, buf_b, sg, red, cols, chi);  // v
    for (int e = threadIdx.x; e < chi * cols; e += blockDim.x) {
      const int i = e / cols, j = e % cols;
      rz[e] = conj2(buf_a[j * chi + i]);
    }
    m_times(buf_a, buf_b);  // left = m v: (rows, chi)
    for (int e = threadIdx.x; e < rows * chi; e += blockDim.x) lz[e] = buf_b[e];
    for (int j = threadIdx.x; j < chi; j += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < rows; ++i) {
        const float2 v = buf_b[i * chi + j];
        acc = fmaf(v.x, v.x, fmaf(v.y, v.y, acc));
      }
      sz[j] = sqrtf(acc);
    }
  }
}

namespace cg = cooperative_groups;

// dst (n x chi, row-major) = the whole of a matrix split by rows over the
// cluster, block k holding rows [k share, (k + 1) share) in its src.
template <int kC>
__device__ __forceinline__ void cluster_gather(float2* dst, float2* src, int share, int n, int chi) {
  cg::cluster_group cl = cg::this_cluster();
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const float2* part = cl.map_shared_rank(src, k);
    const int first = min(k * share, n) * chi;
    const int count = min((k + 1) * share, n) * chi - first;
#pragma unroll 4
    for (int e = threadIdx.x; e < count; e += blockDim.x) dst[first + e] = part[e];
  }
}

__host__ __device__ constexpr int even(int n) { return n + (n & 1); }

// Shared memory of a cluster block, in elements: m's rows, the two iterate
// buffers, g, the wide buffer (m^H X partials, gathered X, or the two Gram
// partials) in float2; the polar factor's scratch (ns_scratch_floats) in
// float.
struct ClusterLayout {
  int m, x, g, wide, scratch;
  __host__ __device__ ClusterLayout(int rows, int cols, int chi, int blocks) {
    const int rs = (rows + blocks - 1) / blocks, cs = (cols + blocks - 1) / blocks;
    m = even(rs * cols);
    x = even((rs > cs ? rs : cs) * chi);
    g = even(chi * chi);
    wide = even((rows > cols ? rows : cols) * chi);
    wide = wide > 2 * g ? wide : 2 * g;
    scratch = even(ns_scratch_floats(chi));
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float2) * (static_cast<size_t>(m) + 2 * x + g + wide) + sizeof(float) * scratch;
  }
};

template <int kC>
__global__ void __launch_bounds__(kNsThreads, 1)
subspace_split_cluster_kernel(const float2* __restrict__ m, const float2* __restrict__ omega,
                              float2* __restrict__ left, float2* __restrict__ right, float* __restrict__ s, int rows,
                              int cols, int chi, int iters, int left_isometric) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const long long b = blockIdx.x / kC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rs = (rows + kC - 1) / kC, r0 = min(rank * rs, rows), rn = min(rows - r0, rs);
  const int cs = (cols + kC - 1) / kC, c0 = min(rank * cs, cols), cn = min(cols - c0, cs);
  const int hs = (chi + kC - 1) / kC, h0 = min(rank * hs, chi), hn = min(chi - h0, hs);  // rows of right, of s
  const ClusterLayout ly(rows, cols, chi, kC);
  float2* sm = reinterpret_cast<float2*>(smem4);  // this block's rows of m, rn x cols
  float2* xa = sm + ly.m;
  float2* xb = xa + ly.x;
  float2* g = xb + ly.x;
  float2* wide = g + ly.g;
  float* scratch = reinterpret_cast<float*>(wide + ly.wide);
  const float2* mz = m + b * rows * cols;
  float2* lz = left + b * rows * chi;
  float2* rz = right + b * chi * cols;
  float* sz = s + b * chi;

  for (int e = tid; e < rn * cols; e += blockDim.x) sm[e] = mz[static_cast<size_t>(r0) * cols + e];
  // y = m X into out: this block's rows
  auto m_times = [&](const float2* xall, float2* out) {
    product<false>(sm, cols, 1, xall, chi, rn, chi, cols, [&](int i, int j, float2 v) { out[i * chi + j] = v; });
    __syncthreads();
  };
  // out = this block's rows of m^H X (X split by m's rows): partials in
  // wide, added over the cluster; wide must be free in every block
  auto mh_times = [&](const float2* xrows, float2* out) {
    product<true>(sm, 1, cols, xrows, chi, cols, chi, rn, [&](int i, int j, float2 v) { wide[i * chi + j] = v; });
    cl.sync();
    cluster_sum<kC>(out, wide + c0 * chi, cn * chi);
    __syncthreads();
  };
  auto ns = [&](float2* x, float2* work, int nl) {
    ns_polar_rows<kC>(x, work, g, wide, ly.g, scratch, nl, chi);
    cl.sync();  // x final in every block, and no block reads another's Gram partials any more
  };

  if (left_isometric) {
    // left factor isometric: the dominant column subspace of m
    for (int e = tid; e < cols * chi; e += blockDim.x) wide[e] = omega[e];
    __syncthreads();
    m_times(wide, xa);
    for (int it = 0; it < iters; ++it) {
      ns(xa, xb, rn);  // q
      mh_times(xa, xb);
      ns(xb, xa, cn);  // z
      cluster_gather<kC>(wide, xb, cs, cols, chi);
      __syncthreads();
      m_times(wide, xa);
    }
    ns(xa, xb, rn);  // left
    for (int e = tid; e < rn * chi; e += blockDim.x) lz[static_cast<size_t>(r0) * chi + e] = xa[e];
    // right = left^H m: (chi, cols) partials in wide; block r adds rows
    // [h0, h0 + hn) over the cluster, writes them and their norms
    product<true>(xa, 1, chi, sm, cols, chi, cols, rn, [&](int i, int j, float2 v) { wide[i * cols + j] = v; });
    cl.sync();
    const float2* part[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) part[k] = cl.map_shared_rank(wide, k);
    for (int i = h0 + warp; i < h0 + hn; i += kNsThreads / 32) {
      float acc = 0.f;
      for (int j = lane; j < cols; j += 32) {
        float2 v = part[0][i * cols + j];
#pragma unroll
        for (int k = 1; k < kC; ++k) {
          const float2 w = part[k][i * cols + j];
          v.x += w.x;
          v.y += w.y;
        }
        rz[static_cast<size_t>(i) * cols + j] = v;
        acc = fmaf(v.x, v.x, fmaf(v.y, v.y, acc));
      }
      acc = warp_sum(acc);
      if (lane == 0) sz[i] = sqrtf(acc);
    }
  } else {
    // right factor isometric: the dominant row subspace of m
    for (int e = tid; e < rn * chi; e += blockDim.x) xb[e] = omega[static_cast<size_t>(r0) * chi + e];
    __syncthreads();
    mh_times(xb, xa);
    for (int it = 0; it < iters; ++it) {
      ns(xa, xb, cn);  // v0
      cluster_gather<kC>(wide, xa, cs, cols, chi);
      __syncthreads();
      m_times(wide, xb);
      ns(xb, xa, rn);  // z
      mh_times(xb, xa);
    }
    ns(xa, xb, cn);  // v
    for (int e = tid; e < chi * cn; e += blockDim.x) {
      const int i = e / cn, c = e % cn;
      rz[static_cast<size_t>(i) * cols + c0 + c] = conj2(xa[c * chi + i]);
    }
    cluster_gather<kC>(wide, xa, cs, cols, chi);
    __syncthreads();
    m_times(wide, xb);  // left = m v: this block's rows
    for (int e = tid; e < rn * chi; e += blockDim.x) lz[static_cast<size_t>(r0) * chi + e] = xb[e];
    // s = the column norms of left: this block's partial sums, added over
    // the cluster (scratch is free: its last readers passed many barriers)
    for (int j = tid; j < chi; j += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < rn; ++i) {
        const float2 v = xb[i * chi + j];
        acc = fmaf(v.x, v.x, fmaf(v.y, v.y, acc));
      }
      scratch[j] = acc;
    }
    cl.sync();
    for (int j = h0 + tid; j < h0 + hn; j += blockDim.x) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kC; ++k) acc += cl.map_shared_rank(scratch, k)[j];
      sz[j] = sqrtf(acc);
    }
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

template <int kC>
cudaError_t launch_cluster(cudaStream_t stream, const float2* m, const float2* omega, float2* left, float2* right,
                           float* s, int batch, int rows, int cols, int chi, int iters, int left_isometric) {
  auto kernel = subspace_split_cluster_kernel<kC>;
  const size_t smem = ClusterLayout(rows, cols, chi, kC).bytes();
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attribute[1];
  const cudaLaunchConfig_t config = cluster_config(batch, kC, kNsThreads, smem, stream, attribute);
  return cudaLaunchKernelEx(&config, kernel, m, omega, left, right, s, rows, cols, chi, iters, left_isometric);
}

}  // namespace

// The clusters of `cluster` blocks (2, 3 or 4) of this shape that the card
// holds at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int subspace_split_max_clusters(int rows, int cols, int chi, int cluster) {
  if (cluster < 2 || cluster > 4) return -static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = cluster == 4   ? reinterpret_cast<const void*>(subspace_split_cluster_kernel<4>)
                       : cluster == 3 ? reinterpret_cast<const void*>(subspace_split_cluster_kernel<3>)
                                      : reinterpret_cast<const void*>(subspace_split_cluster_kernel<2>);
  const size_t smem = ClusterLayout(rows, cols, chi, cluster).bytes();
  if (smem > kSmemLimit) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attribute[1];
  const cudaLaunchConfig_t config = cluster_config(1, cluster, kNsThreads, smem, nullptr, attribute);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &config);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

// m (batch, rows, cols) contiguous; omega (cols, chi) when left_isometric,
// else (rows, chi); left (batch, rows, chi), right (batch, chi, cols), s
// (batch, chi) float; cluster: the blocks a matrix, 1 to 4 (the wrapper's
// rule).  A cluster the card cannot place is an error, never a fall back
// to one block.
extern "C" int subspace_split_launch(const void* m, const void* omega, void* left, void* right, void* s, int batch,
                                     int rows, int cols, int chi, int iters, int left_isometric, int cluster,
                                     void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || chi <= 0 || iters < 0 || rows > kNsMaxRows || cols > kNsMaxRows ||
      chi > kNsMaxCols || cluster < 1 || cluster > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* mp = static_cast<const float2*>(m);
  const auto* op = static_cast<const float2*>(omega);
  auto* lp = static_cast<float2*>(left);
  auto* rp = static_cast<float2*>(right);
  auto* sp = static_cast<float*>(s);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cluster == 4) {
    err = launch_cluster<4>(st, mp, op, lp, rp, sp, batch, rows, cols, chi, iters, left_isometric);
  } else if (cluster == 3) {
    err = launch_cluster<3>(st, mp, op, lp, rp, sp, batch, rows, cols, chi, iters, left_isometric);
  } else if (cluster == 2) {
    err = launch_cluster<2>(st, mp, op, lp, rp, sp, batch, rows, cols, chi, iters, left_isometric);
  } else {
    const int big = (rows > cols ? rows : cols);
    const size_t smem = sizeof(float2) * (2 * static_cast<size_t>(big) * chi + static_cast<size_t>(chi) * chi) +
                        sizeof(float) * ns_scratch_floats(chi);
    if (ns_fits_small_tiles(big, chi) && ns_fits_small_tiles(chi, cols)) {
      err = prepare(subspace_split_kernel<2>, smem);
      if (err == cudaSuccess) {
        subspace_split_kernel<2><<<batch, kNsThreads, smem, st>>>(mp, op, lp, rp, sp, rows, cols, chi, iters,
                                                                  left_isometric);
      }
    } else {
      err = allow_smem(subspace_split_kernel<8>, smem);
      if (err == cudaSuccess) {
        subspace_split_kernel<8><<<batch, kNsThreads, smem, st>>>(mp, op, lp, rp, sp, rows, cols, chi, iters,
                                                                  left_isometric);
      }
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
