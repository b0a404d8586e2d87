// Kernels K1 (lanczos_solve2), K2 (lanczos_solve1) and K16 (lanczos_solve0):
// a whole fixed-k Lanczos solve of a TDVP sweep in one launch, per trajectory,
//   nrm = ||v||;  q_0 = v / nrm (v where nrm = 0);  alive = true;
//   for j < k:  w = H_eff q_j;  alpha = Re <q_j, w>;
//     reorth:     two classical Gram-Schmidt passes of w against rows 0..j
//     otherwise:  w -= alpha q_j + beta_prev q_(j-1)
//     beta = ||w||;  alive' = alive & (beta > tol);
//     q_(j+1) = alive' ? w / beta : 0;  alphas[j] = alive ? alpha : 0;
//     betas[j] = alive' ? beta : 0;  beta_prev = beta;  alive = alive'
// with H_eff the merged-MPO effective Hamiltonian of heff.cuh: P = 4 for the
// two-site block theta and the merged pair W12 (lanczos_solve2), P = 2 for
// one site and Wm (lanczos_solve1), P = 1 for a bond matrix under the
// zero-site H_eff, no W (lanczos_solve0).  It writes the basis rows
// q_0..q_(k-1), alphas, betas and nrm: what the epilogue
// (lanczos_epilogue.cu, K3) reads.
//
// Replaces: yaqs_tpu/ops/krylov.py lanczos_expm_apply (:31-101; the
// fori_body :74-92, both variants) around yaqs_tpu/methods/tdvp.py:173
// heff_two_site_merged (K1), :188 heff_one_site_merged (K2) and :199
// heff_bond (K16: the one-site and dynamic sweeps' bond evolutions,
// tdvp.py:361-362 and :453-454, 2 (L - 1) solves a one-site sweep).
// Before, a solve was k matvec launches (heff.cu), k recurrence launches
// and about ten small PyTorch operations of its prologue.
//
// What bounds it on the card: the k matvecs' FP32 operations (heff.cuh;
// 2 Dw chi^3 complex MACs a matvec for K16, whose n = chi^2); the
// recurrence moves a few vectors of n = P chi^2 complex64 per iteration.
// K16 is K2's design with no W and P = 1: a simple kernel, its clusters as
// many blocks as K2's (ceil(chi / TA)) with half the work a block.
//
// Design: one thread block cluster a trajectory.  Block r of the cluster
// owns the tile of TA output rows a starting at r TA (heff.cuh), so a
// cluster is ceil(chi / TA) blocks: 6 at chi = 64 and Dw = 3 (two blocks an
// SM, so 3 SMs a trajectory: an H100 holds the analog batch of 32 at once,
// where clusters of 8 blocks of 8 rows did not all fit and the batch ran in
// two waves), 11 at Dw = 5 (a non-portable cluster size; 16 blocks of 4
// rows did not fit the XXZ batch of 16, and two tiles a block ran slower),
// 2 for the gate window's chi = 32.  f's rows and W are staged once a solve; g streams from
// L2 for each matvec.  After a matvec the block's slice of w lies in the
// threads' phase-3 registers, and the recurrence runs on it there:
//  - every sum (||v||, alpha, the Gram-Schmidt projections, beta) is a
//    per-block partial (warp shuffles, then the warps in order), added over
//    the cluster in rank order through distributed shared memory, so every
//    block gets the same total whatever the timing; double-buffered, one
//    cluster barrier a sum (2 an iteration three-term, 3 reorthogonalizing;
//    alpha rides on the first projection pass, whose row j is q_j);
//  - the block's own slices of q_j, q_(j-1) and of rows 0..j are read back
//    from the basis, which this thread wrote;
//  - the orthogonalized w goes to a scratch vector (two, alternating) before
//    the cluster barrier that adds beta, and the next matvec reads it scaled
//    by 1 / beta, the same product that forms q_(j+1) in the basis: one
//    barrier both publishes the vector and adds its norm.  The first matvec
//    reads v scaled by 1 / nrm.  Vectors written in this launch are read
//    through L2 (ld.global.cg), never the non-coherent path.
// d = 2, chi <= 64, Dw <= 6, k <= 64.

#include <cooperative_groups.h>

#include "heff.cuh"
#include "launch.cuh"

namespace {

namespace cg = cooperative_groups;
using heff::kMaxChi;
using heff::kMaxDw;
using heff::kThreads;
using heff::Tile;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;
constexpr int kChunk = 8;                // projections reduced together
constexpr int kMaxSum = 2 * kMaxK;       // floats of one cluster sum
constexpr int kRedFloats = kWarps * 2 * kChunk + 3 * kMaxSum;  // warp partials, two slots, totals

// Adds v[0..NV) over the block (warp shuffles, then the warps in order) into
// dst[0..count) of shared memory.  Ends with a block barrier.
template <int NV>
__device__ __forceinline__ void block_partial(float (&v)[NV], float* red, float* dst, int count) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[warp * NV + i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < count) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * NV + threadIdx.x];
    dst[threadIdx.x] = s;
  }
  __syncthreads();
}

// total[0..count) = the blocks' partials slot[0..count) added over the
// cluster in rank order.  The cluster barrier publishes the slots (and, with
// its release / acquire, every global write before it).
__device__ __forceinline__ void cluster_total(const float* slot, int count, float* total) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int nranks = static_cast<int>(cl.num_blocks());
  for (int i = threadIdx.x; i < count; i += kThreads) {
    float s = 0.f;
    for (int r = 0; r < nranks; ++r) s += cl.map_shared_rank(slot, r)[i];
    total[i] = s;
  }
  __syncthreads();
}

template <int P, int DW>
struct SolveLayout {
  using T = Tile<P, DW>;
  // float2 elements: the tile's rows of f, W, X/Y, g's chunk; then floats
  static __host__ __device__ size_t bytes(int chi) {
    const int chs = heff::even(chi);
    return sizeof(float2) * (T::f_elems(chs) + T::w_elems() + T::xy_elems(chs) + T::g_elems(chs)) +
           sizeof(float) * kRedFloats;
  }
};

template <int P, int DW>
__device__ __forceinline__ void solve_block(const float2* f, long long sf, const float2* v, long long sv,
                                            heff::VLayout vl, const float2* w, const float2* g, long long sg,
                                            float2* basis, float* alphas, float* betas, float* nrm_out,
                                            float2* scratch, int batch, int chi, int k, int reorth, float tol) {
  using T = Tile<P, DW>;
  constexpr int RG = T::RG;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const long long z = blockIdx.x / cl.num_blocks();
  const int chs = heff::even(chi);
  const long long n = static_cast<long long>(P) * chi * chi;

  extern __shared__ float4 smem_raw[];
  float2* fs = reinterpret_cast<float2*>(smem_raw);
  float2* ws = fs + T::f_elems(chs);
  float2* xy = ws + T::w_elems();
  float2* gs = xy + T::xy_elems(chs);
  float* red = reinterpret_cast<float*>(gs + T::g_elems(chs));
  float* slots = red + kWarps * 2 * kChunk;  // two slots of kMaxSum
  float* total = slots + 2 * kMaxSum;

  const float2* fz = f + z * sf;
  const float2* vz = v + z * sv;
  const float2* gz = g + z * sg;
  float2* bz = basis + z * k * n;
  const int a0 = rank * T::TA;  // the block's tile
  heff::stage_f<P, DW>(fs, fz, a0, chi, chs);
  if constexpr (P > 1) {  // the zero-site H_eff has no W
    for (int e = threadIdx.x; e < T::w_elems(); e += kThreads) ws[e] = w[e];
  }

  // the elements (x, a, b) of a trajectory's vector this thread owns (-1:
  // none), and where each lies in v
  int idx[RG][2];
  long long voff[RG][2];
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = heff::owned_index<P, DW>(a0, i, s, chi, chs);
      idx[i][s] = e;
      voff[i][s] = e >= 0 ? vl.offset<P>(e / (chi * chi), e / chi % chi, e % chi) : 0;
    }

  int slot = 0;
  auto next_slot = [&]() {
    float* out = slots + slot * kMaxSum;
    slot ^= 1;
    return out;
  };

  // prologue: nrm, q_0 = v * inv0 into basis row 0
  {
    float part[1] = {0.f};
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (idx[i][s] >= 0) {
          const float2 x = vz[voff[i][s]];
          part[0] = fmaf(x.x, x.x, fmaf(x.y, x.y, part[0]));
        }
    float* dst = next_slot();
    block_partial<1>(part, red, dst, 1);  // its barrier also covers the staging above
    cluster_total(dst, 1, total);
  }
  const float nrm = sqrtf(total[0]);
  const float inv0 = nrm > 0.f ? 1.f / nrm : 1.f;
  if (rank == 0 && threadIdx.x == 0) nrm_out[z] = nrm;
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (idx[i][s] >= 0) {
        const float2 x = vz[voff[i][s]];
        bz[idx[i][s]] = make_float2(x.x * inv0, x.y * inv0);
      }

  const float2* src = vz;  // the matvec's input is src * scale, laid out as src_layout
  heff::VLayout src_layout = vl;
  float scale = inv0;
  bool alive = true;
  float beta_prev = 0.f;
  float2 acc[RG][2];
  for (int j = 0; j < k; ++j) {
    heff::matvec_tile<P, DW>(fs, ws, xy, gs, src, src_layout, scale, gz, chi, chs, acc);

    const float2* qj = bz + j * n;
    float alpha;
    if (!reorth) {
      float part[1] = {0.f};
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (idx[i][s] >= 0) {
            const float2 q = qj[idx[i][s]], wv = acc[i][s];
            part[0] = fmaf(q.x, wv.x, fmaf(q.y, wv.y, part[0]));  // Re conj(q) w
          }
      float* dst = next_slot();
      block_partial<1>(part, red, dst, 1);
      cluster_total(dst, 1, total);
      alpha = total[0];
      const float2* qp = j > 0 ? bz + (j - 1) * n : nullptr;
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (idx[i][s] >= 0) {
            const float2 q = qj[idx[i][s]];
            const float2 p = qp ? qp[idx[i][s]] : make_float2(0.f, 0.f);
            float2& wv = acc[i][s];
            wv.x = wv.x - alpha * q.x - beta_prev * p.x;
            wv.y = wv.y - alpha * q.y - beta_prev * p.y;
          }
    } else {
      const int rows = j + 1;  // rows beyond j are zero
      for (int pass = 0; pass < 2; ++pass) {
        float* dst = next_slot();
        for (int c0 = 0; c0 < rows; c0 += kChunk) {
          float part[2 * kChunk];
#pragma unroll
          for (int r = 0; r < 2 * kChunk; ++r) part[r] = 0.f;
#pragma unroll
          for (int i = 0; i < RG; ++i)
#pragma unroll
            for (int s = 0; s < 2; ++s)
              if (idx[i][s] >= 0) {
                const float2 wv = acc[i][s];
#pragma unroll
                for (int r = 0; r < kChunk; ++r) {
                  if (c0 + r < rows) {
                    const float2 vv = bz[(c0 + r) * n + idx[i][s]];
                    part[2 * r] += vv.x * wv.x + vv.y * wv.y;  // conj(v) w
                    part[2 * r + 1] += vv.x * wv.y - vv.y * wv.x;
                  }
                }
              }
          block_partial<2 * kChunk>(part, red, dst + 2 * c0, min(2 * kChunk, 2 * (rows - c0)));
        }
        cluster_total(dst, 2 * rows, total);
        if (pass == 0) alpha = total[2 * j];
#pragma unroll
        for (int i = 0; i < RG; ++i)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            if (idx[i][s] >= 0) {
              float2 sum = make_float2(0.f, 0.f);
              for (int r = 0; r < rows; ++r) {
                const float2 p = make_float2(total[2 * r], total[2 * r + 1]);
                const float2 vv = bz[r * n + idx[i][s]];
                sum.x += p.x * vv.x - p.y * vv.y;
                sum.y += p.x * vv.y + p.y * vv.x;
              }
              acc[i][s].x -= sum.x;
              acc[i][s].y -= sum.y;
            }
      }
    }

    // beta = ||w||; the orthogonalized w goes to scratch before the barrier
    // that adds beta, for the next matvec to read
    float2* wz = scratch + (static_cast<long long>(j % 2) * batch + z) * n;
    const bool more = j + 1 < k;
    float part[1] = {0.f};
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (idx[i][s] >= 0) {
          const float2 wv = acc[i][s];
          part[0] = fmaf(wv.x, wv.x, fmaf(wv.y, wv.y, part[0]));
          if (more) __stcg(wz + idx[i][s], wv);
        }
    float* dst = next_slot();
    block_partial<1>(part, red, dst, 1);
    cluster_total(dst, 1, total);
    const float beta = sqrtf(total[0]);
    const bool alive_next = alive && beta > tol;
    const float inv = alive_next ? 1.f / beta : 0.f;
    if (more) {
      float2* row = bz + (j + 1) * n;
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (idx[i][s] >= 0) {
            const float2 wv = acc[i][s];
            row[idx[i][s]] = alive_next ? make_float2(wv.x * inv, wv.y * inv) : make_float2(0.f, 0.f);
          }
    }
    if (rank == 0 && threadIdx.x == 0) {
      alphas[z * k + j] = alive ? alpha : 0.f;
      betas[z * k + j] = alive_next ? beta : 0.f;
    }
    beta_prev = beta;
    alive = alive_next;
    src = wz;
    src_layout = heff::VLayout::contiguous<P>(chi);
    scale = inv;
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

// the kernels carry their wrappers' names, which the profiler's rows show
#define SOLVE_PARAMS                                                                                               \
  const float2 *f, long long sf, const float2 *v, long long sv, heff::VLayout vl, const float2 *w, const float2 *g, \
      long long sg, float2 *basis, float *alphas, float *betas, float *nrm_out, float2 *scratch, int batch, int chi, \
      int k, int reorth, float tol
#define SOLVE_ARGS f, sf, v, sv, vl, w, g, sg, basis, alphas, betas, nrm_out, scratch, batch, chi, k, reorth, tol

template <int DW>
__global__ void __launch_bounds__(kThreads, 2) lanczos_solve2_kernel(SOLVE_PARAMS) {
  solve_block<4, DW>(SOLVE_ARGS);
}

template <int DW>
__global__ void __launch_bounds__(kThreads, 2) lanczos_solve1_kernel(SOLVE_PARAMS) {
  solve_block<2, DW>(SOLVE_ARGS);
}

template <int DW>
__global__ void __launch_bounds__(kThreads, 2) lanczos_solve0_kernel(SOLVE_PARAMS) {
  solve_block<1, DW>(SOLVE_ARGS);
}

template <int P, int DW>
constexpr auto solve_kernel() {
  if constexpr (P == 4) {
    return lanczos_solve2_kernel<DW>;
  } else if constexpr (P == 2) {
    return lanczos_solve1_kernel<DW>;
  } else {
    return lanczos_solve0_kernel<DW>;
  }
}

template <int P, int DW>
cudaLaunchConfig_t solve_config(int batch, int chi, cudaStream_t stream, cudaLaunchAttribute* attribute,
                                cudaError_t* err) {
  using T = Tile<P, DW>;
  auto kernel = solve_kernel<P, DW>();
  const int cluster = (chi + T::TA - 1) / T::TA;
  // once per instantiation: the opt-in limits for the largest chi it takes
  static const cudaError_t configured = [&] {
    cudaError_t e = allow_smem(kernel, SolveLayout<P, DW>::bytes(kMaxChi));
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  *err = configured;
  cudaLaunchConfig_t config =
      cluster_config(batch, cluster, kThreads, SolveLayout<P, DW>::bytes(chi), stream, attribute);
  config.numAttrs = 1;  // a cluster of one block too: the occupancy query needs its size
  return config;
}

struct Args {
  const float2 *f, *v, *w, *g;
  long long sf, sv, sg;
  heff::VLayout vl;
  float2 *basis, *scratch;
  float *alphas, *betas, *nrm;
  int batch, chi, k, reorth;
  float tol;
};

template <int P, int DW>
int run(const Args& a, cudaStream_t stream, int* held) {
  cudaLaunchAttribute attribute[1];
  cudaError_t err;
  cudaLaunchConfig_t config = solve_config<P, DW>(held ? 1 : a.batch, a.chi, stream, attribute, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (held) {  // the clusters of this shape the card holds at once
    err = cudaOccupancyMaxActiveClusters(held, solve_kernel<P, DW>(), &config);
    return static_cast<int>(err);
  }
  err = cudaLaunchKernelEx(&config, solve_kernel<P, DW>(), a.f, a.sf, a.v, a.sv, a.vl, a.w, a.g, a.sg, a.basis,
                           a.alphas, a.betas, a.nrm, a.scratch, a.batch, a.chi, a.k, a.reorth, a.tol);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int dispatch(int dw, const Args& a, cudaStream_t stream, int* held) {
  switch (dw) {
    case 1: return run<P, 1>(a, stream, held);
    case 2: return run<P, 2>(a, stream, held);
    case 3: return run<P, 3>(a, stream, held);
    case 4: return run<P, 4>(a, stream, held);
    case 5: return run<P, 5>(a, stream, held);
    case 6: return run<P, 6>(a, stream, held);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int checked_dispatch(int p, int dw, const Args& a, cudaStream_t stream, int* held) {
  if (a.batch <= 0 || a.chi <= 0 || a.chi > kMaxChi || dw <= 0 || dw > kMaxDw || a.k <= 0 || a.k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p == 4) return dispatch<4>(dw, a, stream, held);
  if (p == 2) return dispatch<2>(dw, a, stream, held);
  if (p == 1) return dispatch<1>(dw, a, stream, held);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// f, g: (chi, dw, chi) contiguous per trajectory, sf / sg elements between
// trajectories; v: (p, chi, chi) per trajectory, sv elements between
// trajectories, v[c, p', q] at c0 sc0 + c1 sc1 + p' sp + q sq with c = (c0,
// c1) for p = 4, c = c0 for p = 2 and c = 0 for p = 1 (a permuted or
// strided block read in place); w: (dw p, p dw), unused (may be null) for p = 1;
// basis (batch, k, n), alphas, betas (batch, k) float, nrm (batch,) float,
// scratch (2, batch, n), n = p chi^2, all contiguous.  p = 4 runs
// lanczos_solve2, p = 2 lanczos_solve1, p = 1 lanczos_solve0.
extern "C" int lanczos_solve_launch(const void* f, long long sf, const void* v, long long sv, long long sc0,
                                    long long sc1, long long sp, long long sq, const void* w, const void* g,
                                    long long sg,
                                    void* basis, void* alphas, void* betas, void* nrm, void* scratch, int batch,
                                    int chi, int dw, int p, int k, int reorth, float tol,
                                    void* stream) {
  const Args a{static_cast<const float2*>(f), static_cast<const float2*>(v), static_cast<const float2*>(w),
               static_cast<const float2*>(g), sf, sv, sg, heff::VLayout{sc0, sc1, sp, sq}, static_cast<float2*>(basis),
               static_cast<float2*>(scratch), static_cast<float*>(alphas), static_cast<float*>(betas),
               static_cast<float*>(nrm), batch, chi, k, reorth, tol};
  return checked_dispatch(p, dw, a, static_cast<cudaStream_t>(stream), nullptr);
}

// The clusters of this shape (p, dw, chi) that the card
// holds at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int lanczos_solve_max_clusters(int chi, int dw, int p) {
  Args a{};
  a.batch = 1;
  a.chi = chi;
  a.k = 1;
  int held = 0;
  const int err = checked_dispatch(p, dw, a, nullptr, &held);
  return err == 0 ? held : -err;
}
