// Kernel K11: projective Z-basis shots from a batch of canonical-at-0 MPS.
// For each trajectory b and shot q, starting from v = e_0 and site by site:
//   w_s = v A_i[s],  p_s = |w_s|^2 / sum_s' |w_s'|^2,
//   s* = argmax_s (log max(p_s, tiny) + g[b, q, i, s]),  v = w_s* / |w_s*|,
// with the Gumbel noise g handed in, so out[b, q, i] = s*.
//
// Replaces: yaqs_tpu/digital/engine.py sample_bitstrings (:623-651, the
// chain K11), whose lax.scan over sites inside a vmap over shots runs as one
// small product per site in eager PyTorch (3-4 launches per site).  The
// digital run samples one shot from each of B = 512 trajectories at L = 20,
// chi = 32; the noiseless path takes all shots from one trajectory.
//
// What bounds it on the card: device memory where each trajectory has few
// shots (168 MB of state at B = 512, L = 20, chi = 32: 50 us at 3.35
// TB/s); operations where one trajectory has thousands (d chi^2 complex MACs
// a shot and site: 4096 shots at L = 4, chi = 32 are 0.27 GFLOP, 4 us at 67
// TFLOP/s).
//
// Design: a block serves one trajectory, or one group of its shots (the
// wrapper's plan, sample_shots.plan: one shot a block at B = 512, S = 1;
// groups of 32 shots, 8 warps of 4, at S = 4096).  The trajectory's sites
// stream through a ring of kStages shared-memory stages by cp.async (16
// bytes where chi is even), each site read from device memory once for all
// of the block's shots; a site larger than kChunkBytes (d = 4, chi = 64:
// 128 KB) goes in chunks of rows l.  The copy of the chunks two ahead is
// issued before a chunk's products, so no warp waits on device memory in its
// dependent loop.  With each site's last chunk the stage also takes the
// site's Gumbel noise for the block's shots.  A warp carries kW shots at
// once (1, or kShots = 4 where a trajectory has several): lanes over the
// right bond index r (two columns a lane at chi > 32), each site value
// A[s, l, r] read from shared memory once for all of them, each shot's v[l]
// a broadcast read of its row of v (kept in shared memory); the loop over
// l has no branch, a slot past the block's last shot computing on its own
// row and writing nothing.  At a site's end p_s is reduced with shuffles
// (the kW kD sums interleaved) and broadcast from lane 0, so every lane
// takes the same choice; lane 0 writes out.  The floor follows the float32 reference: max(p, 1e-300) is max(p, 0)
// in float32, so p = 0 gives -inf and is never chosen over a positive
// probability; ties go to the lowest index, as argmax does.  w is summed
// over l in ascending order whatever the chunks.

#include <math_constants.h>

#include "launch.cuh"

namespace {

constexpr int kMaxChi = 64;
constexpr int kMaxD = 4;
constexpr int kShots = 4;                // shots a warp carries where a trajectory has several
constexpr int kMaxWarps = 8;
constexpr int kStages = 3;               // ring stages
constexpr int kChunkBytes = 64 * 1024;   // the most of a site one stage holds

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A ring stage, in float2: the chunk (d, rows, chi), then the site's noise
// (group d floats), each rounded up to 16 bytes; after the ring, v (group,
// chi).
struct ShotLayout {
  int site, stage;
  __host__ __device__ ShotLayout(int d, int chi, int group, int rows) {
    site = cdiv(d * rows * chi, 2) * 2;
    stage = site + cdiv(group * d, 4) * 2;
  }
  __host__ __device__ size_t bytes(int group, int chi) const {
    return sizeof(float2) * (static_cast<size_t>(kStages) * stage + static_cast<size_t>(group) * chi);
  }
};

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// kD: the local dimension d; kCols: columns r a lane owns (chi <= 32 kCols);
// kW: shots a warp carries (a block has group / kW warps).  vec: chi even and
// the state 16-byte aligned, so the chunks are copied 16 bytes at a time.
template <int kD, int kCols, int kW>
__global__ void __launch_bounds__(kMaxWarps * 32)
sample_shots_kernel(const float2* __restrict__ t, const float* __restrict__ g, int* __restrict__ out, int shots,
                    int L, int chi, int group, int rows, bool vec) {
  extern __shared__ float4 smem4[];
  const ShotLayout ly(kD, chi, group, rows);
  float2* ring = reinterpret_cast<float2*>(smem4);
  float2* vbuf = ring + kStages * ly.stage;  // v of the block's shot j at j chi
  const int groups = cdiv(shots, group);
  const long long z = blockIdx.x / groups;
  const int q0 = (blockIdx.x % groups) * group;
  const int count = min(group, shots - q0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const int nchunk = cdiv(chi, rows);
  const int cc = chi * chi;
  const float2* tz = t + z * L * kD * cc;
  const float* gz = g + (z * shots + q0) * L * kD;

  // chunk q: rows [c rows, ...) of site i = q / nchunk, c = q % nchunk, at
  // (s rows + ll) chi + r of stage q % kStages; with a site's last chunk, its
  // noise for the block's shots at j kD + s after the chunk
  auto load_chunk = [&](int q) {
    const int i = q / nchunk, c = q % nchunk;
    const int l0 = c * rows, nr = min(rows, chi - l0);
    float2* dst = ring + (q % kStages) * ly.stage;
    const float2* src = tz + static_cast<long long>(i) * kD * cc + l0 * chi;
    const int run = nr * chi;  // one s's rows are contiguous in the site
#pragma unroll
    for (int s = 0; s < kD; ++s) {
      if (vec) {
        const float4* from = reinterpret_cast<const float4*>(src + s * cc);
        float4* to = reinterpret_cast<float4*>(dst + s * rows * chi);
        for (int k = tid; k < run / 2; k += nth) cp_async16(to + k, from, k, true);
      } else {
        for (int k = tid; k < run; k += nth) cp_async8(dst + s * rows * chi + k, src + s * cc + k);
      }
    }
    if (c == nchunk - 1) {
      float* noise = reinterpret_cast<float*>(dst + ly.site);
      for (int j = tid; j < count; j += nth)
#pragma unroll
        for (int s = 0; s < kD; ++s) cp_async4(noise + j * kD + s, gz + (static_cast<long long>(j) * L + i) * kD + s);
    }
  };

  for (int j = warp; j < group; j += nth / 32)
    for (int r = lane; r < chi; r += 32) vbuf[j * chi + r] = make_float2(r == 0 ? 1.f : 0.f, 0.f);
  const int nq = L * nchunk;
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < nq) load_chunk(q);
    cp_async_commit();  // empty groups keep the count of groups in flight uniform
  }

  const int j0 = warp * kW;   // the warp's first shot in the block
  float2* vw = vbuf + j0 * chi;  // its shots' rows of v
  float2 acc[kW][kD][kCols];
#pragma unroll
  for (int u = 0; u < kW; ++u)
#pragma unroll
    for (int s = 0; s < kD; ++s)
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[u][s][k] = make_float2(0.f, 0.f);

  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages - 2>();  // chunk q has landed for this thread ...
    __syncthreads();               // ... and for all; every warp is done with chunk q - 1's stage
    if (q + kStages - 1 < nq) load_chunk(q + kStages - 1);
    cp_async_commit();
    if (j0 >= count) continue;  // a warp past the block's last shot only copies
    const int i = q / nchunk, c = q % nchunk;
    const int l0 = c * rows, nr = min(rows, chi - l0);
    const float2* sa = ring + (q % kStages) * ly.stage + lane;  // A[s, l0 + ll, lane + 32 k] at (s rows + ll) chi + 32 k
    const float2* vl0 = vw + l0;
    const int sstride = rows * chi;
#pragma unroll 4
    for (int ll = 0; ll < nr; ++ll) {
      float2 av[kD][kCols];
#pragma unroll
      for (int s = 0; s < kD; ++s)
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          av[s][k] = lane + 32 * k < chi ? sa[s * sstride + ll * chi + 32 * k] : make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        const float2 vl = vl0[u * chi + ll];
#pragma unroll
        for (int s = 0; s < kD; ++s)
#pragma unroll
          for (int k = 0; k < kCols; ++k) cfma(acc[u][s][k], vl, av[s][k]);
      }
    }
    if (c != nchunk - 1) continue;

    // site i is complete: choose, write, and normalize each shot's v
    const float* noise = reinterpret_cast<const float*>(ring + (q % kStages) * ly.stage + ly.site) + j0 * kD;
    float p[kW][kD];
#pragma unroll
    for (int u = 0; u < kW; ++u)
#pragma unroll
      for (int s = 0; s < kD; ++s) {
        p[u][s] = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) p[u][s] += acc[u][s][k].x * acc[u][s][k].x + acc[u][s][k].y * acc[u][s][k].y;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kW; ++u)
#pragma unroll
        for (int s = 0; s < kD; ++s) p[u][s] += __shfl_down_sync(0xffffffffu, p[u][s], off);
    __syncwarp();  // every lane has read v for this site
#pragma unroll
    for (int u = 0; u < kW; ++u) {
      float total = 0.f;
#pragma unroll
      for (int s = 0; s < kD; ++s) {
        p[u][s] = __shfl_sync(0xffffffffu, p[u][s], 0);  // one value for every lane
        total += fmaxf(p[u][s], 0.f);
      }
      float best = -CUDART_INF_F;
      int pick = 0;
#pragma unroll
      for (int s = 0; s < kD; ++s) {
        const float pq = fmaxf(p[u][s], 0.f) / total;
        const float val = (pq > 0.f ? logf(pq) : -CUDART_INF_F) + noise[u * kD + s];
        if (val > best) {
          best = val;
          pick = s;
        }
      }
      if (lane == 0 && j0 + u < count) out[(z * shots + q0 + j0 + u) * L + i] = pick;
      float2 chosen[kCols];
      float norm2 = 0.f;
#pragma unroll
      for (int s = 0; s < kD; ++s) {
        if (s == pick) {
#pragma unroll
          for (int k = 0; k < kCols; ++k) chosen[k] = acc[u][s][k];
          norm2 = p[u][s];
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[u][s][k] = make_float2(0.f, 0.f);
      }
      const float inv = 1.f / sqrtf(norm2);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int r = lane + 32 * k;
        if (r < chi) vw[u * chi + r] = make_float2(chosen[k].x * inv, chosen[k].y * inv);
      }
    }
  }
}

template <int kD, int kCols, int kW>
int launch(const float2* t, const float* g, int* out, int blocks, int shots, int L, int chi, int group, int rows,
           bool vec, cudaStream_t stream) {
  static const cudaError_t configured = prepare(sample_shots_kernel<kD, kCols, kW>, kSmemLimit);  // once
  if (configured != cudaSuccess) return static_cast<int>(configured);
  sample_shots_kernel<kD, kCols, kW><<<blocks, 32 * (group / kW), ShotLayout(kD, chi, group, rows).bytes(group, chi),
                                       stream>>>(t, g, out, shots, L, chi, group, rows, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int kD>
int launch_d(const float2* t, const float* g, int* out, int blocks, int shots, int L, int chi, int group,
             int per_warp, int rows, bool vec, cudaStream_t stream) {
  if (per_warp == 1) {
    return chi <= 32 ? launch<kD, 1, 1>(t, g, out, blocks, shots, L, chi, group, rows, vec, stream)
                     : launch<kD, 2, 1>(t, g, out, blocks, shots, L, chi, group, rows, vec, stream);
  }
  return chi <= 32 ? launch<kD, 1, kShots>(t, g, out, blocks, shots, L, chi, group, rows, vec, stream)
                   : launch<kD, 2, kShots>(t, g, out, blocks, shots, L, chi, group, rows, vec, stream);
}

}  // namespace

// t (batch, L, d, chi, chi) complex64, g (batch, shots, L, d) float32,
// out (batch, shots, L) int32.  The plan (sample_shots.plan): group, the
// shots of a block (a trajectory has ceil(shots / group) blocks); per_warp,
// the shots a warp carries (1 or kShots; group / per_warp <= kMaxWarps
// warps); rows, the rows l of a site a stage holds.
extern "C" int sample_shots_launch(const void* t, const void* g, void* out, int batch, int shots, int L, int d,
                                   int chi, int group, int per_warp, int rows, void* stream) {
  if (batch <= 0 || shots <= 0 || L <= 0 || d <= 0 || d > kMaxD || chi <= 0 || chi > kMaxChi || group <= 0 ||
      (per_warp != 1 && per_warp != kShots) || group % per_warp != 0 || group / per_warp > kMaxWarps || rows <= 0 ||
      rows > chi || ShotLayout(d, chi, group, rows).bytes(group, chi) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(batch) * cdiv(shots, group);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = chi % 2 == 0 && (reinterpret_cast<unsigned long long>(t) & 15ULL) == 0;
  const auto tp = static_cast<const float2*>(t);
  const auto gp = static_cast<const float*>(g);
  const auto op = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  switch (d) {
    case 1: return launch_d<1>(tp, gp, op, nb, shots, L, chi, group, per_warp, rows, vec, s);
    case 2: return launch_d<2>(tp, gp, op, nb, shots, L, chi, group, per_warp, rows, vec, s);
    case 3: return launch_d<3>(tp, gp, op, nb, shots, L, chi, group, per_warp, rows, vec, s);
    default: return launch_d<4>(tp, gp, op, nb, shots, L, chi, group, per_warp, rows, vec, s);
  }
}
