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
// What bounds it on the card: latency.  A shot is L dependent steps of
// d chi^2 complex MACs (41 k at the bench shape) with a warp reduction and a
// choice between them; the state is read once per shot (from L2 when several
// shots share a trajectory).  Bytes bound: 168 MB of state at the bench
// shape, 50 us at 3.35 TB/s.
//
// Design: one warp per shot, lanes over the right bond index (chi <= 64, two
// columns a lane), v in shared memory.  p_s is reduced with shuffles and
// broadcast from lane 0, so every lane takes the same choice.  The floor
// follows the float32 reference: max(p, 1e-300) is max(p, 0) in float32, so
// p = 0 gives -inf and is never chosen over a positive probability; ties go
// to the lowest index, as argmax does.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxChi = 64;
constexpr int kMaxD = 4;
constexpr int kCols = kMaxChi / 32;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sample_shots_kernel(const float2* __restrict__ t, const float* __restrict__ g, int* __restrict__ out,
                    int batch, int shots, int L, int d, int chi) {
  __shared__ float2 sv[kWarpsPerBlock][kMaxChi];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long w = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;  // (b, q) flat
  if (w >= static_cast<long long>(batch) * shots) return;  // whole warp leaves together
  const long long z = w / shots;
  const size_t site_elems = static_cast<size_t>(d) * chi * chi;
  float2* v = sv[warp];
  for (int c = lane; c < chi; c += 32) v[c] = make_float2(c == 0 ? 1.f : 0.f, 0.f);
  __syncwarp();

  for (int i = 0; i < L; ++i) {
    const float2* site = t + (static_cast<size_t>(z) * L + i) * site_elems;
    float2 wv[kMaxD][kCols];
#pragma unroll
    for (int s = 0; s < kMaxD; ++s)
#pragma unroll
      for (int c = 0; c < kCols; ++c) wv[s][c] = make_float2(0.f, 0.f);
    for (int l = 0; l < chi; ++l) {
      const float2 vl = v[l];
#pragma unroll
      for (int s = 0; s < kMaxD; ++s) {
        if (s >= d) break;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int r = lane + 32 * c;
          if (r < chi) cfma(wv[s][c], vl, site[(static_cast<size_t>(s) * chi + l) * chi + r]);
        }
      }
    }
    float p[kMaxD];
    float total = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxD; ++s) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc += wv[s][c].x * wv[s][c].x + wv[s][c].y * wv[s][c].y;
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      p[s] = __shfl_sync(0xffffffffu, acc, 0);  // one value for every lane
      if (s < d) total += fmaxf(p[s], 0.f);
    }
    const float* gi = g + (static_cast<size_t>(w) * L + i) * d;
    float best = -CUDART_INF_F;
    int pick = 0;
    for (int s = 0; s < d; ++s) {
      const float q = fmaxf(p[s], 0.f) / total;
      const float val = (q > 0.f ? logf(q) : -CUDART_INF_F) + gi[s];
      if (val > best) {
        best = val;
        pick = s;
      }
    }
    if (lane == 0) out[static_cast<size_t>(w) * L + i] = pick;
    float2 chosen[kCols];
    float norm2 = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxD; ++s) {
      if (s == pick) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) chosen[c] = wv[s][c];
        norm2 = p[s];
      }
    }
    const float inv = 1.f / sqrtf(norm2);
    __syncwarp();  // every lane has read v for this site
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int r = lane + 32 * c;
      if (r < chi) v[r] = make_float2(chosen[c].x * inv, chosen[c].y * inv);
    }
    __syncwarp();
  }
}

}  // namespace

// t (batch, L, d, chi, chi) complex64, g (batch, shots, L, d) float32,
// out (batch, shots, L) int32
extern "C" int sample_shots_launch(const void* t, const void* g, void* out, int batch, int shots, int L, int d,
                                   int chi, void* stream) {
  if (batch <= 0 || shots <= 0 || L <= 0 || d <= 0 || d > kMaxD || chi <= 0 || chi > kMaxChi) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long warps = static_cast<long long>(batch) * shots;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  sample_shots_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(t), static_cast<const float*>(g), static_cast<int*>(out), batch, shots, L, d,
      chi);
  return static_cast<int>(cudaGetLastError());
}
