// Kernels K1 (matvec) and K2: the merged-MPO effective Hamiltonian of TDVP,
// per trajectory,
//   X[a, (w, c), q] = sum_p f[a, w, p] v[c, p, q]
//   Y[a, q, (x, u)] = sum_(w, c) X[a, (w, c), q] W[(w, c), (x, u)]
//   out[x, a, b]    = sum_(q, u) Y[a, q, (x, u)] g[b, u, q]
// with c, x running over the P physical combinations of the block: P = d^2
// = 4 for the two-site block theta (B, d, d, chi, chi) and the merged pair
// W12 (Dw d^2, d^2 Dw) (kernel heff2), P = d = 2 for one site a (B, d, chi,
// chi) and Wm (Dw d, d Dw) (kernel heff1).  f, g (B, chi, Dw, chi) are the
// left and right environments; W is shared by the batch.
//
// Replaces: yaqs_tpu/methods/tdvp.py heff_two_site_merged (:173-185) and
// heff_one_site_merged (:188-196), the matvecs of every Lanczos solve of a
// TDVP sweep (XLA chains K1 and K2).  The sweep runs its solves' matvecs
// inside lanczos_solve.cu; this kernel is the single matvec.
//
// What bounds it on the card: operations.  At chi = 64, Dw = 3 the two-site
// product is 6.88 M complex MACs per trajectory (2 P Dw chi^3 + (P Dw)^2
// chi^2) against 2 (P + Dw) chi^2 complex values moved; at B = 32 that is
// 1.76 GFLOP, 26 us at 67 TFLOP/s fp32.  Eager PyTorch writes X and Y
// (chi^2 P Dw complex values each, 655 KB per trajectory at Dw = 5) to
// device memory and adds a permute copy between the products.
//
// Design: grid (tiles of TA rows a, B), 256 threads, the body of heff.cuh
// (its header comment gives the tiles).  A block stages its tile's rows of f
// and all of W in shared memory; X and Y never leave the SM, and the output
// is written in its final (x, a, b) layout, so no permute copy follows.
// The Lanczos solves run the same body inside one launch a solve
// (lanczos_solve.cu); this kernel is the single matvec behind
// heff_two_site_merged / heff_one_site_merged.

#include "heff.cuh"

namespace {

using heff::kMaxChi;
using heff::kMaxDw;
using heff::kThreads;
using heff::Tile;

template <int P, int DW>
__device__ __forceinline__ void heff_block(const float2* f, long long sf, const float2* v, long long sv,
                                           const float2* w, const float2* g, long long sg, float2* out, int chi) {
  using T = Tile<P, DW>;
  const int chs = heff::even(chi);
  extern __shared__ float4 smem_raw[];
  float2* fs = reinterpret_cast<float2*>(smem_raw);
  float2* ws = fs + T::f_elems(chs);
  float2* xy = ws + T::w_elems();
  float2* gs = xy + T::xy_elems(chs);
  const long long z = blockIdx.y;
  const int a0 = blockIdx.x * T::TA;
  heff::stage_f<P, DW>(fs, f + z * sf, a0, chi, chs);
  for (int e = threadIdx.x; e < T::w_elems(); e += kThreads) ws[e] = w[e];
  __syncthreads();
  float2 acc[T::RG][2];
  const heff::VLayout vl = heff::VLayout::contiguous<P>(chi);
  heff::matvec_tile<P, DW>(fs, ws, xy, gs, v + z * sv, vl, 1.f, g + z * sg, chi, chs, acc);
  float2* oz = out + z * static_cast<long long>(P) * chi * chi;
#pragma unroll
  for (int i = 0; i < T::RG; ++i) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int idx = heff::owned_index<P, DW>(a0, i, s, chi, chs);
      if (idx >= 0) oz[idx] = acc[i][s];
    }
  }
}

// the kernels carry their wrappers' names, which the profiler's rows show
template <int DW>
__global__ void __launch_bounds__(kThreads, 2)
heff2_kernel(const float2* f, long long sf, const float2* v, long long sv, const float2* w, const float2* g,
             long long sg, float2* out, int chi) {
  heff_block<4, DW>(f, sf, v, sv, w, g, sg, out, chi);
}

template <int DW>
__global__ void __launch_bounds__(kThreads, 2)
heff1_kernel(const float2* f, long long sf, const float2* v, long long sv, const float2* w, const float2* g,
             long long sg, float2* out, int chi) {
  heff_block<2, DW>(f, sf, v, sv, w, g, sg, out, chi);
}

template <int P, int DW>
size_t smem_bytes(int chi) {
  using T = Tile<P, DW>;
  const int chs = heff::even(chi);
  return sizeof(float2) * (T::f_elems(chs) + T::w_elems() + T::xy_elems(chs) + T::g_elems(chs));
}

template <int P, int DW>
int launch(const void* f, long long sf, const void* v, long long sv, const void* w, const void* g, long long sg,
           void* out, int batch, int chi, cudaStream_t stream) {
  using T = Tile<P, DW>;
  auto kernel = P == 4 ? heff2_kernel<DW> : heff1_kernel<DW>;
  // once per instantiation: the opt-in limit for the largest chi it takes
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes<P, DW>(kMaxChi)));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((chi + T::TA - 1) / T::TA, batch);
  kernel<<<grid, kThreads, smem_bytes<P, DW>(chi), stream>>>(
      static_cast<const float2*>(f), sf, static_cast<const float2*>(v), sv, static_cast<const float2*>(w),
      static_cast<const float2*>(g), sg, static_cast<float2*>(out), chi);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int dispatch(int dw, const void* f, long long sf, const void* v, long long sv, const void* w, const void* g,
             long long sg, void* out, int batch, int chi, cudaStream_t stream) {
  switch (dw) {
    case 1: return launch<P, 1>(f, sf, v, sv, w, g, sg, out, batch, chi, stream);
    case 2: return launch<P, 2>(f, sf, v, sv, w, g, sg, out, batch, chi, stream);
    case 3: return launch<P, 3>(f, sf, v, sv, w, g, sg, out, batch, chi, stream);
    case 4: return launch<P, 4>(f, sf, v, sv, w, g, sg, out, batch, chi, stream);
    case 5: return launch<P, 5>(f, sf, v, sv, w, g, sg, out, batch, chi, stream);
    case 6: return launch<P, 6>(f, sf, v, sv, w, g, sg, out, batch, chi, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// f, g: (chi, dw, chi) contiguous per trajectory, sf / sg elements between
// trajectories; v: (p, chi, chi) per trajectory, stride sv; w: (dw p, p dw);
// out: (batch, p, chi, chi) contiguous.  p = 4 launches heff2, p = 2 heff1.
extern "C" int heff_launch(const void* f, long long sf, const void* v, long long sv, const void* w, const void* g,
                           long long sg, void* out, int batch, int chi, int dw, int p, void* stream) {
  if (batch <= 0 || batch > 65535 || chi <= 0 || chi > kMaxChi || dw <= 0 || dw > kMaxDw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (p == 4) return dispatch<4>(dw, f, sf, v, sv, w, g, sg, out, batch, chi, s);
  if (p == 2) return dispatch<2>(dw, f, sf, v, sv, w, g, sg, out, batch, chi, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
