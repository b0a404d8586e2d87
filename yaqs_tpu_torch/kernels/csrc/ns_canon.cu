// Kernel K6: the Newton canonicalization scan of a batch of padded MPS, one
// thread block per trajectory walking its chain from right to left.
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
// 6.3 M complex MACs a site at chi = 64, 99 sites and 32 trajectories,
// against 2 * 52 MB of device traffic.  Eager PyTorch runs 99 K4 launches
// and some 600 other launches, the carry and the block going through device
// memory between them.
//
// Design: the block M^H (the polar factor's iterate), M itself, x g and g
// stay in shared memory (64 + 64 + 64 + 32 KB at d = 2, chi = 64, just under
// the 227 KB a block may use), and the carry lives between two sites in the
// x g buffer, which the polar factor needs only as work space: the chain
// reads each site tensor once from device memory and writes each output
// site once.  Only B blocks run (32 of 132 SMs at the analog shape); the
// scan is sequential over sites, and splitting a site's polar factor over a
// cluster is the next step for speed.

#include "ns_polar.cuh"

namespace {

__global__ void __launch_bounds__(kNsThreads)
ns_canon_kernel(const float2* __restrict__ in, float2* __restrict__ out, int L, int d, int chi) {
  extern __shared__ float2 smem[];
  const int dchi = d * chi;
  const int cc = chi * chi;
  float2* sx = smem;            // (d chi, chi): M^H, then x
  float2* sxg = sx + dchi * chi;  // (d chi, chi): the polar factor's x g; the carry (chi, chi) between sites
  float2* sg = sxg + dchi * chi;  // (chi, chi)
  float2* sm = sg + cc;           // (chi, d chi): M
  float* red = reinterpret_cast<float*>(sm + dchi * chi);
  const size_t site = static_cast<size_t>(d) * cc;
  const float2* tz = in + static_cast<size_t>(blockIdx.x) * L * site;
  float2* oz = out + static_cast<size_t>(blockIdx.x) * L * site;

  for (int e = threadIdx.x; e < cc; e += blockDim.x) {
    sxg[e] = make_float2(e / chi == e % chi ? 1.f : 0.f, 0.f);
  }
  __syncthreads();
  for (int i = L - 1; i >= 1; --i) {
    const float2* a = tz + i * site;
    for (int s = 0; s < d; ++s) {
      product<false>(a + s * cc, chi, 1, sxg, chi, chi, chi, chi, [&](int l, int mm, float2 v) {
        sm[l * dchi + s * chi + mm] = v;
        sx[(s * chi + mm) * chi + l] = conj2(v);
      });
    }
    __syncthreads();
    ns_polar_block(sx, sxg, sg, red, dchi, chi);
    float2* o = oz + i * site;
    for (int e = threadIdx.x; e < d * cc; e += blockDim.x) {
      const int s = e / cc, l = (e / chi) % chi, mm = e % chi;
      o[e] = (i == L - 1 && mm >= 1) ? make_float2(0.f, 0.f) : conj2(sx[(s * chi + mm) * chi + l]);
    }
    // c = M x: (chi, d chi) (d chi, chi), into the x g buffer
    product<false>(sm, dchi, 1, sx, chi, chi, chi, dchi, [&](int l, int j, float2 v) { sxg[l * chi + j] = v; });
    __syncthreads();
  }
  for (int s = 0; s < d; ++s) {
    product<false>(tz + s * cc, chi, 1, sxg, chi, chi, chi, chi, [&](int l, int mm, float2 v) {
      oz[s * cc + l * chi + mm] = l >= 1 ? make_float2(0.f, 0.f) : v;
    });
  }
}

}  // namespace

// in, out: (batch, L, d, chi, chi) contiguous, L >= 2, d * chi <= 128
extern "C" int ns_canon_launch(const void* in, void* out, int batch, int L, int d, int chi, void* stream) {
  if (batch <= 0 || L < 2 || d <= 0 || chi <= 0 || chi > kNsMaxCols || d * chi > kNsMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t dchi = static_cast<size_t>(d) * chi;
  const size_t smem = sizeof(float2) * (3 * dchi * chi + static_cast<size_t>(chi) * chi) +
                      sizeof(float) * ns_scratch_floats(chi);
  cudaError_t err = allow_smem(ns_canon_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_canon_kernel<<<batch, kNsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(in), static_cast<float2*>(out), L, d, chi);
  return static_cast<int>(cudaGetLastError());
}
