// Kernel K12: a padded MPO applied across a batch of state vectors, plus the
// one-site terms of the MCWF effective Hamiltonian:
//   out = MPO psi + sum_s local[s]_(site s) psi,   psi (B, 2^L), site 0 least significant.
// The MPO is contracted site by site, carrying its bond leg: x_0 = psi
// (bond 1, row 0 of W_0), x_{i+1}[R, idx] = sum_{l, in} W_i[o, in, l, R]
// x_i[l, idx with bit i = in] where o = bit i of idx, and the last site keeps
// column 0 of W_{L-1}.
//
// Replaces: yaqs_tpu/analog/mcwf.py mpo_matvec_statevector (:229) and the
// -0.5j (A^dag A) terms of heff_mv in mcwf_trajectory_local (:315-323),
// which JAX runs as one einsum and two moveaxis copies per site and one
// einsum per channel (XLA chain K12).
//
// What bounds it on the card: device memory for this design.  The work is
// Dw_in Dw_out d 2^L complex multiply-adds per site (about 0.7 ms of FP32 at
// B = 16, L = 20, Dw = 3), the function's own bytes are psi in and out
// (0.08 ms), but one pass per site reads and writes the bond-carrying
// (B, Dw, 2^L) vector: about 0.9 GiB per trajectory at L = 20, Dw = 3,
// about 4.5 ms at B = 16.  Fusing several sites into one pass through shared
// memory would close most of that gap.
//
// Design: one launch per site over (pairs of 2^L / 2, B).  A thread owns
// one pair of indices that differ only in bit i, reads the Dw_in values of
// both (the site index is addressed by its stride 2^i; no copies), and
// writes the Dw_out values of both, so every element is read once and
// written once per site; consecutive threads take consecutive pairs, so the
// loads coalesce for every site above 4.  W_i sits in shared memory.  The
// one-site terms ride on the last site's pass: a thread adds
// sum_s local[s][o_s, o_s] psi[idx] (one read of psi) plus, for a site whose
// term has off-diagonal entries, local[s][o_s, 1 - o_s] psi[idx ^ 2^s].
// Blocks tile 2^L, so a batch of 16 vectors of 8 MiB spreads over the card;
// 2^L need not divide the block size.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDw = 8;
constexpr int kMaxSites = 30;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}

// x: (B, dw_in, n) with batch stride sxb and bond stride n (dw_in = 1 at
// site 0, where x is psi); y: (B, dw_out, n), batch stride dw_out * n.
// w_site: W_i (2, 2, DW, DW).  local: (L, 2, 2) or null (only the last site).
template <int DW>
__global__ void __launch_bounds__(kThreads)
sv_mpo_site_kernel(const float2* __restrict__ x, long long sxb, float2* __restrict__ y,
                   const float2* __restrict__ w_site, int site, int dw_in, int dw_out, long long n,
                   const float2* __restrict__ psi, long long spsi, const float2* __restrict__ local, int length) {
  __shared__ float2 sw[4 * DW * DW];
  __shared__ float2 sloc[4 * kMaxSites];
  __shared__ int soff[kMaxSites];
  for (int e = threadIdx.x; e < 4 * DW * DW; e += kThreads) sw[e] = w_site[e];
  if (local != nullptr) {
    for (int e = threadIdx.x; e < 4 * length; e += kThreads) sloc[e] = local[e];
    __syncthreads();
    if (threadIdx.x < length) {
      const float2 a = sloc[4 * threadIdx.x + 1], b = sloc[4 * threadIdx.x + 2];
      soff[threadIdx.x] = (a.x != 0.f || a.y != 0.f || b.x != 0.f || b.y != 0.f) ? 1 : 0;
    }
  }
  __syncthreads();

  const long long half = n >> 1;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= half) return;
  const int z = blockIdx.y;
  const long long bit = 1LL << site;
  const long long lo = ((p >> site) << (site + 1)) | (p & (bit - 1));
  const long long hi = lo | bit;

  const float2* xz = x + z * sxb;
  float2 in[DW][2];
#pragma unroll
  for (int l = 0; l < DW; ++l) {
    if (l < dw_in) {
      in[l][0] = xz[l * n + lo];
      in[l][1] = xz[l * n + hi];
    }
  }
  float2* yz = y + static_cast<long long>(z) * dw_out * n;
#pragma unroll
  for (int r = 0; r < DW; ++r) {
    if (r >= dw_out) break;
    float2 acc[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
    for (int o = 0; o < 2; ++o) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int l = 0; l < DW; ++l) {
          if (l < dw_in) cfma(acc[o], sw[((o * 2 + i) * DW + l) * DW + r], in[l][i]);
        }
      }
    }
    if (local != nullptr) {  // the last site: dw_out == 1
      const float2* pz = psi + z * spsi;
      const long long idx[2] = {lo, hi};
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const float2 pv = pz[idx[o]];
        float2 diag = make_float2(0.f, 0.f);
        for (int s = 0; s < length; ++s) {
          const int bs = static_cast<int>((idx[o] >> s) & 1);
          const float2 dv = sloc[4 * s + 3 * bs];  // local[s][bs][bs]
          diag.x += dv.x;
          diag.y += dv.y;
          if (soff[s]) cfma(acc[o], sloc[4 * s + 2 * bs + (1 - bs)], pz[idx[o] ^ (1LL << s)]);
        }
        cfma(acc[o], diag, pv);
      }
    }
    yz[r * n + lo] = acc[0];
    yz[r * n + hi] = acc[1];
  }
}

template <int DW>
int launch_sites(const float2* w, const float2* psi, long long spsi, const float2* local, float2* out,
                 float2* scratch, int batch, int length, cudaStream_t stream) {
  const long long n = 1LL << length;
  const long long half = n >> 1;
  const dim3 grid(static_cast<unsigned>((half + kThreads - 1) / kThreads), batch);
  const long long buf = static_cast<long long>(batch) * DW * n;
  for (int i = 0; i < length; ++i) {
    const bool first = i == 0, last = i == length - 1;
    const float2* x = first ? psi : scratch + ((i - 1) % 2) * buf;
    const long long sxb = first ? spsi : static_cast<long long>(DW) * n;
    float2* y = last ? out : scratch + (i % 2) * buf;
    sv_mpo_site_kernel<DW><<<grid, kThreads, 0, stream>>>(
        x, sxb, y, w + static_cast<long long>(i) * 4 * DW * DW, i, first ? 1 : DW, last ? 1 : DW, n, psi, spsi,
        last ? local : nullptr, length);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// w (L, 2, 2, dw, dw) contiguous; psi (batch, 2^L) with batch stride spsi
// (elements) and unit inner stride; local (L, 2, 2) or null; out (batch,
// 2^L) contiguous; scratch (2, batch, dw, 2^L) for L > 1.
extern "C" int sv_mpo_matvec_launch(const void* w, const void* psi, long long spsi, const void* local, void* out,
                                    void* scratch, int batch, int length, int dw, void* stream) {
  if (batch <= 0 || batch > 65535 || length <= 0 || length > kMaxSites || dw <= 0 || dw > kMaxDw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto ww = static_cast<const float2*>(w);
  const auto pp = static_cast<const float2*>(psi);
  const auto lc = static_cast<const float2*>(local);
  const auto oo = static_cast<float2*>(out);
  const auto sc = static_cast<float2*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dw) {
    case 1: return launch_sites<1>(ww, pp, spsi, lc, oo, sc, batch, length, s);
    case 2: return launch_sites<2>(ww, pp, spsi, lc, oo, sc, batch, length, s);
    case 3: return launch_sites<3>(ww, pp, spsi, lc, oo, sc, batch, length, s);
    case 4: return launch_sites<4>(ww, pp, spsi, lc, oo, sc, batch, length, s);
    case 5: return launch_sites<5>(ww, pp, spsi, lc, oo, sc, batch, length, s);
    case 6: return launch_sites<6>(ww, pp, spsi, lc, oo, sc, batch, length, s);
    case 7: return launch_sites<7>(ww, pp, spsi, lc, oo, sc, batch, length, s);
    default: return launch_sites<8>(ww, pp, spsi, lc, oo, sc, batch, length, s);
  }
}
