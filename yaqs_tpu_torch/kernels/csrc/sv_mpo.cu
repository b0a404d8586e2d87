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
// What bounds it on the card: instruction issue in the site updates, once
// the bond-carrying vector stays on chip.  The dense work is Dw_in Dw_out d
// 2^L complex multiply-adds per site (0.6751 ms of FP32 at B = 16, L = 20,
// Dw = 3; 0.1943 ms on the nonzero entries of the TFIM W_i, which this
// design skips), and the function's own bytes are psi in and out (0.08 ms).
// The earlier design made one pass per site through device memory, reading
// and writing the bond-carrying (B, Dw, 2^L) vector each time: about 16 GB a
// matvec at that shape, 5.3555 ms (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// Design: several consecutive sites a pass, through shared memory.  A pass
// over sites [a, a + g) is one launch over (tiles, B).  A block's tile is
// the 2^(g + c) indices whose bits a .. a + g - 1 and 0 .. c - 1 vary, the
// other bits fixed by the block: the first pass (a = 0, c = 0) takes a
// contiguous run of 2^g amplitudes, a later pass 2^g groups of 2^c = 4
// contiguous amplitudes (one 32-byte sector each) at a stride of 2^a.  The
// block loads the tile's (Dw_in, 2^(g + c)) values into shared memory by
// cp.async, applies its g sites there in rounds of R (a thread takes the
// 2^R indices that differ in the round's bits into registers, applies R
// sites to them, each read of W_i feeding 2^(R - 1) pairs, and stores them
// back: one shared-memory round trip a round, not a site), and writes
// (Dw, 2^(g + c)) at the cut, or column 0 into `out` at the last pass.  A
// tile row keeps one pad slot every 16 values, so a thread's consecutive
// indices fall in distinct banks across a half-warp.  So device memory
// holds the bond-carrying vector only at the cuts between passes, in one
// scratch buffer (B, Dw, 2^L) that each later pass reads and writes in place
// (tiles partition the indices), or none when one pass holds the chain.  The
// plan (the passes' first sites, site counts and contiguous bits) comes from
// the wrapper (sv_mpo.py pass_plan): at L = 20 and Dw = 3, two passes of 11
// and 9 sites, 72 KB a block, 11 vector transfers a matvec where the
// earlier design made about 120.  Entries of W_i that are exactly zero are
// skipped (a branch uniform over the block: the TFIM W_i has 10 nonzero
// complex entries of 36).  R = 2 up to Dw = 5, 1 above: R = 3 at Dw = 3
// spilled at the 128 registers of two blocks an SM and ran slower.
//
// The one-site terms ride on the passes that hold their sites' bits: every
// pass loads psi's tile beside the bond tile and adds, for each of its sites,
// local[s][o_s, o_s] psi[idx] (from tables of the summed diagonal over each
// group of 4 sites, one lookup a group) and, where the site's term has
// off-diagonal entries, local[s][o_s, 1 - o_s] psi[idx ^ 2^s] (in the same
// tile).  The first pass writes its sum into `out`, a middle pass adds to
// it, and the last pass adds column 0 of the MPO product: at two passes the
// terms cost three vector transfers (psi read again, `out` written and read
// once more).

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDw = 8;
constexpr int kMaxSites = 30;
constexpr int kMaxGroups = (kMaxSites + 3) / 4;  // groups of 4 sites in the diagonal tables
constexpr int kOutUnroll = 4;                      // indices a thread writes out at a time
// static shared memory of the pass kernel (the pass's one-site terms, their
// flags and diagonal tables: about 2.1 KB), with room to spare
constexpr size_t kStaticSmem = 3072;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}

// Where tile index t sits in a row of the tile: one pad slot every 16
// values, so that the 2^R consecutive values a thread takes at the pass's
// first round fall in distinct banks across a half-warp.
__device__ __forceinline__ int pos(int t) { return t + (t >> 4); }
__host__ __device__ __forceinline__ int row_stride(int size) { return size + (size >> 4); }

// Where a pass's tile lies: tile index t = (h << contig) | lo holds global
// index base | (h << first) | lo, with base the block's fixed bits.
struct TileMap {
  long long base;
  int first, contig;
  __device__ __forceinline__ long long operator()(int t) const {
    return base | (static_cast<long long>(t >> contig) << first) | (t & ((1 << contig) - 1));
  }
};

// R consecutive sites (site0 ..) on tile bits bit0 .. bit0 + R - 1: a thread
// takes the 2^R indices that differ in those bits (dw values each) into
// registers, applies the R sites there, each pair of indices that differ in
// the site's bit at a time (every read of W_i feeds 2^(R-1) pairs; exact
// zeros of W_i, the same for every thread, skipped), and stores them back.
// sw: W of the R sites, (R, 2, 2, DW, DW).
template <int DW, int R>
__device__ __forceinline__ void apply_round(float2* tile, int size, int stride, const float2* sw, int bit0, int site0,
                                            int length) {
  constexpr int kM = 1 << R, kQ = kM / 2;
  const int rows_in = site0 == 0 ? 1 : DW;
  const int rows_out = site0 + R == length ? 1 : DW;
  const int low = (1 << bit0) - 1;
  for (int u = threadIdx.x; u < (size >> R); u += kThreads) {
    const int base = ((u >> bit0) << (bit0 + R)) | (u & low);
    float2 v[kM][DW];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int l = 0; l < DW; ++l)
        v[m][l] = l < rows_in ? tile[l * stride + pos(base + (m << bit0))] : make_float2(0.f, 0.f);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int site = site0 + s;
      const int dw_in = site == 0 ? 1 : DW, dw_out = site == length - 1 ? 1 : DW;
      const float2* ws = sw + s * 4 * DW * DW;
      float2 acc[kQ][2][DW];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int r = 0; r < DW; ++r) acc[q][0][r] = acc[q][1][r] = make_float2(0.f, 0.f);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int l = 0; l < DW; ++l) {
            if (l >= dw_in) break;
#pragma unroll
            for (int r = 0; r < DW; ++r) {
              if (r >= dw_out) break;
              const float2 wv = ws[((o * 2 + i) * DW + l) * DW + r];
              if (wv.x == 0.f && wv.y == 0.f) continue;
#pragma unroll
              for (int q = 0; q < kQ; ++q) {
                const int m0 = ((q >> s) << (s + 1)) | (q & ((1 << s) - 1));  // bit s clear
                cfma(acc[q][o][r], wv, v[m0 | (i << s)][l]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int m0 = ((q >> s) << (s + 1)) | (q & ((1 << s) - 1));
#pragma unroll
        for (int r = 0; r < DW; ++r) {
          v[m0][r] = acc[q][0][r];
          v[m0 | (1 << s)][r] = acc[q][1][r];
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int r = 0; r < DW; ++r)
        if (r < rows_out) tile[r * stride + pos(base + (m << bit0))] = v[m][r];
  }
}

// Sites a thread holds in registers at once: 2 up to Dw = 5, 1 above, so
// that 2^R Dw values fit the registers of two blocks an SM (R = 3 spilled at
// Dw = 3; R = 1 ran slower at Dw = 3 and 5, PERF.md).
__host__ __device__ constexpr int round_sites(int dw) { return dw <= 5 ? 2 : 1; }

// One pass: sites [first, first + sites) over tiles of 2^(sites + contig)
// indices, in rounds of round_sites(DW) sites.  bond: (B, DW, 2^L) scratch,
// read unless this is the first pass (which reads psi, bond 1) and written
// unless it is the last (which writes column 0 into out).  local: (L, 2, 2)
// or null.
template <int DW>
__global__ void __launch_bounds__(kThreads, 2)
sv_mpo_pass_kernel(const float2* __restrict__ psi, long long spsi, float2* __restrict__ bond,
                   const float2* __restrict__ w, const float2* __restrict__ local, float2* __restrict__ out,
                   int length, int first, int sites, int contig) {
  extern __shared__ float2 smem[];
  __shared__ float2 sloc[4 * kMaxSites];
  __shared__ int soff[kMaxSites];
  __shared__ float2 sdiag[16 * kMaxGroups];  // group g: the summed diagonal terms of sites 4g .. 4g + 3
  __shared__ int sany_off;
  const int bits = sites + contig;
  const int size = 1 << bits, stride = row_stride(size);
  float2* tile = smem;                               // (DW, stride): tile index t at pos(t)
  float2* sps = tile + DW * stride;                  // (size): psi's tile, with one-site terms
  float2* sw = sps + (local != nullptr ? size : 0);  // (sites, 2, 2, DW, DW)
  const int z = blockIdx.y;
  const long long n = 1LL << length;
  const bool first_pass = first == 0, last_pass = first + sites == length;
  const int mid = first - contig;  // fixed bits contig .. first - 1 come from blockIdx.x's low bits
  const long long bx = blockIdx.x;
  const TileMap at{((bx >> mid) << (first + sites)) | ((bx & ((1LL << mid) - 1)) << contig), first, contig};

  // the tile by cp.async: psi (bond 1) at the first pass, else the bond
  // vector at the cut; psi's tile beside it where there are one-site terms
  const float2* pz = psi + z * spsi;
  const int rows_in = first_pass ? 1 : DW;
  const float2* src = first_pass ? pz : bond + static_cast<long long>(z) * DW * n;
  for (int e = threadIdx.x; e < rows_in * size; e += kThreads) {
    const int t = e & (size - 1);
    cp_async8(tile + (e >> bits) * stride + pos(t), src + (e >> bits) * n + at(t));
  }
  if (local != nullptr)
    for (int t = threadIdx.x; t < size; t += kThreads) cp_async8(sps + t, pz + at(t));
  cp_async_commit();
  const int wcount = sites * 4 * DW * DW;
  const float2* wpass = w + static_cast<long long>(first) * 4 * DW * DW;
  for (int e = threadIdx.x; e < wcount; e += kThreads) sw[e] = wpass[e];
  if (local != nullptr) {
    for (int e = threadIdx.x; e < 4 * sites; e += kThreads) sloc[e] = local[4 * first + e];
    if (threadIdx.x == 0) sany_off = 0;
    __syncthreads();
    if (threadIdx.x < sites) {
      const float2 a = sloc[4 * threadIdx.x + 1], b = sloc[4 * threadIdx.x + 2];
      soff[threadIdx.x] = (a.x != 0.f || a.y != 0.f || b.x != 0.f || b.y != 0.f) ? 1 : 0;
      if (soff[threadIdx.x]) sany_off = 1;
    }
    if (threadIdx.x < 16 * ((sites + 3) / 4)) {
      const int g = threadIdx.x / 16, v = threadIdx.x % 16;
      float2 d = make_float2(0.f, 0.f);
      for (int k = 4 * g; k < 4 * g + 4 && k < sites; ++k) {
        const float2 dv = sloc[4 * k + 3 * ((v >> (k - 4 * g)) & 1)];  // local[k][b][b]
        d.x += dv.x;
        d.y += dv.y;
      }
      sdiag[threadIdx.x] = d;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  constexpr int R = round_sites(DW);
  int s = 0;
  for (; s + R <= sites; s += R) {
    apply_round<DW, R>(tile, size, stride, sw + s * 4 * DW * DW, s + contig, first + s, length);
    __syncthreads();
  }
  if constexpr (R > 1) {
    if (s < sites) {
      apply_round<DW, 1>(tile, size, stride, sw + s * 4 * DW * DW, s + contig, first + s, length);
      __syncthreads();
    }
  }

  float2* oz = out + z * n;
  float2* dst = bond + static_cast<long long>(z) * DW * n;
  const bool partial = local != nullptr && !first_pass;  // out holds the earlier passes' one-site terms
  for (int t0 = threadIdx.x; t0 < size; t0 += kThreads * kOutUnroll) {
    float2 acc[kOutUnroll];
#pragma unroll
    for (int u = 0; u < kOutUnroll; ++u) {  // the partials' loads in flight together
      const int t = t0 + u * kThreads;
      acc[u] = partial && t < size ? oz[at(t)] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kOutUnroll; ++u) {
      const int t = t0 + u * kThreads;
      if (t >= size) break;
      const long long idx = at(t);
      if (local != nullptr) {
        float2 diag = make_float2(0.f, 0.f);
        for (int g = 0; g < (sites + 3) / 4; ++g) {
          const float2 dv = sdiag[16 * g + ((t >> (contig + 4 * g)) & 15)];
          diag.x += dv.x;
          diag.y += dv.y;
        }
        cfma(acc[u], diag, sps[t]);
        if (sany_off) {
          for (int k = 0; k < sites; ++k) {
            const int bit = k + contig;
            const int bs = (t >> bit) & 1;
            if (soff[k]) cfma(acc[u], sloc[4 * k + 2 * bs + (1 - bs)], sps[t ^ (1 << bit)]);  // local[k][bs][1 - bs]
          }
        }
      }
      if (last_pass) {
        const float2 c0 = tile[pos(t)];
        oz[idx] = make_float2(acc[u].x + c0.x, acc[u].y + c0.y);
      } else {
#pragma unroll
        for (int r = 0; r < DW; ++r) dst[r * n + idx] = tile[r * stride + pos(t)];
        if (local != nullptr) oz[idx] = acc[u];
      }
    }
  }
}

// Shared memory of one pass's block, in bytes.
size_t pass_smem(int dw, int sites, int contig, bool local) {
  const int size = 1 << (sites + contig);
  return sizeof(float2) * (static_cast<size_t>(dw) * row_stride(size) + (local ? size : 0) +
                           static_cast<size_t>(sites) * 4 * dw * dw);
}

template <int DW>
int launch_passes(const float2* w, const float2* psi, long long spsi, const float2* local, float2* out,
                  float2* scratch, int batch, int length, int npass, const int* plan, cudaStream_t stream) {
  size_t smem = 0;
  for (int p = 0; p < npass; ++p) {
    const size_t bytes = pass_smem(DW, plan[3 * p + 1], plan[3 * p + 2], local != nullptr);
    smem = bytes > smem ? bytes : smem;
  }
  cudaError_t err = prepare(sv_mpo_pass_kernel<DW>, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next launch's check
    return static_cast<int>(err);
  }
  for (int p = 0; p < npass; ++p) {
    const int first = plan[3 * p], sites = plan[3 * p + 1], contig = plan[3 * p + 2];
    const dim3 grid(static_cast<unsigned>(1LL << (length - sites - contig)), batch);
    sv_mpo_pass_kernel<DW><<<grid, kThreads, pass_smem(DW, sites, contig, local != nullptr), stream>>>(
        psi, spsi, scratch, w, local, out, length, first, sites, contig);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// w (L, 2, 2, dw, dw) contiguous; psi (batch, 2^L) with batch stride spsi
// (elements) and unit inner stride; local (L, 2, 2) or null; out (batch,
// 2^L) contiguous; scratch (batch, dw, 2^L) when npass > 1.  plan: npass
// triples (first site, sites, contiguous low bits) on the host, the passes in
// order, covering sites 0 .. L - 1; the first starts at site 0 with no
// contiguous bits, each later one at a site >= its contiguous bits.
extern "C" int sv_mpo_matvec_launch(const void* w, const void* psi, long long spsi, const void* local, void* out,
                                    void* scratch, int batch, int length, int dw, int npass, const int* plan,
                                    void* stream) {
  if (batch <= 0 || batch > 65535 || length <= 0 || length > kMaxSites || dw <= 0 || dw > kMaxDw || npass <= 0 ||
      plan == nullptr || (npass > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int next = 0;
  for (int p = 0; p < npass; ++p) {
    const int first = plan[3 * p], sites = plan[3 * p + 1], contig = plan[3 * p + 2];
    const bool ok = first == next && sites >= 1 && contig >= 0 && (p > 0 || contig == 0) && contig <= first &&
                    first + sites <= length &&
                    pass_smem(dw, sites, contig, local != nullptr) + kStaticSmem <= kSmemLimit;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    next = first + sites;
  }
  if (next != length) return static_cast<int>(cudaErrorInvalidValue);
  const auto ww = static_cast<const float2*>(w);
  const auto pp = static_cast<const float2*>(psi);
  const auto lc = static_cast<const float2*>(local);
  const auto oo = static_cast<float2*>(out);
  const auto sc = static_cast<float2*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dw) {
    case 1: return launch_passes<1>(ww, pp, spsi, lc, oo, sc, batch, length, npass, plan, s);
    case 2: return launch_passes<2>(ww, pp, spsi, lc, oo, sc, batch, length, npass, plan, s);
    case 3: return launch_passes<3>(ww, pp, spsi, lc, oo, sc, batch, length, npass, plan, s);
    case 4: return launch_passes<4>(ww, pp, spsi, lc, oo, sc, batch, length, npass, plan, s);
    case 5: return launch_passes<5>(ww, pp, spsi, lc, oo, sc, batch, length, npass, plan, s);
    case 6: return launch_passes<6>(ww, pp, spsi, lc, oo, sc, batch, length, npass, plan, s);
    case 7: return launch_passes<7>(ww, pp, spsi, lc, oo, sc, batch, length, npass, plan, s);
    default: return launch_passes<8>(ww, pp, spsi, lc, oo, sc, batch, length, npass, plan, s);
  }
}
