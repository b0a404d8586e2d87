// Kernel K17 (op_scan): operator transfer scans of MPS chains, one launch
// for every (trajectory, row) chain,
//   E_0 = I (chi x chi);  E_(i+1) = sum_s A_i[s]^H E_i K_i[s];  value = tr E_L
// with K_i = O_i A_i the site's ket with the row's operator applied on its
// physical leg: a general d x d operator (a product term's factor, or the
// identity), or a projector |b><b|, whose ket is the one slice A_i[b] (then
// E_(i+1) = A_i[b]^H E_i A_i[b], and only that slice is read).
//
// Replaces: yaqs_tpu/core/observables.py _pvm_values (:229-247, a projector
// at every site: |<b|psi>|^2) and _term_values (:207-226, one operator a
// site: the multi-site product terms), each a scan of einsums over the
// sites (a Python loop of three einsums a site in the plain version).
//
// What bounds it on the card: FP32 operations.  A general site is 2 d chi^3
// complex MACs (the d products E A[t], then the d products A[s]^H T_s) plus
// d^2 chi^2 for the operator; a projector site 2 chi^3.  The sites are read
// once a chain, chi^2 d complex64 each (chi^2 for a projector).
//
// Design: one block of 256 threads a chain; the chain's environment lives
// in shared memory (stored transposed, so that both products read rows),
// as K7's scans carry theirs.  The sites stream through a two-stage ring
// by cp.async, the next site's slices in flight while this one is used.  A
// thread owns a TT x TT tile (TT = CW / 16) of each CW x CW product, CW the
// padded width 16, 32 or 64 (zeros past chi):
//  (A) U_t = E A_i[t] for every t at once (E's column and each slice's row
//      read as 16-byte pairs), then T_s = sum_t O[s, t] U_t in registers
//      (the operator applied to the ket on load into the products), stored;
//  (B) E' = sum_s A_i[s]^H T_s, accumulated in registers, stored.
// At CW = 64 and d = 2 the block holds E, two stages of a site and the d
// products T: 224 KB.  d = 2, chi <= 64.
//
// With a bra (op_scan_bra): the mixed scans E_(i+1) = sum_s B_i[s]^H E_i
// K_i[s] of <bra| O |ket>, replacing yaqs_tpu/analog/ensemble.py
// mixed_site_expectation and mixed_terms_expectation (:26-72), the two-time
// correlators: every (member, pair, term) chain in one launch, chain t of
// trajectory z reading ket ket_of[t] of z and the bra of z.  Both site
// streams are read once a chain (2 d chi^3 + d^2 chi^2 complex MACs a site
// as above).  The ring's two stages hold the site's ket and its bra: the
// next ket lands while (B) reads the bra, the next bra while (A) reads the
// ket, so the block's shared memory is the one-stream kernel's.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kD = 2;
constexpr int kMaxChi = 64;

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// acc += conj(a) b
__device__ __forceinline__ void cfma_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(-a.y, b.x, acc.y);
}

template <int CW>
struct Layout {
  static constexpr int kTile = CW * CW;  // float2 of one CW x CW matrix
  // E (transposed), two stages of d slices, d products T
  static constexpr size_t bytes() { return sizeof(float2) * kTile * (1 + 2 * kD + kD); }
};

// Loads the slices of site i that the chain reads into `stage` (slice s at
// stage + s CW^2; a projector's one slice at slot 0), asynchronously.
template <int CW>
__device__ __forceinline__ void load_site(float2* stage, const float2* site, int sel, int chi) {
  const int cc = chi * chi;
  const int first = sel >= 0 ? sel : 0;
  const int count = sel >= 0 ? 1 : kD;
  for (int e = threadIdx.x; e < count * cc; e += kThreads) {
    const int s = e / cc, rem = e % cc, row = rem / chi, col = rem % chi;
    cp_async8(stage + s * CW * CW + row * CW + col, site + static_cast<long long>(first + s) * cc + rem);
  }
  cp_async_commit();
}

// tensors: trajectory z's site i at z sz + i ss (elements), each (d, chi,
// chi) contiguous; sel (nc, L): -1 for the operator ops[t, i] (d x d), b >= 0
// for the projector onto b; out (batch, nc) complex.
// With kBra: ket ket_of[t] of trajectory z at z sz + ket_of[t] sp, the bra
// of z at z bz, its sites bs apart.
template <int CW, bool kBra>
__global__ void __launch_bounds__(kThreads, 1)
    op_scan_kernel(const float2* tensors, long long sz, long long ss, long long sp, const int* ket_of,
                   const float2* bra, long long bz, long long bs, const int* sel, const float2* ops, float2* out,
                   int nc, int length, int chi) {
  constexpr int TT = CW / 16;
  constexpr int kTile = CW * CW;
  const long long z = blockIdx.x / nc;
  const int t = blockIdx.x % nc;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float4 smem_raw[];
  float2* et = reinterpret_cast<float2*>(smem_raw);  // et[r * CW + l] = E[l, r]
  float2* stages = et + kTile;                        // two stages of kD slices
  float2* prod = stages + 2 * kD * kTile;             // T_s

  for (int e = threadIdx.x; e < kTile * (1 + 3 * kD); e += kThreads) et[e] = make_float2(0.f, 0.f);
  __syncthreads();
  for (int a = threadIdx.x; a < chi; a += kThreads) et[a * CW + a] = make_float2(1.f, 0.f);

  const float2* chain = tensors + z * sz + (kBra ? __ldg(ket_of + t) * sp : 0);
  const float2* bra_z = kBra ? bra + z * bz : nullptr;
  const int* sel_t = sel + static_cast<long long>(t) * length;
  const float2* ops_t = ops + static_cast<long long>(t) * length * kD * kD;
  float2* ket_stage = stages;             // with kBra: the site's ket ...
  float2* bra_stage = stages + kD * kTile;  // ... and its bra
  load_site<CW>(stages, chain, __ldg(sel_t), chi);
  if (kBra) load_site<CW>(bra_stage, bra_z, __ldg(sel_t), chi);

  for (int i = 0; i < length; ++i) {
    const int b = __ldg(sel_t + i);
    float2* cur = kBra ? ket_stage : stages + (i & 1) * kD * kTile;
    if (kBra) {
      cp_async_wait<1>();  // the ket has landed; the bra may be in flight
    } else if (i + 1 < length) {
      load_site<CW>(stages + ((i + 1) & 1) * kD * kTile, chain + (i + 1) * ss, __ldg(sel_t + i + 1), chi);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // (A) U_t = E A[t], T_s = sum_t O[s, t] U_t (a projector: T = E A[b])
    const int nt = b >= 0 ? 1 : kD;
    float2 u[kD][TT][TT];
#pragma unroll
    for (int q = 0; q < kD; ++q)
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int c = 0; c < TT; ++c) u[q][r][c] = make_float2(0.f, 0.f);
    for (int m = 0; m < CW; ++m) {
      float2 ev[TT];
#pragma unroll
      for (int r = 0; r < TT; ++r) ev[r] = et[m * CW + ty * TT + r];  // E[l, m], l = ty TT + r
#pragma unroll
      for (int q = 0; q < kD; ++q) {
        if (q < nt) {
          float2 av[TT];
#pragma unroll
          for (int c = 0; c < TT; ++c) av[c] = cur[q * kTile + m * CW + tx * TT + c];  // A[q][m, r]
#pragma unroll
          for (int r = 0; r < TT; ++r)
#pragma unroll
            for (int c = 0; c < TT; ++c) cfma(u[q][r][c], ev[r], av[c]);
        }
      }
    }
    if (b >= 0) {
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int c = 0; c < TT; ++c) prod[(ty * TT + r) * CW + tx * TT + c] = u[0][r][c];
    } else {
      float2 o[kD][kD];
#pragma unroll
      for (int s = 0; s < kD; ++s)
#pragma unroll
        for (int q = 0; q < kD; ++q) o[s][q] = __ldg(ops_t + (static_cast<long long>(i) * kD + s) * kD + q);
#pragma unroll
      for (int s = 0; s < kD; ++s)
#pragma unroll
        for (int r = 0; r < TT; ++r)
#pragma unroll
          for (int c = 0; c < TT; ++c) {
            float2 v = make_float2(0.f, 0.f);
#pragma unroll
            for (int q = 0; q < kD; ++q) cfma(v, o[s][q], u[q][r][c]);
            prod[s * kTile + (ty * TT + r) * CW + tx * TT + c] = v;
          }
    }
    __syncthreads();
    const float2* bra_cur = cur;
    if (kBra) {  // the ket's stage is free: the next ket lands while the bra is read
      if (i + 1 < length) {
        load_site<CW>(ket_stage, chain + (i + 1) * ss, __ldg(sel_t + i + 1), chi);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      bra_cur = bra_stage;
    }

    // (B) E'[bb, r] = sum_s sum_l conj(A[s][l, bb]) T_s[l, r], bb = ty TT + rr, r = tx TT + c
    float2 acc[TT][TT];
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
      for (int c = 0; c < TT; ++c) acc[r][c] = make_float2(0.f, 0.f);
    for (int s = 0; s < nt; ++s) {
      const float2* as = bra_cur + s * kTile;
      const float2* ts = prod + s * kTile;
      for (int l = 0; l < CW; ++l) {
        float2 av[TT], tv[TT];
#pragma unroll
        for (int r = 0; r < TT; ++r) av[r] = as[l * CW + ty * TT + r];
#pragma unroll
        for (int c = 0; c < TT; ++c) tv[c] = ts[l * CW + tx * TT + c];
#pragma unroll
        for (int r = 0; r < TT; ++r)
#pragma unroll
          for (int c = 0; c < TT; ++c) cfma_conj(acc[r][c], av[r], tv[c]);
      }
    }
    // E is read only in (A), which every thread has left
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
      for (int c = 0; c < TT; ++c) et[(tx * TT + c) * CW + ty * TT + r] = acc[r][c];
    __syncthreads();  // the stage read here is the next site's prefetch target
    if (kBra && i + 1 < length) load_site<CW>(bra_stage, bra_z + (i + 1) * bs, __ldg(sel_t + i + 1), chi);
  }

  // tr E, by warp 0 over the diagonal
  if (threadIdx.x < 32) {
    float2 tr = make_float2(0.f, 0.f);
    for (int a = threadIdx.x; a < chi; a += 32) {
      const float2 v = et[a * CW + a];
      tr.x += v.x;
      tr.y += v.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tr.x += __shfl_xor_sync(0xffffffffu, tr.x, off);
      tr.y += __shfl_xor_sync(0xffffffffu, tr.y, off);
    }
    if (threadIdx.x == 0) out[z * nc + t] = tr;
  }
}

template <int CW, bool kBra>
int run(const float2* tensors, long long sz, long long ss, long long sp, const int* ket_of, const float2* bra,
        long long bz, long long bs, const int* sel, const float2* ops, float2* out, int batch, int nc, int length,
        int chi, cudaStream_t stream) {
  auto kernel = op_scan_kernel<CW, kBra>;
  static const cudaError_t configured = allow_smem(kernel, Layout<CW>::bytes());
  if (configured != cudaSuccess) return static_cast<int>(configured);
  kernel<<<static_cast<unsigned>(static_cast<long long>(batch) * nc), kThreads, Layout<CW>::bytes(), stream>>>(
      tensors, sz, ss, sp, ket_of, bra, bz, bs, sel, ops, out, nc, length, chi);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBra>
int dispatch(const void* tensors, long long sz, long long ss, long long sp, const void* ket_of, const void* bra,
             long long bz, long long bs, const void* sel, const void* ops, void* out, int batch, int nc, int length,
             int d, int chi, void* stream) {
  if (batch <= 0 || nc <= 0 || length <= 0 || d != kD || chi <= 0 || chi > kMaxChi ||
      static_cast<long long>(batch) * nc > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const float2*>(tensors);
  const auto* k = static_cast<const int*>(ket_of);
  const auto* br = static_cast<const float2*>(bra);
  const auto* s = static_cast<const int*>(sel);
  const auto* o = static_cast<const float2*>(ops);
  auto* res = static_cast<float2*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (chi <= 16) return run<16, kBra>(t, sz, ss, sp, k, br, bz, bs, s, o, res, batch, nc, length, chi, st);
  if (chi <= 32) return run<32, kBra>(t, sz, ss, sp, k, br, bz, bs, s, o, res, batch, nc, length, chi, st);
  return run<64, kBra>(t, sz, ss, sp, k, br, bz, bs, s, o, res, batch, nc, length, chi, st);
}

}  // namespace

// tensors (batch, L, d, chi, chi) complex64, each site contiguous, sz / ss
// elements between trajectories / sites; sel (nc, L) int32; ops (nc, L, d,
// d) complex64 (read only where sel is -1); out (batch, nc) complex64.
extern "C" int op_scan_launch(const void* tensors, long long sz, long long ss, const void* sel, const void* ops,
                              void* out, int batch, int nc, int length, int d, int chi, void* stream) {
  return dispatch<false>(tensors, sz, ss, 0, nullptr, nullptr, 0, 0, sel, ops, out, batch, nc, length, d, chi, stream);
}

// kets (batch, npk, L, d, chi, chi) complex64, each site contiguous, sz / sp /
// ss elements between trajectories / kets / sites; ket_of (nc) int32 in [0,
// npk); bra (batch, L, d, chi, chi), bz / bs elements between trajectories /
// sites; sel, ops and out as op_scan_launch's.
extern "C" int op_scan_bra_launch(const void* kets, long long sz, long long sp, long long ss, const void* ket_of,
                                  int npk, const void* bra, long long bz, long long bs, const void* sel,
                                  const void* ops, void* out, int batch, int nc, int length, int d, int chi,
                                  void* stream) {
  if (npk <= 0 || ket_of == nullptr || bra == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(kets, sz, ss, sp, ket_of, bra, bz, bs, sel, ops, out, batch, nc, length, d, chi, stream);
}
