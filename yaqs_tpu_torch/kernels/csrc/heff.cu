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
// TDVP sweep (XLA chains K1 and K2): at L = 100, k = 4 the analog sweep runs
// 788 two-site and 784 one-site matvecs.
//
// What bounds it on the card: operations.  At chi = 64, Dw = 3 the two-site
// product is 6.88 M complex MACs per trajectory (2 P Dw chi^3 + (P Dw)^2
// chi^2) against 2 (P + Dw) chi^2 complex values moved; at B = 32 that is
// 1.76 GFLOP, 26 us at 67 TFLOP/s fp32.  Eager PyTorch writes X and Y
// (chi^2 P Dw complex values each, 655 KB per trajectory at Dw = 5) to
// device memory and adds a permute copy between the products.
//
// Design: grid (tiles of TA rows a, B), 256 threads.  A block stages its TA
// rows of f and all of W in shared memory.  (1) Each thread owns a column
// (c, q) of v, streams it once from device memory (coalesced over q) and
// keeps the TA * Dw sums of X in registers; X lands in shared memory.
// (2) Y = X W in shared memory.  (3) g streams through shared memory in
// chunks of q, each thread owning one column b of eight output rows (a, x).
// X and Y never leave the SM, and the output is written in its final
// (x, a, b) layout, so no permute copy follows.  d = 2, chi <= 64, Dw <= 6.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChi = 64;
constexpr int kMaxDw = 6;
constexpr int kRowGroup = 8;  // output rows (a, x) per thread in phase 3

__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}

// rows of a per block: TA * DW sums of phase 1 stay within 24 registers pairs
template <int DW>
__host__ __device__ constexpr int tile_rows() {
  return DW <= 3 ? 8 : 4;
}

template <int P, int DW>
__device__ __forceinline__ void heff_body(const float2* __restrict__ f, long long sf, const float2* __restrict__ v,
                                          long long sv, const float2* __restrict__ w, const float2* __restrict__ g,
                                          long long sg, float2* __restrict__ out, int chi) {
  constexpr int TA = tile_rows<DW>();
  constexpr int R = DW * P;   // rows of W
  constexpr int NR = TA * P;  // output rows (a, x) of a block
  extern __shared__ float2 smem[];
  float2* fs = smem;                 // (TA, DW, chi)
  float2* ws = fs + TA * DW * chi;   // (R, R)
  float2* xs = ws + R * R;           // (TA, R, chi); phase 3: g chunk (DW, NR, chi)
  float2* ys = xs + TA * R * chi;    // (TA, P * DW, chi)

  const int tid = threadIdx.x;
  const int a0 = blockIdx.x * TA;
  const long long z = blockIdx.y;
  const float2* fz = f + z * sf;
  const float2* vz = v + z * sv;
  const float2* gz = g + z * sg;
  const int cc = chi * chi;

  for (int e = tid; e < TA * DW * chi; e += kThreads) {
    const int ta = e / (DW * chi);
    fs[e] = a0 + ta < chi ? fz[static_cast<size_t>(a0) * DW * chi + e] : make_float2(0.f, 0.f);
  }
  for (int e = tid; e < R * R; e += kThreads) ws[e] = w[e];
  __syncthreads();

  // (1) X[ta, (w, c), q] = sum_p f[a0 + ta, w, p] v[c, p, q]
  for (int col = tid; col < P * chi; col += kThreads) {
    const int c = col / chi, q = col % chi;
    float2 acc[TA * DW];
#pragma unroll
    for (int r = 0; r < TA * DW; ++r) acc[r] = make_float2(0.f, 0.f);
    const float2* vc = vz + static_cast<size_t>(c) * cc + q;
    for (int p = 0; p < chi; ++p) {
      const float2 vv = vc[static_cast<size_t>(p) * chi];
#pragma unroll
      for (int r = 0; r < TA * DW; ++r) cfma(acc[r], fs[r * chi + p], vv);
    }
#pragma unroll
    for (int r = 0; r < TA * DW; ++r) {
      const int ta = r / DW, wl = r % DW;
      xs[(ta * R + wl * P + c) * chi + q] = acc[r];
    }
  }
  __syncthreads();

  // (2) Y[ta, (x, u), q] = sum_(w, c) X[ta, (w, c), q] W[(w, c), (x, u)]
  for (int e = tid; e < TA * R * chi; e += kThreads) {
    const int q = e % chi;
    const int col = (e / chi) % R;
    const int ta = e / (chi * R);
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) cfma(acc, xs[(ta * R + r) * chi + q], ws[r * R + col]);
    ys[e] = acc;
  }
  __syncthreads();

  // (3) out[x, a0 + ta, b] = sum_(q, u) Y[ta, (x, u), q] g[b, u, q], g in chunks of NR columns q
  constexpr int kGroups = NR / kRowGroup;
  const bool owns = tid < chi * kGroups;
  const int b = tid % chi;
  const int grp = tid / chi;
  float2 acc[kRowGroup];
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) acc[r] = make_float2(0.f, 0.f);
  float2* gs = xs;  // (DW, NR, chi): gs[(u * NR + qc) * chi + b] = g[b, u, q0 + qc]
  for (int q0 = 0; q0 < chi; q0 += NR) {
    const int qn = min(NR, chi - q0);
    for (int e = tid; e < chi * DW * qn; e += kThreads) {
      const int qc = e % qn;
      const int u = (e / qn) % DW;
      const int bb = e / (qn * DW);
      gs[(u * NR + qc) * chi + bb] = gz[(static_cast<size_t>(bb) * DW + u) * chi + q0 + qc];
    }
    __syncthreads();
    if (owns) {
      for (int u = 0; u < DW; ++u) {
        for (int qc = 0; qc < qn; ++qc) {
          const float2 gv = gs[(u * NR + qc) * chi + b];
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r) {
            const int row = grp * kRowGroup + r;
            const int ta = row / P, x = row % P;
            cfma(acc[r], ys[(ta * R + x * DW + u) * chi + q0 + qc], gv);
          }
        }
      }
    }
    __syncthreads();
  }
  if (owns) {
    float2* oz = out + z * static_cast<long long>(P) * cc;
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      const int row = grp * kRowGroup + r;
      const int ta = row / P, x = row % P;
      if (a0 + ta < chi) oz[static_cast<size_t>(x) * cc + static_cast<size_t>(a0 + ta) * chi + b] = acc[r];
    }
  }
}

template <int DW>
__global__ void __launch_bounds__(kThreads)
heff2_kernel(const float2* f, long long sf, const float2* v, long long sv, const float2* w, const float2* g,
             long long sg, float2* out, int chi) {
  heff_body<4, DW>(f, sf, v, sv, w, g, sg, out, chi);
}

template <int DW>
__global__ void __launch_bounds__(kThreads)
heff1_kernel(const float2* f, long long sf, const float2* v, long long sv, const float2* w, const float2* g,
             long long sg, float2* out, int chi) {
  heff_body<2, DW>(f, sf, v, sv, w, g, sg, out, chi);
}

template <int P, int DW>
int launch(const void* f, long long sf, const void* v, long long sv, const void* w, const void* g, long long sg,
           void* out, int batch, int chi, cudaStream_t stream) {
  constexpr int TA = tile_rows<DW>();
  constexpr int R = DW * P;
  auto smem_for = [](int c) {
    return sizeof(float2) * (static_cast<size_t>(TA) * DW * c + R * R + 2 * static_cast<size_t>(TA) * R * c);
  };
  auto kernel = P == 4 ? heff2_kernel<DW> : heff1_kernel<DW>;
  // once per instantiation: the opt-in limit for the largest chi it takes
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_for(kMaxChi)));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const size_t smem = smem_for(chi);
  const dim3 grid((chi + TA - 1) / TA, batch);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float2*>(f), sf, static_cast<const float2*>(v), sv,
                                           static_cast<const float2*>(w), static_cast<const float2*>(g), sg,
                                           static_cast<float2*>(out), chi);
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
