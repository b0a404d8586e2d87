// Kernel K15: the jump weights of the adjacent non-Pauli two-site channels,
// one thread block per (channel, trajectory).
//
// Replaces: yaqs_tpu/methods/stochastic.py channel_weights2 (:65-84, the XLA
// chain K15): on the analog path once per jump step with two-site noise, on
// the digital path once per half-layer and gate stage.
//
// What it computes, for tensors (B, L, 2, chi, chi), the left and right Gram
// environments E, R (B, L, chi, chi) of moment_scan.cu (E_i before site i,
// R_i after it), and channel k on bond b = bonds[k] with weight operator
// W_k (4, 4) and coefficient c_k = dt * gamma_k, exactly as the JAX function:
//   theta[(s1 s2), l, r] = sum_m A_b[s1, l, m] A_(b+1)[s2, m, r]
//   Y[q, l, r] = sum_(m, t) E_b[l, m] theta[q, m, t] R_(b+1)[r, t]
//   out[z, k] = c_k * Re sum_(p, q, l, r) conj(theta[p, l, r]) W_k[p, q] Y[q, l, r]
//
// What bounds it on the card: arithmetic.  A block does 12 chi^3 complex
// MACs (the merge and the two environment products for each of the four
// merged physical indices): 3.1 M at chi = 64, so 10 GMAC over 99 channels
// and 32 trajectories, against reading two sites and two environments
// (128 KB) a block.  Eager PyTorch runs it as a gather and five batched
// products with (B, nc2, 4, chi, chi) intermediates in device memory.
//
// Design: theta (4 chi^2) and one environment product E theta_q (chi^2) stay
// in shared memory (160 KB at chi = 64); the second product's epilogue folds
// in the weight operator and the conjugated theta, so Y is never stored, and
// each thread keeps its share of the sum in a register until one block
// reduction at the end.  The sites and environments are read from device
// memory where the products need them.

#include "ns_polar.cuh"

namespace {

__global__ void __launch_bounds__(kNsThreads)
pair_weights_kernel(const float2* __restrict__ t, const float2* __restrict__ left_envs,
                    const float2* __restrict__ right_envs, const long long* __restrict__ bonds,
                    const float2* __restrict__ wop, const float* __restrict__ coeff, float* __restrict__ out, int L,
                    int chi, int nc2) {
  extern __shared__ float2 smem[];
  __shared__ float2 sw[16];
  __shared__ float partial[kNsThreads / 32];
  const int cc = chi * chi;
  float2* th = smem;         // (4, chi, chi)
  float2* sxe = th + 4 * cc;  // (chi, chi): E theta_q
  const int k = blockIdx.x;
  const int z = blockIdx.y;
  const int bond = static_cast<int>(bonds[k]);
  const float2* a = t + (static_cast<size_t>(z) * L + bond) * 2 * cc;
  const float2* b = a + 2 * cc;
  const float2* e = left_envs + (static_cast<size_t>(z) * L + bond) * cc;
  const float2* r = right_envs + (static_cast<size_t>(z) * L + bond + 1) * cc;
  if (threadIdx.x < 16) sw[threadIdx.x] = wop[k * 16 + threadIdx.x];
  for (int p = 0; p < 4; ++p) {
    smem_matmul<false>(a + (p / 2) * cc, chi, b + (p % 2) * cc, chi, chi, chi, chi,
                       [&](int i, int j, float2 v) { th[p * cc + i * chi + j] = v; });
  }
  __syncthreads();
  float acc = 0.f;
  for (int q = 0; q < 4; ++q) {
    smem_matmul<false>(e, chi, th + q * cc, chi, chi, chi, chi, [&](int i, int j, float2 v) { sxe[i * chi + j] = v; });
    __syncthreads();
    tile_matmul(
        chi, chi, chi, [&](int i, int s) { return sxe[i * chi + s]; }, [&](int s, int j) { return r[j * chi + s]; },
        [&](int i, int j, float2 v) {
          float2 w = make_float2(0.f, 0.f);
#pragma unroll
          for (int p = 0; p < 4; ++p) cfma(w, sw[p * 4 + q], conj2(th[p * cc + i * chi + j]));
          acc = fmaf(w.x, v.x, fmaf(-w.y, v.y, acc));
        });
    __syncthreads();
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kNsThreads / 32; ++w) total += partial[w];
    out[static_cast<size_t>(z) * nc2 + k] = coeff[k] * total;
  }
}

}  // namespace

// t (batch, L, 2, chi, chi), left_envs and right_envs (batch, L, chi, chi),
// all contiguous; bonds (nc2,) int64 in [0, L - 2]; wop (nc2, 4, 4);
// coeff (nc2,) float; out (batch, nc2) float
extern "C" int pair_weights_launch(const void* t, const void* left_envs, const void* right_envs, const void* bonds,
                                   const void* wop, const void* coeff, void* out, int batch, int L, int chi, int nc2,
                                   void* stream) {
  if (batch <= 0 || batch > 65535 || nc2 <= 0 || L < 2 || chi <= 0 || chi > kNsMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float2) * 5 * static_cast<size_t>(chi) * chi;
  cudaError_t err = allow_smem(pair_weights_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_weights_kernel<<<dim3(nc2, batch), kNsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(t), static_cast<const float2*>(left_envs), static_cast<const float2*>(right_envs),
      static_cast<const long long*>(bonds), static_cast<const float2*>(wop), static_cast<const float*>(coeff),
      static_cast<float*>(out), L, chi, nc2);
  return static_cast<int>(cudaGetLastError());
}
