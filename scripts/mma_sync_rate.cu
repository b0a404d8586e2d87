// The rate of the legacy warp-level tensor-core instruction (mma.sync) and
// of plain FP32 FMAs on one card: the ceiling under the 3xTF32 products of
// the Newton–Schulz polar factor (yaqs_tpu_torch/kernels/csrc/ns_polar.cuh).
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_rate scripts/mma_sync_rate.cu
//     ./mma_sync_rate
//
// Each warp issues CHAINS independent mmas a loop iteration on operands held
// in registers (the same registers every time, so the register file and
// shared memory never limit it), 256 threads a block, one to four blocks an
// SM; one warp with one chain gives the latency of one mma. Prints FLOP/s
// counted as 2 M N K a mma (4 x 2 a lane for the FFMA line).

#include <cstdio>

#include <cuda_runtime.h>

namespace {

enum Kind { kTf32k8, kTf32k4, kBf16, kF16, kFfma };

template <Kind KIND, int CHAINS>
__global__ void bench(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if constexpr (KIND == kTf32k8) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
            "{%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else if constexpr (KIND == kTf32k4) {
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(b[0]));
      } else if constexpr (KIND == kBf16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
            "{%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else if constexpr (KIND == kF16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
            "{%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) c[j][q] = fmaf(__uint_as_float(a[q]), __uint_as_float(b[q & 1]), c[j][q]);
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j)
    for (int q = 0; q < 4; ++q) s += c[j][q];
  if (s == 12345.f) out[0] = s;  // keeps the chains live
}

template <Kind KIND, int CHAINS>
void run(const char* name, double flop_per_op, int blocks, int threads) {
  float* out;
  cudaMalloc(&out, sizeof(float));
  const int iters = 4096;
  bench<KIND, CHAINS><<<blocks, threads>>>(out, 16);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<KIND, CHAINS><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double ops = static_cast<double>(blocks) * (threads / 32) * iters * CHAINS;
  printf("%-16s chains %d, %4d blocks of %d threads: %.1f TFLOP/s, %.2f ns an op a warp (%s)\n", name, CHAINS,
         blocks, threads, ops * flop_per_op / ms / 1e9, ms * 1e6 / (static_cast<double>(iters) * CHAINS),
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  printf("%s, %d SMs\n", prop.name, sms);
  const double k8 = 2.0 * 16 * 8 * 8, k4 = 2.0 * 16 * 8 * 4, k16 = 2.0 * 16 * 8 * 16, ffma = 2.0 * 32 * 4;
  run<kTf32k8, 1>("tf32 m16n8k8", k8, 1, 32);  // latency
  run<kTf32k8, 8>("tf32 m16n8k8", k8, sms, 256);
  run<kTf32k8, 8>("tf32 m16n8k8", k8, 2 * sms, 256);
  run<kTf32k8, 8>("tf32 m16n8k8", k8, 4 * sms, 256);
  run<kTf32k4, 8>("tf32 m16n8k4", k4, 4 * sms, 256);
  run<kBf16, 8>("bf16 m16n8k16", k16, 4 * sms, 256);
  run<kF16, 8>("f16 m16n8k16", k16, 4 * sms, 256);
  run<kFfma, 8>("fp32 ffma", ffma, 4 * sms, 256);
  return 0;
}
