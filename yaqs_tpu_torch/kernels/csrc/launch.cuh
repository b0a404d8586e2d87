// Launch helpers shared by the kernels that size their shared memory and
// their thread block clusters at run time, and the asynchronous copies from
// device to shared memory (cp.async) that several of them stage through.

#pragma once

#include <cuda_runtime.h>

namespace {

// Dynamic shared memory one block may hold on sm_90.
constexpr size_t kSmemLimit = 227 * 1024;

// Set the dynamic shared-memory limit of a kernel and report the error.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// allow_smem, and the largest carveout, so that the blocks an SM are bounded
// by what they need, not by the default split between L1 and shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// A launch of `units` clusters of `cluster` blocks along x (a plain launch
// of `units` blocks at cluster = 1).  attr holds the cluster attribute and
// must outlive the launch or the occupancy query that takes the config.
inline cudaLaunchConfig_t cluster_config(int units, int cluster, int threads, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(units * cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  return config;
}

// 8 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// The same, or zeros when !valid (no device read: the address given is then
// `base`).
__device__ __forceinline__ void cp_async8(float2* dst, const float2* base, long long offset, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const float2* src = valid ? base + offset : base;
  const int bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

// 4 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// 16 bytes (both addresses 16-byte aligned), or zeros when !valid; cached
// in L2 only.
__device__ __forceinline__ void cp_async16(float4* dst, const float4* base, long long offset, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const float4* src = valid ? base + offset : base;
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace
