// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel takes float32 or bfloat16 operands and accumulates in
// float32 (no TF32): the contract of the reference's
// `preferred_element_type=jnp.float32`.  All but one convert to float32 on
// load and run float32 FMA; flash attention's bfloat16 route multiplies
// bfloat16 on the tensor cores, whose products are exact in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hasco {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Butterfly sum over a full warp; every lane ends with the same value, and
// the order of additions is fixed, so the result is deterministic.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over a block of THREADS threads (a multiple of 32) in a fixed order:
// each warp reduces by butterfly, then warp 0 reduces the per-warp sums.
// Returns the total in thread 0.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_part[lane] : 0.f;
    v = warp_sum(v);
  }
  return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled (nothing read) where !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

}  // namespace hasco
