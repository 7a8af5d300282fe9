// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every kernel takes float32 or bfloat16 operands and accumulates in
// float32 (no TF32): the contract of the reference's
// `preferred_element_type=jnp.float32`.  Most convert to float32 on load
// and run float32 FMA; the bfloat16 routes of flash attention, mamba2 and
// rwkv6 multiply bfloat16 on the tensor cores, whose products are exact in
// float32, and split a float32 operand into bfloat16 terms.
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

// The sum of v over the block, in a fixed order, in every thread.  part is
// 32 floats of shared memory; callers that sum more than once alternate two
// of them, so that one barrier a sum suffices (a thread writes part again
// only after every thread has passed the barrier of the sum before, and so
// read that one's).
__device__ __forceinline__ float block_total(float v, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += part[w];
  return total;
}

// Streaming multiprocessors of the current device, asked once a device.
inline int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev] > 0 ? cache[dev] : 132;
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

// ---- bfloat16 tensor cores (mma.sync m16n8k16), for flash attention, mamba2
// and rwkv6
//
// Fragment layouts of m16n8k16 (lane = 4g + t): A regs hold (row g | g+8,
// cols 2t,2t+1 | 2t+8,2t+9), B regs (k 2t,2t+1 | 2t+8,2t+9; col g), the
// accumulator (row g | g+8; cols 2t, 2t+1).

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bfloat16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

// acc += a b on the tensor cores in a fresh accumulator, then in float32:
// their accumulation is not rounded to nearest, and a long chain of it
// (a state carried over every chunk) drifts
__device__ __forceinline__ void mma_add(float (&acc)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, a, b0, b1);
  acc[0] += d[0], acc[1] += d[1], acc[2] += d[2], acc[3] += d[3];
}

// (v0, v1) as N bfloat16 terms, each the bfloat16 rounding of what the terms
// before it left (hi = bf16(v), lo = bf16(v - hi), ...): the terms summed keep
// ~8 N bits of each float32 value
template <int N>
__device__ __forceinline__ void split_bf16(float v0, float v1, unsigned (&terms)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 hf = __bfloat1622float2(h);
    terms[i] = as_u32(h);
    v0 -= hf.x;
    v1 -= hf.y;
  }
}

__host__ __device__ __forceinline__ long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

}  // namespace hasco
