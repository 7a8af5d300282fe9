// DOT intrinsic: sum_k a[k] * b[k] -> (1, 1) float32, whatever the input type.
//
// Replaces the Pallas TPU kernel `repro/kernels/dotprod.py::dot`.
//
// Bound on the H100: bytes.  Both operands are read once (128 MB at 2^24
// float32 pairs, 0.040 ms at 3.35 TB/s) for one FMA per pair, so the design
// keeps as many bytes in flight as the memory system takes and nothing else.
// The TPU kernel carries its sum across a sequential grid, one bk chunk a
// step; on Hopper the CTAs run in no order, so the sum is a deterministic
// two-pass reduction instead of float atomics.  The geometry follows the card,
// not the co-designed block (`kernels/dotprod.py::plan`):
//   pass 1: a few CTAs per SM, each over a contiguous span of whole warp-wide
//           16-byte vector rounds (no span empty; a small K takes one CTA).
//           Each thread keeps UNROLL independent 16-byte loads of each operand
//           in flight (4 float32 or 8 bfloat16 values a load, streaming
//           hint: read once, evict first) into UNROLL separate accumulators,
//           then the CTA sums its threads in a fixed order into one partial;
//   pass 2: one CTA sums the partials in a fixed order into the output (a
//           single CTA writes the output itself, and pass 2 is skipped).
// Any element offset is taken.  Where a and b share one offset mod 16 bytes
// a span runs a scalar head up to the first 16-byte boundary, the vectors,
// then a scalar tail; where their offsets differ it runs scalar loads over
// the same span, UNROLL in flight.  So the result's bits depend only on K, the
// dtype, the SM count (through the plan) and the operands' offsets mod 16
// bytes: never on bk, and the same on every run.
#include <cstdint>

#include "common.cuh"

namespace {

using hasco::to_f32;

constexpr int THREADS = 256, FINAL_THREADS = 1024, UNROLL = 4;

__device__ __forceinline__ float load1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

// one 16-byte vector of each operand: 4 float32 or 8 bfloat16 products
__device__ __forceinline__ float fma_vec(float4 x, float4 y, float s) {
  s = fmaf(x.x, y.x, s);
  s = fmaf(x.y, y.y, s);
  s = fmaf(x.z, y.z, s);
  return fmaf(x.w, y.w, s);
}
__device__ __forceinline__ float fma_vec(uint4 x, uint4 y, float s) {
  const unsigned xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    s = fmaf(xf.x, yf.x, s);
    s = fmaf(xf.y, yf.y, s);
  }
  return s;
}

template <typename T>
struct Vec;
template <>
struct Vec<float> { using type = float4; };
template <>
struct Vec<__nv_bfloat16> { using type = uint4; };

template <typename T>
__global__ void __launch_bounds__(THREADS)
dot_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ partial, long long K, long long span) {
  using V = typename Vec<T>::type;
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const long long lo = (long long)blockIdx.x * span;
  const long long hi = min(lo + span, K);
  const unsigned ma = (unsigned)((uintptr_t)(a + lo) % 16);
  const unsigned mb = (unsigned)((uintptr_t)(b + lo) % 16);
  float acc[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) acc[u] = 0.f;
  float s = 0.f;  // the scalar head and tail
  if (ma == mb) {
    const long long head = min(hi - lo, (long long)(((16u - ma) % 16u) / sizeof(T)));
    const long long start = lo + head;
    const long long nvec = (hi - start) / VEC;
    const long long tail = start + nvec * VEC;
    if (tid < head) s = fmaf(to_f32(a[lo + tid]), to_f32(b[lo + tid]), s);
    const V* av = reinterpret_cast<const V*>(a + start);
    const V* bv = reinterpret_cast<const V*>(b + start);
    long long v = tid;
    for (; v + (UNROLL - 1) * THREADS < nvec; v += UNROLL * THREADS) {
      V x[UNROLL], y[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        x[u] = __ldcs(av + v + u * THREADS);
        y[u] = __ldcs(bv + v + u * THREADS);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc[u] = fma_vec(x[u], y[u], acc[u]);
    }
    for (; v < nvec; v += THREADS) acc[0] = fma_vec(__ldcs(av + v), __ldcs(bv + v), acc[0]);
    if (tail + tid < hi) s = fmaf(to_f32(a[tail + tid]), to_f32(b[tail + tid]), s);
  } else {
    long long i = lo + tid;
    for (; i + (UNROLL - 1) * THREADS < hi; i += UNROLL * THREADS) {
      float x[UNROLL], y[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        x[u] = load1(a + i + u * THREADS);
        y[u] = load1(b + i + u * THREADS);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc[u] = fmaf(x[u], y[u], acc[u]);
    }
    for (; i < hi; i += THREADS) acc[0] = fmaf(load1(a + i), load1(b + i), acc[0]);
  }
  static_assert(UNROLL == 4, "the accumulators are summed as a pair of pairs");
  s += (acc[0] + acc[1]) + (acc[2] + acc[3]);
  s = hasco::block_sum<THREADS>(s);
  if (tid == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(FINAL_THREADS)
dot_final_kernel(const float* __restrict__ partial, float* __restrict__ out, int n) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += FINAL_THREADS) s += partial[i];
  s = hasco::block_sum<FINAL_THREADS>(s);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T>
void launch(const void* a, const void* b, void* partial, void* out, long long K, int ctas,
            long long span, cudaStream_t stream) {
  float* first = static_cast<float*>(ctas > 1 ? partial : out);
  dot_partial_kernel<T><<<(unsigned)ctas, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), first, K, span);
  if (ctas > 1)
    dot_final_kernel<<<1, FINAL_THREADS, 0, stream>>>(first, static_cast<float*>(out), ctas);
}

}  // namespace

// ctas x span covers K with no span empty (the plan); partial holds ctas
// floats (unused when ctas == 1).  Returns a CUDA error code.
extern "C" int hasco_dot(const void* a, const void* b, void* partial, void* out,
                         long long K, int ctas, long long span, int dtype, void* stream) {
  if (K < 1 || ctas < 1 || span < 1 || (long long)ctas * span < K ||
      (long long)(ctas - 1) * span >= K)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    launch<float>(a, b, partial, out, K, ctas, span, s);
  else if (dtype == hasco::kBFloat16)
    launch<__nv_bfloat16>(a, b, partial, out, K, ctas, span, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
