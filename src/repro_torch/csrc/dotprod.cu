// DOT intrinsic: sum_k a[k] * b[k] -> (1, 1) float32, whatever the input type.
//
// Replaces the Pallas TPU kernel `repro/kernels/dotprod.py::dot`.
//
// Bound on the H100: bytes.  Both operands are read once (128 MB at 2^24
// float32 pairs) for one FMA per pair.  The TPU kernel carries its sum
// across a sequential grid; on Hopper the CTAs run in no order, so the sum
// is a deterministic two-pass reduction instead of float atomics:
//   pass 1: one CTA per bk chunk (grid cdiv(K,bk), any positive bk) strides
//           over its chunk and writes one float32 partial;
//   pass 2: one CTA sums the partials in a fixed order into the output.
// Two runs on the same inputs give the same bits.
#include "common.cuh"

namespace {

using hasco::to_f32;

constexpr int THREADS = 256, FINAL_THREADS = 1024;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dot_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ partial, long long K, long long bk) {
  const long long lo = (long long)blockIdx.x * bk;
  const long long hi = min(lo + bk, K);
  float s = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS)
    s = fmaf(to_f32(a[i]), to_f32(b[i]), s);
  s = hasco::block_sum<THREADS>(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(FINAL_THREADS)
dot_final_kernel(const float* __restrict__ partial, float* __restrict__ out, long long n) {
  float s = 0.f;
  for (long long i = threadIdx.x; i < n; i += FINAL_THREADS) s += partial[i];
  s = hasco::block_sum<FINAL_THREADS>(s);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T>
void launch(const void* a, const void* b, void* partial, void* out, long long K,
            long long bk, cudaStream_t stream) {
  const long long n = hasco::cdiv(K, bk);
  dot_partial_kernel<T><<<(unsigned)n, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(partial), K,
      bk);
  dot_final_kernel<<<1, FINAL_THREADS, 0, stream>>>(static_cast<const float*>(partial),
                                                    static_cast<float*>(out), n);
}

}  // namespace

extern "C" int hasco_dot(const void* a, const void* b, void* partial, void* out,
                         long long K, long long bk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    launch<float>(a, b, partial, out, K, bk, s);
  else if (dtype == hasco::kBFloat16)
    launch<__nv_bfloat16>(a, b, partial, out, K, bk, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
