// GEMV intrinsic: y[m] = sum_k A[m,k] * x[k], float32 accumulation.
//
// Replaces the Pallas TPU kernel `repro/kernels/gemv.py::gemv`.
//
// Bound on the H100: bytes.  Every element of A is read once and used for
// one FMA, so at 4096x4096 float32 the 64 MB of A at 3.35 TB/s set the
// floor.  The design streams A with each warp reading 128 contiguous bytes
// per row access and keeps four rows in flight per warp; x is staged once
// per chunk in shared memory and reused by every row of the CTA.
//
// The block (bm, bk) is honoured as given, any positive value: one CTA owns
// bm rows (grid cdiv(M,bm)) and walks them 32 at a time (8 warps x 4 rows);
// K is walked in bk blocks, each staged through shared memory in chunks of
// at most 4096 values of x.  Each lane keeps a float32 partial per row; the
// warp reduces it with a butterfly in a fixed order, so runs are
// deterministic.
#include "common.cuh"

namespace {

using hasco::from_f32;
using hasco::to_f32;

constexpr int THREADS = 256, WARPS = THREADS / 32, RPW = 4, XCHUNK = 4096;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const T* __restrict__ A, const T* __restrict__ x, T* __restrict__ y, int M,
            int K, int bm, int bk) {
  __shared__ float xs[XCHUNK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_lo = blockIdx.x * bm, row_hi = min(row_lo + bm, M);

  for (int g0 = row_lo; g0 < row_hi; g0 += WARPS * RPW) {
    const int r_base = g0 + warp * RPW;
    const int n_rows = max(0, min(RPW, row_hi - r_base));  // warp-uniform
    float acc[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) acc[rr] = 0.f;

    for (int kb = 0; kb < K; kb += bk) {
      const int kb_hi = min(kb + bk, K);
      for (int k0 = kb; k0 < kb_hi; k0 += XCHUNK) {
        const int kt = min(XCHUNK, kb_hi - k0);
        for (int i = threadIdx.x; i < kt; i += THREADS) xs[i] = to_f32(x[k0 + i]);
        __syncthreads();
        const T* arow = A + (size_t)r_base * K + k0;
        for (int k = lane; k < kt; k += 32) {
          const float xv = xs[k];
#pragma unroll
          for (int rr = 0; rr < RPW; ++rr)
            if (rr < n_rows) acc[rr] = fmaf(to_f32(arow[(size_t)rr * K + k]), xv, acc[rr]);
        }
        __syncthreads();
      }
    }

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float v = hasco::warp_sum(acc[rr]);
      if (lane == 0 && rr < n_rows) y[r_base + rr] = from_f32<T>(v);
    }
  }
}

template <typename T>
void launch(const void* a, const void* x, void* y, int M, int K, int bm, int bk,
            cudaStream_t stream) {
  const dim3 grid((unsigned)hasco::cdiv(M, bm));
  gemv_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(a),
                                               static_cast<const T*>(x),
                                               static_cast<T*>(y), M, K, bm, bk);
}

}  // namespace

extern "C" int hasco_gemv(const void* a, const void* x, void* y, int M, int K, int bm,
                          int bk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    launch<float>(a, x, y, M, K, bm, bk, s);
  else if (dtype == hasco::kBFloat16)
    launch<__nv_bfloat16>(a, x, y, M, K, bm, bk, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
