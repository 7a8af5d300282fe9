// GEMM intrinsic: C[M,N] = A[M,K] @ B[K,N], float32 accumulation.
//
// Replaces the Pallas TPU kernel `repro/kernels/gemm.py::gemm`.
//
// Bound on the H100: at the main path's 1024^3 in float32 it is bound by
// operations (2*M*N*K FMA flops against 67 TFLOP/s without tensor cores);
// the bytes (12 MB) take a tenth of that time.  The design keeps each
// operand tile in shared memory and each output in registers, so every
// loaded element feeds 64 FMAs.  wgmma/TMA are for a later change.
//
// The block (bm, bn, bk) is the co-designed accelerator and is honoured as
// given, any positive value: one CTA owns one bm x bn output region (grid
// cdiv(N,bn) x cdiv(M,bm)) and walks it in 64x64 register tiles (256
// threads, 4x4 outputs each); K is walked in bk blocks, each staged through
// shared memory in chunks of at most 32.  The ragged edge of every level is
// masked in the kernel; nothing is padded in device memory.
#include "common.cuh"

namespace {

using hasco::from_f32;
using hasco::to_f32;

constexpr int TM = 64, TN = 64, TK = 32, THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
            int M, int N, int K, int bm, int bn, int bk) {
  __shared__ float As[TK][TM + 1];  // k-major; +1 keeps the staging stores conflict-free
  __shared__ float Bs[TK][TN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row_lo = blockIdx.y * bm, row_hi = min(row_lo + bm, M);
  const int col_lo = blockIdx.x * bn, col_hi = min(col_lo + bn, N);

  for (int r0 = row_lo; r0 < row_hi; r0 += TM) {
    for (int c0 = col_lo; c0 < col_hi; c0 += TN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int kb = 0; kb < K; kb += bk) {
        const int kb_hi = min(kb + bk, K);
        for (int k0 = kb; k0 < kb_hi; k0 += TK) {
          const int kt = min(TK, kb_hi - k0);
          for (int i = tid; i < TM * TK; i += THREADS) {
            const int m = i / TK, k = i % TK, gr = r0 + m;
            As[k][m] = (k < kt && gr < row_hi) ? to_f32(A[(size_t)gr * K + k0 + k]) : 0.f;
          }
          for (int i = tid; i < TK * TN; i += THREADS) {
            const int k = i / TN, n = i % TN, gc = c0 + n;
            Bs[k][n] = (k < kt && gc < col_hi) ? to_f32(B[(size_t)(k0 + k) * N + gc]) : 0.f;
          }
          __syncthreads();
#pragma unroll 4
          for (int k = 0; k < kt; ++k) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
          __syncthreads();
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty * 4 + i;
        if (r >= row_hi) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx * 4 + j;
          if (c < col_hi) C[(size_t)r * N + c] = from_f32<T>(acc[i][j]);
        }
      }
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn,
            int bk, cudaStream_t stream) {
  const dim3 grid((unsigned)hasco::cdiv(N, bn), (unsigned)hasco::cdiv(M, bm));
  gemm_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(a),
                                               static_cast<const T*>(b),
                                               static_cast<T*>(c), M, N, K, bm, bn, bk);
}

}  // namespace

extern "C" int hasco_gemm(const void* a, const void* b, void* c, int M, int N, int K,
                          int bm, int bn, int bk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    launch<float>(a, b, c, M, N, K, bm, bn, bk, s);
  else if (dtype == hasco::kBFloat16)
    launch<__nv_bfloat16>(a, b, c, M, N, K, bm, bn, bk, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
