// The register-blocked float32 tile that the GEMM and CONV2D kernels share,
// and the fixed-order pass that sums split partials.
//
// One CTA of 256 threads computes a BM x BN tile of C = A * B over the span
// [lo, hi) of the reduction that its split owns (blockIdx.y):
//   - A is a row-major (M, Kred) matrix (GEMM's A, or CONV2D's weights as
//     (K, C*R*S)); a B stager fills the (BK, BN) operand (GEMM's B rows, or
//     CONV2D's implicit-GEMM gather of input pixels);
//   - both operands stream through shared memory in stages of BK reduction
//     values, in a 2-stage cp.async ring: stage s+1 loads while stage s is
//     multiplied.  Rows are copied 16 bytes at a time where they are
//     16-byte aligned, else element by element; the ragged M, N and Kred
//     edges are zero-filled in shared memory, never padded in device memory.
//     The staging loops stay rolled (`#pragma unroll 1`): unrolled, the
//     compiler keeps every copy's address live across the stage loop, and
//     128 x 128 tiles spilled at the 128 registers a thread that
//     `__launch_bounds__(256, 2)` (two CTAs an SM) allows;
//   - each thread owns (BM/16) x (BN/16) outputs in registers (4 x 4 at
//     GEMM's 64 x 64 tile, 8 x 4 at CONV2D's 128 x 64): rows ty + 16*i and
//     columns in groups of up to 4 at tx*4 + 64*g.  A warp spans 4 rows
//     and 8 column groups, so each of its fragment reads is a broadcast
//     of 4 rows (2 reduction values each) or
//     one 128-byte row of B: no bank conflicts (A's row stride BK + 16
//     bytes puts the 4 rows on disjoint banks);
//   - operands stay in their own type in shared memory and are converted to
//     float32 as fragments are read; the products accumulate by FMA in
//     float32 (no TF32: the reference's contract).
// With one split a CTA writes its tile to the output in the output's type;
// with several it writes float32 partials, and split_sum_kernel adds each
// output's partials in split order.  No atomics: two runs give the same
// bits.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace hasco {
namespace {

constexpr int TILE_THREADS = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;

// one element global -> shared, or zero where !ok: float32 by a 4-byte
// cp.async, bfloat16 (below cp.async's 4-byte grain) by a load and a store
__device__ __forceinline__ void stage_elem(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void stage_elem(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

// N consecutive shared-memory values (N = 2 or 4, aligned to N elements)
// as float32
template <int N>
__device__ __forceinline__ void frag(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}
template <int N>
__device__ __forceinline__ void frag(const __nv_bfloat16* p, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 q = __bfloat1622float2(h[i]);
    v[2 * i] = q.x, v[2 * i + 1] = q.y;
  }
}

template <typename T, int BM, int BN, int BK>
struct TileShape {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements in 16 bytes
  static constexpr int LDA = BK + VEC;              // A's row stride in shared memory
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * BN;
  static constexpr int SMEM = 2 * (A_ELEMS + B_ELEMS) * (int)sizeof(T);
  static_assert(BM % 32 == 0 && BN % 32 == 0 && BM <= 128 && BN <= 128, "tile side");
  static_assert(BK % VEC == 0 && BK % 2 == 0, "stage depth");
};

// A's stage: rows [row0, row0 + BM) x reduction [k0, k0 + BK) of a
// row-major (M, lda) matrix.  vec: every row is 16-byte aligned (lda*size
// a multiple of 16 and A aligned), so a 16-byte chunk lies wholly inside or
// wholly outside [k0, k_hi) (k_hi is Kred or a split's end, both multiples
// of the vector).
template <typename T, int BM, int BN, int BK>
__device__ __forceinline__ void stage_a(T* As, const T* __restrict__ A, int lda, int M,
                                        int row0, int k0, int k_hi, bool vec) {
  using S = TileShape<T, BM, BN, BK>;
  if (vec) {
    constexpr int CH = BK / S::VEC;
#pragma unroll 1  // rolled: see the note at the top
    for (int i = threadIdx.x; i < BM * CH; i += TILE_THREADS) {
      const int m = i / CH, c = i % CH, row = row0 + m, k = k0 + c * S::VEC;
      const bool ok = row < M && k < k_hi;
      cp_async16(As + m * S::LDA + c * S::VEC, ok ? A + (size_t)row * lda + k : A, ok);
    }
  } else {
#pragma unroll 1  // rolled: see the note at the top
    for (int i = threadIdx.x; i < BM * BK; i += TILE_THREADS) {
      const int m = i / BK, c = i % BK, row = row0 + m, k = k0 + c;
      const bool ok = row < M && k < k_hi;
      stage_elem(As + m * S::LDA + c, ok ? A + (size_t)row * lda + k : A, ok);
    }
  }
}

// The tile.  grid: (tiles_m * tiles_n, splits); split s owns the reduction
// values [s*span, min(Kred, (s+1)*span)), span a whole number of stages.
// BStage::State start(col0) and BStage::stage<BK, BN>(state, Bs, k0, k_hi)
// fill B's (BK, BN) stage for output columns [col0, col0 + BN).
template <typename T, int BM, int BN, int BK, class BStage>
__global__ void __launch_bounds__(TILE_THREADS, 2)
tile_mm_kernel(const T* __restrict__ A, bool a_vec, BStage bstage, T* __restrict__ out,
               float* __restrict__ partial, int M, int N, int Kred, int span) {
  using S = TileShape<T, BM, BN, BK>;
  constexpr int RM = BM / 16, RN = BN / 16, VB = RN < 4 ? RN : 4, GN = RN / VB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + 2 * S::A_ELEMS;

  const int tiles_n = (N + BN - 1) / BN;
  const int row0 = (blockIdx.x / tiles_n) * BM, col0 = (blockIdx.x % tiles_n) * BN;
  const int lo = blockIdx.y * span, hi = min(Kred, lo + span);
  const int n_st = (hi - lo + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const typename BStage::State bst = bstage.start(col0);

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  stage_a<T, BM, BN, BK>(As, A, Kred, M, row0, lo, hi, a_vec);
  bstage.template stage<BK, BN>(bst, Bs, lo, hi);
  cp_async_commit();
  for (int st = 0; st < n_st; ++st) {
    const int cur = st & 1;
    if (st + 1 < n_st) {
      const int k0 = lo + (st + 1) * BK;
      stage_a<T, BM, BN, BK>(As + (cur ^ 1) * S::A_ELEMS, A, Kred, M, row0, k0, hi, a_vec);
      bstage.template stage<BK, BN>(bst, Bs + (cur ^ 1) * S::B_ELEMS, k0, hi);
    }
    cp_async_commit();
    cp_async_wait<1>();  // stage st has landed
    __syncthreads();
    const T* as = As + cur * S::A_ELEMS + ty * S::LDA;
    const T* bs = Bs + cur * S::B_ELEMS + tx * VB;
#pragma unroll
    for (int kc = 0; kc < BK; kc += 2) {
      float a[RM][2];
#pragma unroll
      for (int i = 0; i < RM; ++i) frag<2>(as + i * 16 * S::LDA + kc, a[i]);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int g = 0; g < GN; ++g) {
          float b[VB];
          frag<VB>(bs + (kc + kk) * BN + g * 16 * VB, b);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int v = 0; v < VB; ++v)
              acc[i][g * VB + v] = fmaf(a[i][kk], b[v], acc[i][g * VB + v]);
        }
    }
    __syncthreads();  // the buffer is free for stage st + 2
  }

  const bool split = gridDim.y > 1;
  float* part = partial + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < GN; ++g)
#pragma unroll
      for (int v = 0; v < VB; ++v) {
        const int col = col0 + g * 16 * VB + tx * VB + v;
        if (col >= N) continue;
        if (split)
          part[(size_t)row * N + col] = acc[i][g * VB + v];
        else
          out[(size_t)row * N + col] = from_f32<T>(acc[i][g * VB + v]);
      }
  }
}

// out[i] = sum over s of partial[s*n + i], s in order
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
split_sum_kernel(const float* __restrict__ partial, T* __restrict__ out, long long n,
                 int splits) {
  const long long i = (long long)blockIdx.x * TILE_THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * n + i];
  out[i] = from_f32<T>(s);
}

// Launch the tile over an (M, N) output and, with several splits, the sum
// of the partials.  Returns a CUDA error code.
template <typename T, int BM, int BN, int BK, class BStage>
int launch_tile(const T* A, bool a_vec, const BStage& bstage, T* out, float* partial, int M,
                int N, int Kred, int splits, int span, cudaStream_t stream) {
  using S = TileShape<T, BM, BN, BK>;
  const long long tiles = cdiv(M, BM) * cdiv(N, BN);
  if (tiles > 0x7fffffffLL || splits < 1 || splits > 65535 || span % BK ||
      (long long)splits * span < Kred || (long long)(splits - 1) * span >= Kred)
    return (int)cudaErrorInvalidValue;  // the plan's contract (kernels/gemm.py::plan)
  auto kern = tile_mm_kernel<T, BM, BN, BK, BStage>;
  if (S::SMEM > SMEM_DEFAULT) {
    // once per instantiation, so that a launch captured into a CUDA graph
    // after a first call makes no attribute call
    static bool opted_in = false;
    if (!opted_in) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
      if (e != cudaSuccess) return (int)e;
      opted_in = true;
    }
  }
  kern<<<dim3((unsigned)tiles, (unsigned)splits), TILE_THREADS, S::SMEM, stream>>>(
      A, a_vec, bstage, out, partial, M, N, Kred, span);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)M * N;
  split_sum_kernel<T><<<(unsigned)cdiv(n, TILE_THREADS), TILE_THREADS, 0, stream>>>(
      partial, out, n, splits);
  return (int)cudaGetLastError();
}

// whether every row of a row-major matrix with `ld` elements a row, at p,
// starts on a 16-byte boundary
template <typename T>
inline bool rows_aligned(const T* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (ld * (long long)sizeof(T)) % 16 == 0;
}

}  // namespace
}  // namespace hasco
