// GEMM intrinsic: C[M,N] = A[M,K] @ B[K,N], float32 accumulation.
//
// Replaces the Pallas TPU kernel `repro/kernels/gemm.py::gemm`.
//
// Bound on the H100: operations.  At the main path's 1024^3 in float32 the
// 2*M*N*K flops take 0.032 ms at 67 TFLOP/s (float32 FMA: no TF32, the
// reference accumulates in full float32); its 12 MB take a tenth of that.
// Reaching the FMA rate needs every SM busy and each loaded value feeding
// many FMAs, so:
//   - the co-designed block (bm, bn, bk) is legalised to a CTA tile the
//     kernel is compiled for (`kernels/gemm.py::plan`): each side of
//     (bm, bn) picks 32 or 64 rows / columns and bk picks a shared-memory
//     stage of 8, 16 or 32 K values, monotone in the block.  Blocks at or
//     above 64 (sides) or 32 (depth) share the largest tile.  So the block
//     still moves the time, as the paper's PE array does, but a large
//     block no longer leaves SMs idle: 1024^3 runs 256 tiles of 64 x 64;
//   - where the output tiles are fewer than the SMs, K is split over CTAs
//     in spans of whole stages until the card is covered, and a second
//     pass sums the float32 partials in a fixed order (no atomics).  A
//     split re-associates the float32 sums (more accurately than one long
//     chain, but not in cuBLAS's order), which is why the tile stops at 64
//     a side: a 128-side tile would split K at 1024^3 (see the plan);
//   - each CTA runs the register-blocked tile of `tile_mm.cuh`: a 2-stage
//     cp.async ring of 16-byte copies, 4 x 4 outputs a thread at the
//     64 x 64 tile, conflict-free fragment reads.
// Rows that are not 16-byte aligned (K or N times the element size not a
// multiple of 16, or an offset pointer) are staged element by element; the
// ragged edges are zero-filled in shared memory, nothing is padded in
// device memory.  bfloat16 operands run the same float32 FMA tile.
#include "tile_mm.cuh"

namespace {

using hasco::stage_elem;
using hasco::TILE_THREADS;

// B's stage for a row-major (K, N) matrix: rows [k0, k0 + BK) x columns
// [col0, col0 + BN); vec: every row 16-byte aligned
template <typename T>
struct DenseB {
  const T* b;
  int N;
  bool vec;

  struct State {
    int col0;
  };
  __device__ State start(int col0) const { return {col0}; }

  template <int BK, int BN>
  __device__ __forceinline__ void stage(const State& st, T* Bs, int k0, int k_hi) const {
    constexpr int V = 16 / (int)sizeof(T);
    if (vec) {
      constexpr int CH = BN / V;
#pragma unroll 1  // rolled: see tile_mm.cuh
      for (int i = threadIdx.x; i < BK * CH; i += TILE_THREADS) {
        const int k = k0 + i / CH, col = st.col0 + (i % CH) * V;
        const bool ok = k < k_hi && col < N;  // N is a multiple of V
        hasco::cp_async16(Bs + i * V, ok ? b + (size_t)k * N + col : b, ok);
      }
    } else {
#pragma unroll 1  // rolled: see tile_mm.cuh
      for (int i = threadIdx.x; i < BK * BN; i += TILE_THREADS) {
        const int k = k0 + i / BN, col = st.col0 + i % BN;
        const bool ok = k < k_hi && col < N;
        stage_elem(Bs + i, ok ? b + (size_t)k * N + col : b, ok);
      }
    }
  }
};

struct Args {
  const void *a, *b;
  void *c, *partial;
  int M, N, K, splits, span;
  cudaStream_t stream;
};

template <typename T, int BM, int BN, int BK>
int launch(const Args& g) {
  const T* a = static_cast<const T*>(g.a);
  const T* b = static_cast<const T*>(g.b);
  const DenseB<T> bstage{b, g.N, hasco::rows_aligned(b, g.N)};
  return hasco::launch_tile<T, BM, BN, BK>(a, hasco::rows_aligned(a, g.K), bstage,
                                           static_cast<T*>(g.c),
                                           static_cast<float*>(g.partial), g.M, g.N, g.K,
                                           g.splits, g.span, g.stream);
}

template <typename T, int BM, int BN>
int by_depth(int tk, const Args& g) {
  switch (tk) {
    case 8: return launch<T, BM, BN, 8>(g);
    case 16: return launch<T, BM, BN, 16>(g);
    case 32: return launch<T, BM, BN, 32>(g);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int BM>
int by_cols(int tn, int tk, const Args& g) {
  switch (tn) {
    case 32: return by_depth<T, BM, 32>(tk, g);
    case 64: return by_depth<T, BM, 64>(tk, g);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_tile(int tm, int tn, int tk, const Args& g) {
  switch (tm) {
    case 32: return by_cols<T, 32>(tn, tk, g);
    case 64: return by_cols<T, 64>(tn, tk, g);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// (tm, tn, tk): the CTA tile, one of the compiled classes; splits CTAs along
// K, each over `span` K values (a multiple of tk; the last one ragged);
// partial: splits*M*N float32 values when splits > 1 (else unused).
// Returns a CUDA error code.
extern "C" int hasco_gemm(const void* a, const void* b, void* c, void* partial, int M, int N,
                          int K, int tm, int tn, int tk, int splits, int span, int dtype,
                          void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const Args g{a, b, c, partial, M, N, K, splits, span, static_cast<cudaStream_t>(stream)};
  if (dtype == hasco::kFloat32) return by_tile<float>(tm, tn, tk, g);
  if (dtype == hasco::kBFloat16) return by_tile<__nv_bfloat16>(tm, tn, tk, g);
  return (int)cudaErrorInvalidValue;
}
