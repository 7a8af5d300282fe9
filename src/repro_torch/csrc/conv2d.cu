// CONV2D intrinsic: direct 'valid' convolution, no batch, unit stride,
//   out[k,x,y] = sum_{c,r,s} a[c,x+r,y+s] * w[k,c,r,s],  float32 accumulation.
//
// Replaces the Pallas TPU kernel `repro/kernels/conv2d.py::conv2d`.
//
// Bound on the H100: operations.  At the main path's ResNet-50 3x3 layer
// (K=C=256, 14x14 out) the 2*K*C*R*S*X*Y flops take 0.0035 ms at 67 TFLOP/s
// (float32 FMA), four times what moving its 2.8 MB takes.  The TPU
// kernel keeps the whole input resident per program and unrolls the taps
// into matrix-unit products; here the convolution runs as an implicit GEMM
// on the register-blocked tile of `tile_mm.cuh`, which GEMM runs too:
//   - w[k, c, r, s] is already a row-major (K, C*R*S) matrix: the tile's A;
//   - B[(c,r,s), (x,y)] = a[c, x+r, y+s] is gathered stage by stage into
//     shared memory only (each thread decomposes its stage row into
//     (c, r, s) once and keeps its columns' pixel offsets in registers), so
//     no im2col buffer exists in device memory, the point of the paper's
//     Fig. 11: the only device memory written is the output and, with a
//     split, the float32 partials;
//   - bk (output channels per CTA, the co-designed block) is legalised to
//     a tile of 32, 64 or 128 channels (`kernels/conv2d.py::plan`), monotone
//     in bk; blocks of 128 and more share the largest.  A tile covers 64
//     output pixels and a stage 32 values of C*R*S;
//   - where the output tiles are fewer than the SMs, C*R*S is split over
//     CTAs in spans of whole stages (a span may end inside a channel's
//     taps), and the partials are summed in a fixed order (no atomics).
// The ragged K, X*Y and C*R*S edges are zero-filled in shared memory.
#include "tile_mm.cuh"

namespace {

using hasco::stage_elem;
using hasco::TILE_THREADS;

constexpr int TILE_N = 64, DEPTH = 32;  // output pixels a tile, C*R*S values a stage

// B's stage gathered from the input a (C, H, W): a thread owns one stage
// row and the columns cg + 8*j of the tile
template <typename T>
struct ConvB {
  const T* a;
  int H, W, S, RS, Y, XY;
  static constexpr int COLS = TILE_N / 8;

  struct State {
    int off[COLS];  // x*W + y of each column's output pixel; -1 past X*Y
  };
  __device__ State start(int col0) const {
    State st;
    const int cg = threadIdx.x % 8;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int n = col0 + cg + 8 * j;
      st.off[j] = n < XY ? (n / Y) * W + n % Y : -1;
    }
    return st;
  }

  template <int BK, int BN>
  __device__ __forceinline__ void stage(const State& st, T* Bs, int k0, int k_hi) const {
    static_assert(BK == TILE_THREADS / 8 && BN == TILE_N, "one stage row a thread");
    const int row = threadIdx.x / 8, cg = threadIdx.x % 8, idx = k0 + row;
    const bool in = idx < k_hi;
    const int c = idx / RS, rs = idx - c * RS, r = rs / S;
    const T* base = in ? a + ((size_t)c * H + r) * W + (rs - r * S) : a;
    T* dst = Bs + row * BN + cg;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const bool ok = in && st.off[j] >= 0;
      stage_elem(dst + 8 * j, ok ? base + st.off[j] : a, ok);
    }
  }
};

template <typename T, int BM>
int launch(const void* a, const void* w, void* out, void* partial, int C, int H, int W, int K,
           int R, int S, int splits, int span, cudaStream_t stream) {
  const int X = H - R + 1, Y = W - S + 1, CRS = C * R * S;
  const T* wt = static_cast<const T*>(w);
  const ConvB<T> bstage{static_cast<const T*>(a), H, W, S, R * S, Y, X * Y};
  return hasco::launch_tile<T, BM, TILE_N, DEPTH>(wt, hasco::rows_aligned(wt, CRS), bstage,
                                                  static_cast<T*>(out),
                                                  static_cast<float*>(partial), K, X * Y,
                                                  CRS, splits, span, stream);
}

template <typename T>
int by_tile(int tm, const void* a, const void* w, void* out, void* partial, int C, int H,
            int W, int K, int R, int S, int splits, int span, cudaStream_t stream) {
  switch (tm) {
    case 32: return launch<T, 32>(a, w, out, partial, C, H, W, K, R, S, splits, span, stream);
    case 64: return launch<T, 64>(a, w, out, partial, C, H, W, K, R, S, splits, span, stream);
    case 128:
      return launch<T, 128>(a, w, out, partial, C, H, W, K, R, S, splits, span, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// tm: output channels a tile (32, 64 or 128); splits CTAs along C*R*S, each
// over `span` values (a multiple of the 32-value stage; the last ragged);
// partial: splits*K*X*Y float32 values when splits > 1 (else unused).
// Returns a CUDA error code.
extern "C" int hasco_conv2d(const void* a, const void* w, void* out, void* partial, int C,
                            int H, int W, int K, int R, int S, int tm, int splits, int span,
                            int dtype, void* stream) {
  if (C < 1 || K < 1 || R < 1 || S < 1 || H < R || W < S) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    return by_tile<float>(tm, a, w, out, partial, C, H, W, K, R, S, splits, span, s);
  if (dtype == hasco::kBFloat16)
    return by_tile<__nv_bfloat16>(tm, a, w, out, partial, C, H, W, K, R, S, splits, span, s);
  return (int)cudaErrorInvalidValue;
}
