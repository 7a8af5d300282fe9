// GEMV intrinsic: y[m] = sum_k A[m,k] * x[k], float32 accumulation.
//
// Replaces the Pallas TPU kernel `repro/kernels/gemv.py::gemv`.
//
// Bound on the H100: bytes.  Every element of A is read once and used for
// one FMA, so at 4096x4096 float32 the 64 MB of A at 3.35 TB/s set the
// floor (0.020 ms).  The card reaches its memory rate only with every SM
// busy and many 16-byte loads in flight, so the geometry is fixed by the
// card, not by the co-designed block:
//   - one warp owns one row; a CTA of 8 warps owns 8 rows, so M = 4096 gives
//     512 CTAs whatever the block;
//   - each lane streams its row in 16-byte vectors (4 float32 or 8
//     bfloat16; neighbouring lanes on neighbouring vectors, 512 bytes a
//     warp), 8 loads in flight, marked evict-first so that x stays cached;
//     x is read in the same vectors through the read-only path;
//   - when the row CTAs are fewer than two per SM, K is split across CTAs
//     (`splits` spans of `span` values, both chosen by the wrapper from
//     M, K and the SM count): each CTA writes a float32 partial per row
//     and a second pass sums a row's partials in a fixed order, with no
//     atomics, so two runs give the same bits.
// A row that is not 16-byte aligned (K*size not a multiple of 16, or an
// unaligned pointer) takes scalar loads up to its first aligned element
// and after its last whole vector; x is read by scalars where it is not
// aligned with the row.  Each lane sums its elements in a fixed order and
// the warp reduces by butterfly, so runs are deterministic.
//
// The block (bm, bk) is still validated and clamped by the wrapper, but it
// no longer moves the time on this card: the operation is bound by bytes,
// and the geometry above reads every byte of A once at any block.
#include <cstdint>

#include "common.cuh"

namespace {

using hasco::from_f32;
using hasco::to_f32;

constexpr int WARPS = 8, THREADS = WARPS * 32, UNROLL = 8;

// VEC values of A's type in 16 bytes, and their products with x's summed
// into acc in a fixed order
template <typename T>
struct VecTraits;

template <>
struct VecTraits<float> {
  static constexpr int N = 4;
  __device__ static float fma_all(uint4 a, uint4 x, float acc) {
    acc = fmaf(__uint_as_float(a.x), __uint_as_float(x.x), acc);
    acc = fmaf(__uint_as_float(a.y), __uint_as_float(x.y), acc);
    acc = fmaf(__uint_as_float(a.z), __uint_as_float(x.z), acc);
    return fmaf(__uint_as_float(a.w), __uint_as_float(x.w), acc);
  }
};

__device__ __forceinline__ float2 bf2(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <>
struct VecTraits<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float fma_all(uint4 a, uint4 x, float acc) {
    const unsigned av[4] = {a.x, a.y, a.z, a.w}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = bf2(av[i]), q = bf2(xv[i]);
      acc = fmaf(p.x, q.x, acc);
      acc = fmaf(p.y, q.y, acc);
    }
    return acc;
  }
};

// 16 bytes of x: one vector load where x is aligned with the row, else
// scalar loads of its elements
template <typename T>
__device__ __forceinline__ uint4 load_x(const T* x, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(x));
  unsigned w[4];
  if constexpr (sizeof(T) == 4) {
    const unsigned* u = reinterpret_cast<const unsigned*>(x);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(u + i);
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (unsigned)__ldg(u + 2 * i) | ((unsigned)__ldg(u + 2 * i + 1) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// grid (cdiv(M, WARPS), splits): warp w of CTA (i, s) sums row i*WARPS + w
// over K values [s*span, min(K, (s+1)*span)).  With one split it writes y;
// with several it writes partial[s*M + row].
template <typename T>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const T* __restrict__ A, const T* __restrict__ x, T* __restrict__ y,
            float* __restrict__ partial, int M, int K, int span) {
  constexpr int VEC = VecTraits<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= M) return;  // warp-uniform: no barrier follows
  const int lo = blockIdx.y * span, hi = min(K, lo + span);
  const T* arow = A + (size_t)row * K;

  // [vlo, vlo + nvec*VEC) is the row's 16-byte-aligned part of [lo, hi)
  const int head = (int)(((16 - (reinterpret_cast<uintptr_t>(arow + lo) & 15)) & 15) /
                         sizeof(T));
  const int vlo = min(hi, lo + head);
  const int nvec = (hi - vlo) / VEC;
  const int vhi = vlo + nvec * VEC;
  const bool xvec = (reinterpret_cast<uintptr_t>(x + vlo) & 15) == 0;  // warp-uniform
  const uint4* av = reinterpret_cast<const uint4*>(arow + vlo);
  const T* xv = x + vlo;

  float acc = 0.f;
  int v = lane;
  for (; v + (UNROLL - 1) * 32 < nvec; v += UNROLL * 32) {
    uint4 a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) a[u] = __ldcs(av + v + u * 32);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) b[u] = load_x(xv + (size_t)(v + u * 32) * VEC, xvec);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = VecTraits<T>::fma_all(a[u], b[u], acc);
  }
  for (; v < nvec; v += 32)
    acc = VecTraits<T>::fma_all(__ldcs(av + v), load_x(xv + (size_t)v * VEC, xvec), acc);
  // the scalar head [lo, vlo) and tail [vhi, hi): fewer than VEC values each
  if (lo + lane < vlo) acc = fmaf(to_f32(arow[lo + lane]), to_f32(x[lo + lane]), acc);
  if (vhi + lane < hi) acc = fmaf(to_f32(arow[vhi + lane]), to_f32(x[vhi + lane]), acc);

  const float s = hasco::warp_sum(acc);
  if (lane == 0) {
    if (gridDim.y == 1)
      y[row] = from_f32<T>(s);
    else
      partial[(size_t)blockIdx.y * M + row] = s;
  }
}

// y[row] = sum over s of partial[s*M + row], s in order
template <typename T>
__global__ void __launch_bounds__(THREADS)
gemv_sum_kernel(const float* __restrict__ partial, T* __restrict__ y, int M, int splits) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= M) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += partial[(size_t)i * M + row];
  y[row] = from_f32<T>(s);
}

template <typename T>
int launch(const void* a, const void* x, void* y, void* partial, int M, int K, int splits,
           int span, cudaStream_t stream) {
  const dim3 grid((unsigned)hasco::cdiv(M, WARPS), (unsigned)splits);
  gemv_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<float*>(partial), M, K, span);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gemv_sum_kernel<T><<<(unsigned)hasco::cdiv(M, THREADS), THREADS, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<T*>(y), M, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// partial: splits*M float32 values when splits > 1 (else unused); span:
// the K values one CTA sums (span*splits >= K).  Returns a CUDA error code.
extern "C" int hasco_gemv(const void* a, const void* x, void* y, void* partial, int M,
                          int K, int splits, int span, int dtype, void* stream) {
  if (M < 1 || K < 1 || splits < 1 || span < 1 || (long long)splits * span < K ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    return launch<float>(a, x, y, partial, M, K, splits, span, s);
  if (dtype == hasco::kBFloat16)
    return launch<__nv_bfloat16>(a, x, y, partial, M, K, splits, span, s);
  return (int)cudaErrorInvalidValue;
}
