// Flash attention forward: out = softmax(mask(softcap(scale * q k^T))) v, with
// GQA, a bottom-right-aligned causal mask, the gemma2 tanh soft-cap and a
// sliding window; online softmax in float32 over key tiles.
//
// Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
// flash_attention`.  Semantics kept from it: q position i sits at
// i + (Skv - Sq) (the last query aligns with the last key), query head h
// reads key/value head h / (H / Hkv), the soft-cap applies tanh after the
// scale, the window keeps keys with kpos > qpos - window, the default scale
// is D^-0.5.  A row that sees no key at all comes out as zeros, as in the
// plain version (`kernels/xla_attention.py`); the Pallas kernel differs
// there (it averages over the padded key count).
//
// Bound on the H100: operations.  Causal attention over S keys does
// 2 S^2 H D multiply-adds against 2 S H D reads per head group, far above the
// card's ~20 float32 operations per byte.  This first kernel runs float32
// FMA on the SIMT cores (no tensor cores, no TF32: float32 inputs keep
// their full precision, and bfloat16 inputs are widened exactly), so it
// sits well above the bfloat16 tensor-core bound; wgmma and TMA are later
// work.  What the design does: one CTA per (64 queries, head, batch) keeps
// its Q tile resident in shared memory and walks 64-key tiles, skipping the
// tiles that the causal mask or the window hide from every query of the
// CTA; each thread owns a 4x4 block of scores and a 4-row slice of the
// output accumulator in registers, so the scores never reach device memory.
//
// Layout: q (B, Sq, H, D), k and v (B, Skv, Hkv, D), out (B, Sq, H, D),
// each addressed through its own batch, sequence and head strides (the
// head dim must be contiguous), so no transposed copy is made.
#include "common.cuh"

namespace {

using hasco::from_f32;
using hasco::to_f32;

constexpr int THREADS = 256;
constexpr int BQ = 64, BKV = 64;   // queries and keys per tile
constexpr int TR = 4;              // score rows per thread (16 row groups)
constexpr int TC = 4;              // score columns per thread (16 lanes)
constexpr int PS = BKV + 4;        // row stride of the probability tile
constexpr float NEG_INF = -1e30f;  // the reference's mask value

struct Strides {
  long long b, s, h;
};

// Stage rows [row0, row0 + BKV) of one head of k or v (or q) into smem with
// row stride ld, zero-filling rows past n_rows.  Consecutive threads read
// consecutive elements of a row: coalesced, and conflict-free in smem.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, Strides st,
                                      int b, int head, int row0, int n_rows, int rows, int D,
                                      int ld) {
  const T* base = src + (long long)b * st.b + (long long)head * st.h;
  for (int idx = threadIdx.x; idx < rows * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int row = row0 + r;
    dst[r * ld + d] = row < n_rows ? to_f32(base[(long long)row * st.s + d]) : 0.f;
  }
}

// NCOL: output columns per thread, ceil(D / 16) <= NCOL.
template <typename T, int NCOL>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int Sq, int Skv, int H, int Hkv, int D, Strides qs,
             Strides ks, Strides vs, Strides os, int causal, int window, float softcap,
             float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;            // odd row stride: column reads hit distinct banks
  float* Qs = smem;                // BQ x ld
  float* KVs = Qs + BQ * ld;       // BKV x ld, holds K then V of the same tile
  float* Ps = KVs + BKV * ld;      // BQ x PS probabilities

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q_offset = Skv - Sq;

  // key range that any query of this tile can see
  const int qmin = q0 + q_offset;
  const int qmax = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kv_hi = causal ? min(Skv, qmax + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, qmin - window + 1) : 0;

  stage(Qs, q, qs, b, h, q0, Sq, BQ, D, ld);

  float m[TR], l[TR], acc[TR][NCOL];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (kv_lo / BKV) * BKV; k0 < kv_hi; k0 += BKV) {
    __syncthreads();  // previous tile's V and P reads are done (and Q staged)
    stage(KVs, k, ks, b, hk, k0, Skv, BKV, D, ld);
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = Qs[(ty * TR + i) * ld + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kv[j] = KVs[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, soft-cap, mask; online softmax per row.  The 16 threads of a
    // row group are 16 consecutive lanes, so xor-shuffles of 8..1 reduce a
    // row in a fixed order and leave every lane with the same m and l.
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q0 + ty * TR + i + q_offset;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        x = ok ? x : NEG_INF;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        // a masked score adds nothing, even while the row has seen no key
        const float p = s[i][j] > 0.5f * NEG_INF ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * TR + i) * PS + tx + 16 * j] = p;
        rsum += p;
      }
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // all K reads are done before V overwrites the tile
    stage(KVs, v, vs, b, hk, k0, Skv, BKV, D, ld);
    __syncthreads();

    const int kn = min(BKV, Skv - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = Ps[(ty * TR + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vv = KVs[kk * ld + col];
#pragma unroll
          for (int i = 0; i < TR; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  T* obase = out + (long long)b * os.b + (long long)h * os.h;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty * TR + i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = tx + 16 * c;
      if (col < D) obase[(long long)row * os.s + col] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int NCOL>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int H, int Hkv, int D, Strides qs, Strides ks, Strides vs, Strides os,
           int causal, int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(BQ + BKV) * (D + 1) + (size_t)BQ * PS);
  auto kern = flash_kernel<T, NCOL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)hasco::cdiv(Sq, BQ), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, Hkv, D, qs, ks, vs, os, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
             int H, int Hkv, int D, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, int window, float softcap, float scale, cudaStream_t s) {
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, B, Sq, Skv, H, Hkv, D, qs, ks, vs, os, causal, window,
                        softcap, scale, s);
  return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, Hkv, D, qs, ks, vs, os, causal, window,
                       softcap, scale, s);
}

}  // namespace

// strides: {batch, sequence, head} in elements for q, k, v and out, in that
// order (12 values); the head dim is contiguous.  Returns a CUDA error code.
extern "C" int hasco_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int Sq, int Skv, int H, int Hkv, int D,
                                     const long long* strides, int causal, int window,
                                     float softcap, float scale, int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    return dispatch<float>(q, k, v, o, B, Sq, Skv, H, Hkv, D, qs, ks, vs, os, causal, window,
                           softcap, scale, s);
  if (dtype == hasco::kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, D, qs, ks, vs, os, causal,
                                   window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
