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
// card's ~300 bfloat16 tensor-core operations per byte.  Two kernels, one
// chosen per call by a written rule (`kernels/flash_attention.py::route`):
//
// "tc", the tensor-core kernel (bfloat16, D % 16 == 0, D <= 256, 16-byte
// aligned rows): the FlashAttention-2 structure on mma.sync m16n8k16 with
// bfloat16 inputs and float32 accumulation.  One CTA of 4 warps per (64
// queries, head, batch), each warp owning 16 query rows; Q is staged once
// and held as A fragments in registers up to D = 112 (re-read from shared
// memory each tile from D = 128 up, where holding it spills); K and V stream
// through a 2-stage cp.async ring of 64-key tiles (tile j+1 loads while
// tile j computes), rows padded by 16 bytes so ldmatrix (K) and
// ldmatrix.trans (V) hit distinct banks.  S = Q K^T lands in accumulator fragments; scale,
// soft-cap, mask and the online softmax run there, each row's max and sum
// reduced over the 4 lanes of a quad in a fixed order; P goes straight from
// registers into A fragments of the P V product.  Rounding: products of
// bfloat16 values are exact in float32, so S differs from the float32
// route only in summation order; P is split into two bfloat16 terms, P_hi =
// bf16(P) and P_lo = bf16(P - P_hi), and P V runs once for each, so P keeps
// ~16 bits (one term alone, ~8 bits, moves near-cancelling outputs past
// the bfloat16 limit); the row sum l adds the same P_hi + P_lo the product
// used.  The output is rounded to bfloat16 once.
//
// "simt", every other call (float32 above all: no TF32): float32 FMA on the
// SIMT cores, bfloat16 widened exactly on load.  One CTA per (64 queries,
// head, batch) keeps its Q tile resident in shared memory and walks 64-key
// tiles; each thread owns a 4x4 block of scores and a 4-row slice of the
// output accumulator in registers.
//
// Both skip the key tiles that the causal mask or the window hide from
// every query of the CTA, so the scores never reach device memory and
// hidden tiles cost nothing.  The tensor-core kernel's grid runs the query
// blocks last-first, so the longest causal rows start first.
//
// Layout: q (B, Sq, H, D), k and v (B, Skv, Hkv, D), out (B, Sq, H, D),
// each addressed through its own batch, sequence and head strides (the
// head dim must be contiguous), so no transposed copy is made.
#include <utility>

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


// ---- the tensor-core route: bfloat16 on mma.sync m16n8k16 ------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // 4 warps, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;

using hasco::cp_async16;
using hasco::cp_async_commit;
using hasco::cp_async_wait;
using hasco::smem_u32;

using hasco::as_u32;
using hasco::ldsm_x4;
using hasco::ldsm_x4_t;
using hasco::mma;

// rows [row0, row0 + ROWS) of one head (base: its first row) into smem with
// row stride D + 8, zero-filling rows at or past n_rows
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long stride,
                                          int row0, int n_rows) {
  constexpr int CH = D / 8, N = ROWS * CH;  // 16-byte chunks: a row's, the tile's
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    if (N % THREADS != 0 && c >= N) break;
    const int r = c / CH, col = (c % CH) * 8, row = row0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + r * (D + 8) + col, ok ? base + row * stride + col : base, ok);
  }
}

// Fragment layouts of m16n8k16 (lane = 4g + t): A regs hold (row g | g+8,
// cols 2t,2t+1 | 2t+8,2t+9), B regs (k 2t,2t+1 | 2t+8,2t+9; col g), the
// accumulator (row g | g+8; cols 2t, 2t+1).  Each warp's score tile is
// 16 rows x 64 keys: 8 accumulators s[n] (keys 8n..8n+7); its output
// 16 x D: D/8 accumulators o[n] (cols 8n..8n+7).
template <int D, bool Q_REGS>
__global__ void __launch_bounds__(THREADS)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Skv, int H,
                int Hkv, Strides qs, Strides ks, Strides vs, Strides os, int causal,
                int window, float softcap, float scale) {
  constexpr int LD = D + 8, KSTEPS = D / 16, NT_O = D / 8, NT_S = BKV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* Ks = Qs + BQ * LD;                       // 2 stages of BKV x LD
  bf16* Vs = Ks + 2 * BKV * LD;                  // 2 stages of BKV x LD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q_offset = Skv - Sq;

  // key range that any query of this tile can see
  const int qmin = q0 + q_offset;
  const int qmax = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kv_hi = causal ? min(Skv, qmax + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, qmin - window + 1) : 0;
  const int first = (kv_lo / BKV) * BKV;
  const int n_tiles = kv_hi > first ? (kv_hi - first + BKV - 1) / BKV : 0;

  const bf16* kbase = k + (long long)b * ks.b + (long long)hk * ks.h;
  const bf16* vbase = v + (long long)b * vs.b + (long long)hk * vs.h;
  load_tile<D, BQ>(Qs, q + (long long)b * qs.b + (long long)h * qs.h, qs.s, q0, Sq);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<D, BKV>(Ks, kbase, ks.s, first, Skv);
    load_tile<D, BKV>(Vs, vbase, vs.s, first, Skv);
  }
  cp_async_commit();

  // this lane's ldmatrix rows: Q (A operand), K (B of Q K^T), V (B of P V,
  // transposed on load)
  const bf16* q_lane = Qs + (warp * 16 + (lane & 15)) * LD + ((lane >> 4) << 3);
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);

  unsigned qf[Q_REGS ? KSTEPS : 1][4];
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qf[kk], q_lane + kk * 16);
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // rows g, g + 8

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = first + j * BKV, st = j & 1;
    if (j + 1 < n_tiles) {  // the next tile loads while this one computes
      load_tile<D, BKV>(Ks + (st ^ 1) * BKV * LD, kbase, ks.s, k0 + BKV, Skv);
      load_tile<D, BKV>(Vs + (st ^ 1) * BKV * LD, vbase, vs.s, k0 + BKV, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const bf16* Kt = Ks + st * BKV * LD;
    const bf16* Vt = Vs + st * BKV * LD;

    // S = Q K^T
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      unsigned a[4];
      if constexpr (Q_REGS) {
        a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2], a[3] = qf[kk][3];
      } else {
        ldsm_x4(a, q_lane + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, Kt + np * 16 * LD + k_off + kk * 16);
        mma(s[2 * np], a, bk[0], bk[1]);
        mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, soft-cap, mask (only where the tile crosses an edge); scores
    // in log2 units from here on
    const bool edge = (causal && k0 + BKV - 1 > qmin) ||
                      (window > 0 && k0 <= qmax - window) || k0 + BKV > Skv;
    float rmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x *= LOG2E;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          const int qpos = q0 + warp * 16 + g + (e >> 1) * 8 + q_offset;
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = ok ? x : NEG_INF;
        }
        s[n][e] = x;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
      const float m_new = fmaxf(m_run[r], rmax[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0], o[n][1] *= alpha[0];
      o[n][2] *= alpha[1], o[n][3] *= alpha[1];
    }

    // O += P V, 16 keys at a time: P = P_hi + P_lo, both bfloat16 A
    // fragments built in registers from score accumulators 2kk and 2kk+1
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      unsigned ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // A reg i: accumulator 2kk + i/2, row half i%2
        const float* sv = &s[2 * kk + (i >> 1)][(i & 1) * 2];
        const float m = m_run[i & 1];
        // a masked score adds nothing, even while the row has seen no key
        const float p0 = sv[0] > 0.5f * NEG_INF ? exp2f(sv[0] - m) : 0.f;
        const float p1 = sv[1] > 0.5f * NEG_INF ? exp2f(sv[1] - m) : 0.f;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        const float2 lf = __bfloat1622float2(lo);
        l_run[i & 1] += (hf.x + lf.x) + (hf.y + lf.y);
        ph[i] = as_u32(hi);
        pl[i] = as_u32(lo);
      }
#pragma unroll
      for (int dp = 0; dp < NT_O / 2; ++dp) {
        unsigned bv[4];
        ldsm_x4_t(bv, Vt + kk * 16 * LD + v_off + dp * 16);
        mma(o[2 * dp], ph, bv[0], bv[1]);
        mma(o[2 * dp], pl, bv[0], bv[1]);
        mma(o[2 * dp + 1], ph, bv[2], bv[3]);
        mma(o[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }
  cp_async_wait<0>();

  bf16* obase = out + (long long)b * os.b + (long long)h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    bf16* orow = obase + (long long)row * os.s + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int H, int Hkv, Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(BQ + 4 * BKV) * (D + 8);
  auto kern = flash_tc_kernel<D, (D <= 112)>;  // Q in registers up to D 112
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)hasco::cdiv(Sq, BQ), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Skv, H, Hkv, qs, ks, vs, os, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int... Ds>
int dispatch(std::integer_sequence<int, Ds...>, int D, const void* q, const void* k,
             const void* v, void* o, int B, int Sq, int Skv, int H, int Hkv, Strides qs,
             Strides ks, Strides vs, Strides os, int causal, int window, float softcap,
             float scale, cudaStream_t s) {
  int rc = (int)cudaErrorInvalidValue;
  // one instance per head dim 16, 32, ..., 256
  ((D == 16 * (Ds + 1)
        ? (rc = launch<16 * (Ds + 1)>(q, k, v, o, B, Sq, Skv, H, Hkv, qs, ks, vs, os,
                                      causal, window, softcap, scale, s),
           0)
        : 0),
   ...);
  return rc;
}

}  // namespace tc

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

// The tensor-core route: bfloat16 q, k, v, out; D % 16 == 0, D <= 256; every
// row 16-byte aligned (the wrapper's route rule).  Arguments as above.
extern "C" int hasco_flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                                        int B, int Sq, int Skv, int H, int Hkv, int D,
                                        const long long* strides, int causal, int window,
                                        float softcap, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 || D % 16 != 0 || D < 16 ||
      D > 256)
    return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  return tc::dispatch(std::make_integer_sequence<int, 16>{}, D, q, k, v, o, B, Sq, Skv, H,
                      Hkv, qs, ks, vs, os, causal, window, softcap, scale,
                      static_cast<cudaStream_t>(stream));
}
