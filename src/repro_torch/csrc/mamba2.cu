// Mamba-2 SSD recurrence, chunk-parallel.  For each (batch, head) the state h
// (N x P, float32) evolves over chunks of L = 64 tokens; within a chunk (la =
// inclusive cumsum of the per-head log-decay a, restarting at every chunk):
//
//   y_t  = e^{la_t} c_t . h  +  sum_{s<=t} e^{la_t - la_s} (c_t . b_s) x_s
//   h'   = e^{la_L} h  +  sum_s e^{la_L - la_s} b_s x_s^T
//
// Replaces the Pallas TPU kernel `repro/kernels/mamba2.py::mamba2` (the same
// formula, its lines 7-9, and its chunk of 64).  The intra-chunk diagonal is
// inclusive, every exponent is <= 0 for a <= 0 and is clamped there, and any
// T >= 1 is taken: rows past T are staged as x = 0, a = 0, b = c = 0, which
// adds nothing and leaves h as it was.
//
// Bound on the H100: bytes.  At zamba2-2.7b's forward (B1 T4096 H80 P=N=64
// bfloat16, b and c one group shared by the heads) x and y are 42 MB each, b
// and c 1 MB, the state 1.3 MB: 0.026 ms at 3.35 TB/s, against ~8 GFLOP of
// chunked products, 0.008 ms on the bfloat16 tensor cores.  The TPU kernel
// carries h along a sequential grid axis; here three passes run over SPANS of
// S chunks (S = span_chunks, chosen by `kernels/mamba2.py::plan`):
//
//   1. span states: every (span, head, batch) in parallel walks its S chunks
//      from h = 0 and writes its local state S_j and its decay
//      prod_c e^{la_L^c} (float32);
//   2. state passing (state_pass.cuh, shared with rwkv6.cu, here at one
//      decay a span): elementwise over (batch, head, n, p), in order over
//      the spans, H_{j+1} = decay_j H_j + S_j from the given state (or 0);
//      H_j, the state entering span j, overwrites S_j, and the last value
//      is the final state;
//   3. outputs: every (span, head group, batch) in parallel walks its S
//      chunks from H_j, writing y and updating h between its chunks.
//
// Each CTA loads the next head's (or chunk's) x by cp.async and its a into
// registers while the current one computes.
//
// No CTA walks all of T.  b and c come in G groups, head h reading group h /
// (H / G) (zamba2-2.7b: one group every head reads; zamba2-7b: two groups of
// 56 heads).  The Gram C.B^T depends on the group, not the head: where a
// group holds more than one head, pass 1's CTAs of each group's first head
// and column block also compute each chunk's Gram, once a group, into a
// buffer, and every pass-3 CTA reads its group's there (from L2) instead of
// computing it; a bfloat16 pass-3 CTA then owns two heads of one group,
// staging c once for both.  Where each head is its own group, each pass-3
// CTA computes its head's Gram.
//
// Intermediate bytes set this design's own floor beside the bound: the span
// states take NS x B x H x N x P x 4 bytes, written by pass 1, read and
// written by pass 2, read by pass 3.  Per 64-token chunk (NS = 64 at T 4096)
// that is 84 MB, more than the 50 MB L2, ~335 MB of traffic (0.10 ms); the
// plan's 256-token spans (S = 4, NS = 16) make it 21 MB, which stays in L2.
// Pass 3 redoes S - 1 state updates a span that pass 1 did.  The shared
// Grams take B x G x cdiv(T, 64) x 64 x 64 x 4 bytes: 1 MB a group at T 4096.
//
// bfloat16 ("tc"), 8 warps a CTA (4 row tiles of 16 x 2 column halves of 32;
// x, y and h in column blocks of 64).  The state's products run on mma.sync
// m16n8k16, bfloat16 in, float32 accumulate: the decayed (B o e^{la_L -
// la_s})^T against X (passes 1 and 3) and C against the state H.  Each
// carries a float32 operand against an exact bfloat16 one; that operand is
// split into three bfloat16 terms, v1 = bf16(v), v2 = bf16(v - v1), v3 =
// bf16(v - v1 - v2), and the product runs once for each, so it keeps ~24
// bits (one term moves the float32 state past its 1e-4 limit; two hold the
// per-call limits but flip ten times as many bfloat16 outputs as float32
// summation order does: `tests/test_torch_mamba2_chunks.py`).  Each product
// lands in a fresh accumulator and is added in float32, because the tensor
// cores' accumulation is not rounded to nearest and the state, carried over
// every chunk, would collect its bias.  The Gram and (G o decay) X run on
// float32 FMA in order over n and over s: at zamba2-2.7b's decay (about
// -0.8 a token) every output is set by a few near-diagonal terms, and a
// tensor-core sum of them, as accurate as the plain version against float64
// but rounded otherwise, flipped 3-9 times as many bfloat16 outputs against
// it, which the model's 54 layers amplified past the smoke's forward limits
// (PERF.md, section 6).
//
// float32 ("simt"): the same three passes on float32 FMA from shared memory
// (no TF32), one CTA per (32 state columns, span, head, batch), five phases a
// chunk (stage, cumsum, Gram or its read from the buffer, outputs, state
// update).
//
// Layout: x, y (B, T, H, P); a (B, T, H); b, c (B, T, G, N); each read or
// written through its own batch, time and head (for b and c: group) strides
// (the last dim of x, y, b and c is contiguous); h0 and h_T (B, H, N, P)
// float32, contiguous, h0 may be null (zeros); the span states (B, H, NS, N,
// P), decays (B, H, NS) and, where a group holds several heads, Grams (B, G,
// cdiv(T, 64), 64, 64) float32 scratch.
#include <cstdint>

#include "common.cuh"
#include "state_pass.cuh"

namespace {

using hasco::from_f32;
using hasco::to_f32;

constexpr int L = 64;  // chunk length
constexpr int MAX_N = 128;

struct Strides {
  long long b, t, h;
};

// a lane's two steps of a chunk's log-decay a (rows past tn: 0)
template <typename T>
__device__ __forceinline__ float2 chunk_a(const T* ab, long long ts, int tn, int lane) {
  return make_float2(2 * lane < tn ? to_f32(ab[(long long)(2 * lane) * ts]) : 0.f,
                     2 * lane + 1 < tn ? to_f32(ab[(long long)(2 * lane + 1) * ts]) : 0.f);
}

// warp 0: inclusive cumsum of a over the chunk (two steps a lane), and the
// decays e^{la_t} (EA) and e^{la_L - la_s} (ED)
__device__ __forceinline__ void chunk_decay(float2 av, float* LA, float* EA, float* ED,
                                            int lane) {
  const float a0 = av.x, a1 = av.y;
  float run = a0 + a1;
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  const float before = run - (a0 + a1);
  const float la0 = before + a0, la1 = run;
  const float last = __shfl_sync(0xffffffffu, run, 31);
  LA[2 * lane] = la0;
  LA[2 * lane + 1] = la1;
  EA[2 * lane] = expf(fminf(la0, 0.f));
  EA[2 * lane + 1] = expf(fminf(la1, 0.f));
  ED[2 * lane] = expf(fminf(last - la0, 0.f));
  ED[2 * lane + 1] = expf(fminf(last - la1, 0.f));
}

// g = a thread's 4 x 4 block of the chunk's Gram C B^T (rows 4 ty + i,
// columns tx + 16 j) from c and b in shared memory (row stride ld), on
// float32 FMA in order over n, as a sequential float32 product sums it
template <typename E>
__device__ __forceinline__ void gram_4x4(const E* Cs, const E* Bs, int ld, int N, int tx, int ty,
                                         float (&g)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = to_f32(Cs[(4 * ty + i) * ld + n]);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = to_f32(Bs[(tx + 16 * j) * ld + n]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
  }
}

// ---- the float32 route: SIMT FMA -------------------------------------------

namespace simt {

constexpr int THREADS = 256;
constexpr int PS = 32;  // columns of h (and of x, y) per CTA
constexpr int WARPS = THREADS / 32;

// OUT = false: pass 1 (the span's local state from 0, and its decay);
// OUT = true: pass 3 (outputs, from the state entering the span)
template <typename T, bool OUT>
__global__ void __launch_bounds__(THREADS)
mamba2_simt_kernel(const T* __restrict__ x, const T* __restrict__ a,
                   const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ S,
                   float* __restrict__ dec, float* __restrict__ gram, T* __restrict__ y, int Tlen,
                   int H, int P, int N, int hpg, int span_chunks, int p_blocks, Strides xs,
                   Strides as, Strides bs, Strides cs, Strides ys) {
  extern __shared__ float smem[];
  const int ld = N + 1;            // odd row stride: rows of a column hit distinct banks
  float* Xs = smem;                // L x PS   x columns of this CTA
  float* Bs = Xs + L * PS;         // L x ld   b
  float* Cs = Bs + L * ld;         // L x ld   c
  float* G = Cs + L * ld;          // L x (L + 1) decayed Gram matrix
  float* Hs = G + L * (L + 1);     // N x PS   state columns of this CTA
  float* LA = Hs + N * PS;         // L        inclusive cumsum of a
  float* EA = LA + L;              // L        e^{la_t}
  float* ED = EA + L;              // L        e^{la_L - la_s}

  const int pb = blockIdx.x % p_blocks, span = blockIdx.x / p_blocks;
  const int NS = gridDim.x / p_blocks;
  const int p0 = pb * PS, h = blockIdx.y, b = blockIdx.z, grp = h / hpg;
  const int pn = min(PS, P - p0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nc = (int)hasco::cdiv(Tlen, L);
  const int c0 = span * span_chunks, c1 = min(c0 + span_chunks, nc);
  float* Sj = S + (((long long)b * H + h) * NS + span) * N * P + p0;
  // who computes the Gram: pass 3 itself without a Gram buffer; with one
  // (b and c shared by a group's heads), pass 1's CTA of the group's first
  // head and first column block
  const bool make_gram = OUT ? gram == nullptr : gram != nullptr && h % hpg == 0 && pb == 0;

  for (int i = tid; i < N * PS; i += THREADS) {
    const int n = i / PS, p = i - n * PS;
    Hs[i] = (OUT && p < pn) ? Sj[(long long)n * P + p] : 0.f;
  }

  const T* xb = x + (long long)b * xs.b + (long long)h * xs.h + p0;
  const T* ab = a + (long long)b * as.b + (long long)h * as.h;
  const T* bb = bm + (long long)b * bs.b + (long long)grp * bs.h;
  const T* cb = cm + (long long)b * cs.b + (long long)grp * cs.h;
  T* yb = y + (long long)b * ys.b + (long long)h * ys.h + p0;

  float decay = 1.f;
  for (int c = c0; c < c1; ++c) {
    const int t0 = c * L, tn = min(L, Tlen - t0);
    // 1. stage the chunk; rows past T are zero (a = 0: no decay)
    for (int i = tid; i < L * PS; i += THREADS) {
      const int t = i / PS, p = i - t * PS;
      Xs[i] = (t < tn && p < pn) ? to_f32(xb[(long long)(t0 + t) * xs.t + p]) : 0.f;
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int t = i / N, n = i - t * N;
      const bool in = t < tn;
      const long long tt = t0 + t;
      Bs[t * ld + n] = in ? to_f32(bb[tt * bs.t + n]) : 0.f;
      if (OUT || make_gram) Cs[t * ld + n] = in ? to_f32(cb[tt * cs.t + n]) : 0.f;
    }
    // 2. the decays, by warp 0
    if (warp == 0)
      chunk_decay(chunk_a(ab + (long long)t0 * as.t, as.t, tn, lane), LA, EA, ED, lane);
    __syncthreads();

    if (OUT || make_gram) {
      // 3. the Gram c_t . b_s (computed, or read from pass 1's buffer), into
      //    G[t][s] = (c_t . b_s) e^{la_t - la_s} for s <= t, else 0 (pass 3)
      //    or the buffer (pass 1); each thread a 4 x 4 block: rows 4 ty ..
      //    4 ty + 3, columns tx + 16 j
      float* gc = gram == nullptr ? nullptr
                                  : gram + (((long long)b * (H / hpg) + grp) * nc + c) * L * L;
      const int tx = tid % 16, ty = tid / 16;
      float g[4][4];
      if (make_gram) {
        gram_4x4<float>(Cs, Bs, ld, N, tx, ty, g);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = gc[(4 * ty + i) * L + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * ty + i, s = tx + 16 * j;
          if (OUT)
            G[t * (L + 1) + s] = s <= t ? g[i][j] * expf(fminf(LA[t] - LA[s], 0.f)) : 0.f;
          else
            gc[t * L + s] = g[i][j];
        }
    }

    if (OUT) {
      __syncthreads();

      // 4. outputs: column p = lane, rows warp, warp + 8, ...
      for (int t = warp; t < L; t += WARPS) {
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc = fmaf(Cs[t * ld + n], Hs[n * PS + lane], acc);
        acc *= EA[t];
        for (int s = 0; s <= t; ++s) acc = fmaf(G[t * (L + 1) + s], Xs[s * PS + lane], acc);
        if (t < tn && lane < pn) yb[(long long)(t0 + t) * ys.t + lane] = from_f32<T>(acc);
      }
      __syncthreads();  // every read of h is done before it is updated
    }

    // 5. state update (pass 3 skips it after the span's last chunk): column
    //    p = lane, rows n = warp, warp + 8, ...
    if (!OUT || c + 1 < c1) {
      const float eL = EA[L - 1];
      for (int n = warp; n < N; n += WARPS) {
        float acc = eL * Hs[n * PS + lane];
        for (int s = 0; s < L; ++s) acc = fmaf(Bs[s * ld + n] * ED[s], Xs[s * PS + lane], acc);
        Hs[n * PS + lane] = acc;
      }
    }
    decay *= EA[L - 1];
    __syncthreads();  // Bs, Xs and EA are read before the next chunk restages them
  }

  if (!OUT) {
    for (int i = tid; i < N * PS; i += THREADS) {
      const int n = i / PS, p = i - n * PS;
      if (p < pn) Sj[(long long)n * P + p] = Hs[i];
    }
    if (tid == 0 && pb == 0) dec[((long long)b * H + h) * NS + span] = decay;
  }
}

template <typename T, bool OUT>
int launch(const void* x, const void* a, const void* b, const void* c, float* S, float* dec,
           float* gram, void* y, int B, int Tlen, int H, int P, int N, int hpg, int span_chunks,
           int NS, const Strides* st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)L * PS + 2 * (size_t)L * (N + 1) +
                                       L * (L + 1) + (size_t)N * PS + 3 * L);
  auto kern = mamba2_simt_kernel<T, OUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int p_blocks = (int)hasco::cdiv(P, PS);
  const dim3 grid((unsigned)(NS * p_blocks), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), S, dec, gram, static_cast<T*>(y), Tlen, H, P, N, hpg,
      span_chunks, p_blocks, st[0], st[1], st[2], st[3], st[4]);
  return (int)cudaGetLastError();
}

static_assert(L == 64 && PS == 32 && THREADS == 16 * 16,
              "the cumsum takes two steps a lane, a lane owns a column, a thread 4 x 4 of G");

}  // namespace simt

// ---- the bfloat16 route: mma.sync tensor cores ----------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using hasco::ldsm_x4_t;
using hasco::mma_add;
using hasco::split_bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int PB = 64;        // columns of x, y and h per CTA
constexpr int XLD = PB + 8;   // bf16 row stride of x: +16 bytes, ldmatrix rows hit distinct banks
constexpr int HLD = PB + 4;   // float row stride of h: a fragment's reads hit distinct banks
constexpr int GLD = L + 4;    // float row strides of the Gram and its decayed copy (16-byte rows)
// terms of each float32 operand on the tensor cores: three keep ~24 bits
// (two, ~16 bits, hold the per-call limits but flip ten times as many
// bfloat16 outputs as float32 summation order does)
constexpr int TERMS = 3;

template <int NP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (2 * (size_t)L * (NP + 8) + 2 * (size_t)L * XLD) +
         sizeof(float) * ((size_t)NP * HLD + 2 * (size_t)L * GLD + 3 * L);
}

// CTAs an SM: two at N <= 64 (88 KB of shared memory each) where the state
// of at most two heads leaves them 128 registers a thread, else one
constexpr int min_ctas(int np, int hg) { return np == 64 && hg <= 2 ? 2 : 1; }

// rows x COLS bf16 from global (row stride rs; rows >= rn and columns >= cn
// zero) into shared memory with row stride lds, an element a load
template <int COLS>
__device__ __forceinline__ void stage(bf16* dst, int lds, const bf16* src, long long rs, int rn,
                                      int cn) {
  for (int i = threadIdx.x; i < L * COLS; i += THREADS) {
    const int r = i / COLS, col = i % COLS;
    dst[r * lds + col] = (r < rn && col < cn) ? src[r * rs + col] : __ushort_as_bfloat16(0);
  }
}

// the same by cp.async, 16 bytes a copy (zero-filled past rn and cn): the
// source rows 16-byte aligned and cn a multiple of 8
template <int COLS>
__device__ __forceinline__ void stage_async(bf16* dst, int lds, const bf16* src, long long rs,
                                            int rn, int cn) {
  constexpr int CH = COLS / 8;
  for (int i = threadIdx.x; i < L * CH; i += THREADS) {
    const int r = i / CH, col = (i % CH) * 8;
    const bool ok = r < rn && col < cn;
    hasco::cp_async16(dst + r * lds + col, ok ? src + r * rs + col : src, ok);
  }
}

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

// Fragment layouts: common.cuh.  Warp (rt, ch) owns rows 16 rt .. 16 rt + 15
// of each 64-row block of the state (rows n) and its columns 32 ch .. 32 ch +
// 31: 4 accumulators of 8 columns (y's rows go otherwise, below).  hs[i][r][j]:
// head h0 + i, state rows 64 r + 16 rt + (g | g + 8), columns 32 ch + 8 j +
// 2 t (+1).  OUT = false: pass 1; OUT = true: pass 3.
template <int NP, int HG, bool OUT>
__global__ void __launch_bounds__(THREADS, min_ctas(NP, HG))
mamba2_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                 const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                 float* __restrict__ S, float* __restrict__ dec, float* __restrict__ gram,
                 bf16* __restrict__ y, int Tlen, int H, int P, int N, int hpg,
                 int span_chunks, int p_blocks, Strides xs, Strides as, Strides bs, Strides cs,
                 Strides ys, int vec_x, int vec_bc) {
  constexpr int BLD = NP + 8, RT = NP / 64, KN = NP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // L x BLD   c of the chunk
  bf16* Bs = Cs + L * BLD;                       // L x BLD   b of the chunk
  bf16* Xbuf = Bs + L * BLD;                     // 2 x L x XLD   one head's x, the next's
  float* Hf = reinterpret_cast<float*>(Xbuf + 2 * L * XLD);  // NP x HLD  h entering the chunk
  float* G = Hf + NP * HLD;                      // L x GLD   C B^T (made or read)
  float* M = G + L * GLD;                        // L x GLD   one head's G o decay
  float* LA = M + L * GLD;                       // L  inclusive cumsum of a
  float* EA = LA + L;                            // L  e^{la_t}
  float* ED = EA + L;                            // L  e^{la_L - la_s}

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int rt = warp & 3, ch = warp >> 2;
  const int pb = blockIdx.x % p_blocks, span = blockIdx.x / p_blocks;
  const int NS = gridDim.x / p_blocks;
  const int p0 = pb * PB, pn = min(PB, P - p0);
  // the CTA's HG heads are of one group (hpg % HG == 0, or one group)
  const int h0 = blockIdx.y * HG, b = blockIdx.z, grp = h0 / hpg;
  const int nc = (int)hasco::cdiv(Tlen, L);
  const int c0 = span * span_chunks, c1 = min(c0 + span_chunks, nc);
  // who computes the Gram: pass 3 itself without a Gram buffer; with one (b
  // and c shared by a group's heads, always so at HG 2, whose two heads are
  // of one group), pass 1's CTA of the group's first head and first column
  // block, once a chunk, and pass 3 reads it
  const bool make_gram =
      OUT ? HG == 1 && gram == nullptr : gram != nullptr && h0 % hpg == 0 && pb == 0;
  // the heads' group and the chunk index of its first Gram, kept in shared
  // memory and read where used: kept in registers across the chunks (a
  // division's results, which the compiler does not recompute) they spill
  // pass 3, which has 128 a thread (two CTAs an SM).  Thread 0 writes them
  // before the first barrier.
  __shared__ int grp_s, gram_chunk0;
  if (tid == 0) {
    grp_s = grp;
    gram_chunk0 = (b * (H / hpg) + grp) * nc;
  }
  __syncthreads();
  // this lane's ldmatrix offset into x, a [k][n] tile read transposed as B
  const int kn_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * XLD + ((lane >> 4) << 3);

  float hs[HG][RT][4][4];
#pragma unroll
  for (int i = 0; i < HG; ++i) {
    const float* Sj = S + (((long long)b * H + h0 + i) * NS + span) * N * P + p0;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * r + 16 * rt + g + (e >> 1) * 8;
          const int p = 32 * ch + 8 * j + 2 * t + (e & 1);
          hs[i][r][j][e] =
              (OUT && h0 + i < H && n < N && p < pn) ? Sj[(long long)n * P + p] : 0.f;
        }
  }
  float dprod[HG];
#pragma unroll
  for (int i = 0; i < HG; ++i) dprod[i] = 1.f;


  // x and a of head hh at chunk c; the next head and chunk's load while
  // this one computes (x by cp.async into the other buffer where x is
  // 16-byte aligned, a into warp 0's registers)
  const auto x_at = [&](int c, int hh) {
    return x + (long long)b * xs.b + (long long)hh * xs.h + (long long)c * L * xs.t + p0;
  };
  const auto a_at = [&](int c, int hh) {
    return chunk_a(a + (long long)b * as.b + (long long)hh * as.h + (long long)c * L * as.t,
                   as.t, min(L, Tlen - c * L), lane);
  };
  int xb = 0;
  if (vec_x) stage_async<PB>(Xbuf, XLD, x_at(c0, h0), xs.t, min(L, Tlen - c0 * L), pn);
  hasco::cp_async_commit();
  float2 a_next = warp == 0 ? a_at(c0, h0) : make_float2(0.f, 0.f);

  for (int c = c0; c < c1; ++c) {
    const int t0 = c * L, tn = min(L, Tlen - t0);
    const bool last = c + 1 == c1;
    // the chunk's b, c (where used) and Gram (pass 3, from the buffer pass 1
    // wrote) in flight together
    const bf16 *bt = bm + (long long)b * bs.b + (long long)grp_s * bs.h + (long long)t0 * bs.t,
               *ct = cm + (long long)b * cs.b + (long long)grp_s * cs.h + (long long)t0 * cs.t;
    const bool need_c = OUT || make_gram;
    if (vec_bc) {
      stage_async<NP>(Bs, BLD, bt, bs.t, tn, N);
      if (need_c) stage_async<NP>(Cs, BLD, ct, cs.t, tn, N);
    } else {
      stage<NP>(Bs, BLD, bt, bs.t, tn, N);
      if (need_c) stage<NP>(Cs, BLD, ct, cs.t, tn, N);
    }
    float* gc = gram == nullptr ? nullptr : gram + ((long long)gram_chunk0 + c) * L * L;
    if (OUT && gc != nullptr)
#pragma unroll 1  // rolled: unrolled, it spilled the two-head pass 3
      for (int i = tid; i < L * L / 4; i += THREADS)
        hasco::cp_async16(G + (i / (L / 4)) * GLD + (i % (L / 4)) * 4, gc + 4 * i, true);
    hasco::cp_async_commit();
    hasco::cp_async_wait<0>();  // (with this chunk's first x, loaded meanwhile)
    if (make_gram) {
      // the chunk's Gram C B^T, on float32 FMA in order over n (a thread 4 x
      // 4: rows 4 ty + i, columns tx + 16 j)
      __syncthreads();
      const int tx = tid % 16, ty = tid / 16;
      float gg[4][4];
      gram_4x4<bf16>(Cs, Bs, BLD, N, tx, ty, gg);
      float* dst = OUT ? G : gc;
      const int ld = OUT ? GLD : L;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[(4 * ty + i) * ld + tx + 16 * j] = gg[i][j];
    }

#pragma unroll
    for (int i = 0; i < HG; ++i) {
      const int hh = h0 + i;
      if (hh >= H) break;  // uniform over the CTA
      bf16* Xs = Xbuf + xb * L * XLD;
      const bool next_head = i + 1 < HG && hh + 1 < H;
      const int cn = next_head ? c : c + 1, hn = next_head ? hh + 1 : h0;
      if (vec_x) {
        if (cn < c1)
          stage_async<PB>(Xbuf + (xb ^ 1) * L * XLD, XLD, x_at(cn, hn), xs.t,
                          min(L, Tlen - cn * L), pn);
        hasco::cp_async_commit();
        hasco::cp_async_wait<1>();  // this head's x has landed
      } else {
        stage<PB>(Xs, XLD, x_at(c, hh), xs.t, tn, pn);
      }
      if (warp == 0) {
        const float2 av = a_next;
        if (cn < c1) a_next = a_at(cn, hn);
        chunk_decay(av, LA, EA, ED, lane);
      }
      if (OUT) {  // the state entering the chunk, for C H
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; e += 2)
              *reinterpret_cast<float2*>(Hf + (64 * r + 16 * rt + g + (e >> 1) * 8) * HLD +
                                         32 * ch + 8 * j + 2 * t) =
                  make_float2(hs[i][r][j][e], hs[i][r][j][e + 1]);
      }
      __syncthreads();

      if (OUT) {
        // this head's G o decay: s <= t, every exponent clamped <= 0
        for (int idx = tid; idx < L * L; idx += THREADS) {
          const int tt = idx / L, ss = idx % L;
          M[tt * GLD + ss] =
              ss <= tt ? G[tt * GLD + ss] * expf(fminf(LA[tt] - LA[ss], 0.f)) : 0.f;
        }
        // y: warp (pr, qc) owns row tiles pr and 3 - pr (one short and one
        // long causal row each, so every warp sums as many terms) and columns
        // 16 qc .. 16 qc + 15: yacc[u][j], row tile u, columns 16 qc + 8 j
        const int pr = warp & 1, qc = warp >> 1;
        float yacc[2][2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            yacc[u][j][0] = yacc[u][j][1] = yacc[u][j][2] = yacc[u][j][3] = 0.f;
        // C H on the tensor cores, H in TERMS bfloat16 terms built from the
        // float32 state
#pragma unroll 1  // rolled: unrolled, its loads hoisted past 128 registers
        for (int kk = 0; kk < KN; ++kk) {
          unsigned b0[2][TERMS], b1[2][TERMS];  // H: k 16 kk + 2 t (+8), column g
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float* hp = Hf + (16 * kk + 2 * t) * HLD + 16 * qc + 8 * j + g;
            split_bf16(hp[0], hp[HLD], b0[j]);
            split_bf16(hp[8 * HLD], hp[9 * HLD], b1[j]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int row0 = 16 * (u == 0 ? pr : 3 - pr) + g;
            unsigned af[4];  // c: rows row0 (+8), columns 16 kk + 2 t (+8)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              af[q] = *reinterpret_cast<const unsigned*>(
                  Cs + (row0 + (q & 1) * 8) * BLD + 16 * kk + 2 * t + (q >> 1) * 8);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int q = TERMS - 1; q >= 0; --q) mma_add(yacc[u][j], af, b0[j][q], b1[j][q]);
          }
        }
        __syncthreads();  // M is complete
        bf16* yb = y + (long long)b * ys.b + (long long)hh * ys.h + (long long)t0 * ys.t + p0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int rtu = u == 0 ? pr : 3 - pr, row0 = 16 * rtu + g;
          const float ea0 = EA[row0], ea1 = EA[row0 + 8];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            yacc[u][j][0] *= ea0, yacc[u][j][1] *= ea0;
            yacc[u][j][2] *= ea1, yacc[u][j][3] *= ea1;
          }
          // + (G o decay) X on float32 FMA, in order over s, as a sequential
          // float32 product sums it
          for (int ss = 0; ss < 16 * (rtu + 1); ++ss) {
            const float m0 = M[row0 * GLD + ss], m1 = M[(row0 + 8) * GLD + ss];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  Xs + ss * XLD + 16 * qc + 8 * j + 2 * t));
              yacc[u][j][0] = fmaf(m0, xv.x, yacc[u][j][0]);
              yacc[u][j][1] = fmaf(m0, xv.y, yacc[u][j][1]);
              yacc[u][j][2] = fmaf(m1, xv.x, yacc[u][j][2]);
              yacc[u][j][3] = fmaf(m1, xv.y, yacc[u][j][3]);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int row = row0 + (e >> 1) * 8;
            if (row >= tn) continue;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int p = 16 * qc + 8 * j + 2 * t;
              bf16* dst = yb + (long long)row * ys.t + p;
              if (p + 1 < pn && ((uintptr_t)dst & 3u) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(dst) =
                    __floats2bfloat162_rn(yacc[u][j][e], yacc[u][j][e + 1]);
              } else {
                if (p < pn) dst[0] = __float2bfloat16(yacc[u][j][e]);
                if (p + 1 < pn) dst[1] = __float2bfloat16(yacc[u][j][e + 1]);
              }
            }
          }
        }
      }

      if (!OUT || !last) {
        // h = e^{la_L} h + B_d^T X on the tensor cores (pass 3 skips it after
        // the span's last chunk): B_d = b_s e^{la_L - la_s} in TERMS bfloat16
        // terms, built as A fragments (rows n, k = s) straight from b; each
        // product joins h in float32 (mma_add)
        const float eL = EA[L - 1];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int n0 = 64 * r + 16 * rt + g;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) hs[i][r][j][e] *= eL;
#pragma unroll 1  // rolled, as C H's
          for (int kk = 0; kk < L / 16; ++kk) {
            unsigned ad[4][TERMS];  // A reg q: row n0 (+8 if q odd), k 2 t (+8 if q > 1)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int s = 16 * kk + 2 * t + (q >> 1) * 8, n = n0 + (q & 1) * 8;
              split_bf16(bf(Bs + s * BLD + n) * ED[s], bf(Bs + (s + 1) * BLD + n) * ED[s + 1],
                         ad[q]);
            }
#pragma unroll
            for (int dp = 0; dp < 2; ++dp) {
              unsigned bx[4];
              ldsm_x4_t(bx, Xs + kk * 16 * XLD + kn_off + 32 * ch + 16 * dp);
#pragma unroll
              for (int q = TERMS - 1; q >= 0; --q) {
                const unsigned aq[4] = {ad[0][q], ad[1][q], ad[2][q], ad[3][q]};
                mma_add(hs[i][r][2 * dp], aq, bx[0], bx[1]);
                mma_add(hs[i][r][2 * dp + 1], aq, bx[2], bx[3]);
              }
            }
          }
        }
      }
      dprod[i] *= EA[L - 1];
      xb ^= 1;
      __syncthreads();  // before the next head restages X, the decays and H
    }
  }

  if (!OUT) {
#pragma unroll
    for (int i = 0; i < HG; ++i) {
      if (h0 + i >= H) break;
      float* Sj = S + (((long long)b * H + h0 + i) * NS + span) * N * P + p0;
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 64 * r + 16 * rt + g + (e >> 1) * 8;
            const int p = 32 * ch + 8 * j + 2 * t + (e & 1);
            if (n < N && p < pn) Sj[(long long)n * P + p] = hs[i][r][j][e];
          }
      if (tid == 0 && pb == 0) dec[((long long)b * H + h0 + i) * NS + span] = dprod[i];
    }
  }
}

template <int NP, int HG, bool OUT>
int launch(const void* x, const void* a, const void* b, const void* c, float* S, float* dec,
           float* gram, void* y, int B, int Tlen, int H, int P, int N, int hpg, int span_chunks,
           int NS, const Strides* st, int vec_x, int vec_bc, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NP>();
  auto kern = mamba2_tc_kernel<NP, HG, OUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int p_blocks = (int)hasco::cdiv(P, PB);
  const dim3 grid((unsigned)(NS * p_blocks), (unsigned)hasco::cdiv(H, HG), (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), S, dec, gram, static_cast<bf16*>(y), Tlen, H, P, N, hpg,
      span_chunks, p_blocks, st[0], st[1], st[2], st[3], st[4], vec_x, vec_bc);
  return (int)cudaGetLastError();
}

}  // namespace tc

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// strides: {batch, time, head} in elements for x, a and y, {batch, time,
// group} for b and c, in the order x, a, b, c, y (15 values).  Head h reads
// group h / heads_per_group of b and c (heads_per_group divides H; H itself
// for one group, whose stride is then never read).  S and dec: the span
// states (B, H, NS, N, P) and decays (B, H, NS), NS = cdiv(cdiv(T, 64),
// span_chunks).  gram: null, or where a group holds several heads the
// chunks' Grams (B, H / heads_per_group, cdiv(T, 64), 64, 64) float32
// scratch, computed once a group and chunk by pass 1 and read by pass 3.
// heads_per_cta 2 only with the Grams (the bfloat16 route) and where the two
// heads of a CTA are of one group, else 1.  Returns a CUDA error code.
extern "C" int hasco_mamba2(const void* x, const void* a, const void* b, const void* c,
                            const float* h0, void* y, float* hT, float* S, float* dec,
                            float* gram, int B, int Tlen, int H, int P, int N,
                            int heads_per_group, const long long* strides, int span_chunks,
                            int heads_per_cta, int dtype, void* stream) {
  const int hpg = heads_per_group;
  if (B < 1 || Tlen < 1 || H < 1 || P < 1 || N < 1 || N > MAX_N || span_chunks < 1 ||
      hpg < 1 || H % hpg != 0)
    return (int)cudaErrorInvalidValue;
  Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int HG = heads_per_cta;
  const bool shared = hpg > 1;
  if ((HG != 1 && (gram == nullptr || dtype != hasco::kBFloat16 ||
                   (hpg % HG != 0 && hpg != H))) ||
      (gram != nullptr && !shared))
    return (int)cudaErrorInvalidValue;
  const int NS = (int)hasco::cdiv(hasco::cdiv(Tlen, L), span_chunks);
  auto s = static_cast<cudaStream_t>(stream);
  for (int pass = 1; pass <= 3; ++pass) {
    int rc = 0;
    if (pass == 2) {
      rc = hasco::state_pass(S, dec, h0, hT, (long long)B * H, NS, (long long)N * P, 1, s);
    } else if (dtype == hasco::kFloat32) {
      if (HG != 1) return (int)cudaErrorInvalidValue;
      rc = pass == 3 ? simt::launch<float, true>(x, a, b, c, S, dec, gram, y, B, Tlen, H, P,
                                                 N, hpg, span_chunks, NS, st, s)
                     : simt::launch<float, false>(x, a, b, c, S, dec, gram, y, B, Tlen, H, P,
                                                  N, hpg, span_chunks, NS, st, s);
    } else if (dtype == hasco::kBFloat16) {
      const auto al8 = [](const Strides& z) {
        return z.b % 8 == 0 && z.t % 8 == 0 && z.h % 8 == 0;
      };
      const int vec_x = aligned16(x) && al8(st[0]) && P % 8 == 0;
      const int vec_bc = aligned16(b) && aligned16(c) && al8(st[2]) && al8(st[3]) && N % 8 == 0;
      // pass 1 one head a CTA (its Gram, where it makes one, is shared by
      // the buffer), pass 3 HG
#define HASCO_TC(NP, G, OUT)                                                                 \
  tc::launch<NP, G, OUT>(x, a, b, c, S, dec, gram, y, B, Tlen, H, P, N, hpg, span_chunks, NS, \
                         st, vec_x, vec_bc, s)
      if (pass == 1 && N <= 64)
        rc = HASCO_TC(64, 1, false);
      else if (pass == 1)
        rc = HASCO_TC(128, 1, false);
      else if (N <= 64 && HG == 1)
        rc = HASCO_TC(64, 1, true);
      else if (N <= 64 && HG == 2)
        rc = HASCO_TC(64, 2, true);
      else if (HG == 1)
        rc = HASCO_TC(128, 1, true);
      else if (HG == 2)
        rc = HASCO_TC(128, 2, true);
#undef HASCO_TC
      else
        return (int)cudaErrorInvalidValue;
    } else {
      return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  return 0;
}
