// Mamba-2 SSD recurrence, chunked: for each (batch, head) the state h
// (N x P, float32) is carried across chunks of L = 64 tokens, and within a
// chunk (la = inclusive cumsum of the per-head log-decay a, restarting at
// every chunk):
//
//   y_t  = e^{la_t} c_t . h  +  sum_{s<=t} e^{la_t - la_s} (c_t . b_s) x_s
//   h'   = e^{la_L} h  +  sum_s e^{la_L - la_s} b_s x_s^T
//
// Replaces the Pallas TPU kernel `repro/kernels/mamba2.py::mamba2` (the same
// formula, its lines 7-9, and its chunk of 64).  The intra-chunk diagonal is
// inclusive (y_t sees h after its own update), unlike rwkv6's strict one,
// and the (L, L) decay mask multiplies the C.B^T Gram matrix.  Every
// exponent is <= 0 for a <= 0 and is clamped there.  Any T >= 1 is taken:
// the last chunk is masked (x = 0, a = 0, b = c = 0 past T, which adds
// nothing and leaves h as it was).
//
// Bound on the H100: bytes.  Each token reads x (P), b and c (N each, which
// may be one row shared by every head: a stride of 0 over H is read in
// place, never materialised) and a, and writes y (P), against ~6 N P + L N
// operations per head.  As in rwkv6.cu, the sequential chunk loop, which a
// Pallas grid axis marked "arbitrary" carried in VMEM, runs inside one CTA
// that owns h; at batch 1 only B*H recurrences exist (80 for zamba2-2.7b),
// so a CTA owns 32 columns of h (h[:, p] evolves from x[:, p] alone) and
// recomputes its head's Gram block: B*H*P/32 CTAs (160 for zamba2-2.7b).
// Each chunk runs five dependent phases (load, cumsum, Gram, outputs, state
// update) on float32 FMA from shared memory; the Gram product is the same
// for every head when b and c are shared, which a later kernel can exploit,
// as it can tensor cores and overlapped loads.
//
// Layout: x, y (B, T, H, P); a (B, T, H); b, c (B, T, H, N); each read or
// written through its own batch, time and head strides (the last dim of x,
// y, b and c is contiguous); h0 and h_T (B, H, N, P) float32, contiguous, h0
// may be null (zeros).
#include "common.cuh"

namespace {

using hasco::from_f32;
using hasco::to_f32;

constexpr int THREADS = 256;
constexpr int L = 64;    // chunk length
constexpr int PS = 32;   // columns of h (and of x, y) per CTA
constexpr int MAX_N = 128;
constexpr int WARPS = THREADS / 32;

struct Strides {
  long long b, t, h;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
mamba2_kernel(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ bm,
              const T* __restrict__ cm, const float* __restrict__ h0, T* __restrict__ y,
              float* __restrict__ hT, int Tlen, int H, int P, int N, Strides xs, Strides as,
              Strides bs, Strides cs, Strides ys) {
  extern __shared__ float smem[];
  const int ld = N + 1;            // odd row stride: rows of a column hit distinct banks
  float* Xs = smem;                // L x PS   x columns of this CTA
  float* Bs = Xs + L * PS;         // L x ld   b
  float* Cs = Bs + L * ld;         // L x ld   c
  float* G = Cs + L * ld;          // L x (L + 1) decayed Gram matrix
  float* Hs = G + L * (L + 1);     // N x PS   state columns of this CTA
  float* LA = Hs + N * PS;         // L        a, then its inclusive cumsum
  float* EA = LA + L;              // L        e^{la_t}
  float* ED = EA + L;              // L        e^{la_L - la_s}

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int pn = min(PS, P - p0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < N * PS; i += THREADS) {
    const int n = i / PS, p = i - n * PS;
    Hs[i] = (h0 != nullptr && p < pn)
                ? h0[(((long long)b * H + h) * N + n) * P + p0 + p] : 0.f;
  }

  const T* xb = x + (long long)b * xs.b + (long long)h * xs.h + p0;
  const T* ab = a + (long long)b * as.b + (long long)h * as.h;
  const T* bb = bm + (long long)b * bs.b + (long long)h * bs.h;
  const T* cb = cm + (long long)b * cs.b + (long long)h * cs.h;
  T* yb = y + (long long)b * ys.b + (long long)h * ys.h + p0;

  for (int t0 = 0; t0 < Tlen; t0 += L) {
    const int tn = min(L, Tlen - t0);
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
      Cs[t * ld + n] = in ? to_f32(cb[tt * cs.t + n]) : 0.f;
    }
    for (int t = tid; t < L; t += THREADS)
      LA[t] = t < tn ? to_f32(ab[(long long)(t0 + t) * as.t]) : 0.f;
    __syncthreads();

    // 2. inclusive cumsum of a over the chunk, by warp 0 (two steps a lane)
    if (warp == 0) {
      const float a0 = LA[2 * lane], a1 = LA[2 * lane + 1];
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
    __syncthreads();

    // 3. G[t][s] = (c_t . b_s) e^{la_t - la_s} for s <= t, else 0; each
    //    thread a 4 x 4 block: rows 4 ty .. 4 ty + 3, columns tx + 16 j
    {
      const int tx = tid % 16, ty = tid / 16;
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(4 * ty + i) * ld + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * ld + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * ty + i, s = tx + 16 * j;
          G[t * (L + 1) + s] = s <= t ? g[i][j] * expf(fminf(LA[t] - LA[s], 0.f)) : 0.f;
        }
    }
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

    // 5. state update: column p = lane, rows n = warp, warp + 8, ...
    {
      const float dec = EA[L - 1];
      for (int n = warp; n < N; n += WARPS) {
        float acc = dec * Hs[n * PS + lane];
        for (int s = 0; s < L; ++s)
          acc = fmaf(Bs[s * ld + n] * ED[s], Xs[s * PS + lane], acc);
        Hs[n * PS + lane] = acc;
      }
    }
    __syncthreads();  // Bs and Xs are read before the next chunk restages them
  }

  for (int i = tid; i < N * PS; i += THREADS) {
    const int n = i / PS, p = i - n * PS;
    if (p < pn) hT[(((long long)b * H + h) * N + n) * P + p0 + p] = Hs[i];
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c, const float* h0,
           void* y, float* hT, int B, int Tlen, int H, int P, int N, const Strides* st,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)L * PS + 2 * (size_t)L * (N + 1) +
                                       L * (L + 1) + (size_t)N * PS + 3 * L);
  auto kern = mamba2_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)hasco::cdiv(P, PS), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), h0, static_cast<T*>(y), hT, Tlen, H, P, N, st[0], st[1], st[2],
      st[3], st[4]);
  return (int)cudaGetLastError();
}

static_assert(L == 64 && PS == 32 && THREADS == 16 * 16,
              "the cumsum takes two steps a lane, a lane owns a column, a thread 4 x 4 of G");

}  // namespace

// strides: {batch, time, head} in elements for x, a, b, c and y, in that
// order (15 values); b and c may have a head stride of 0.  Returns a CUDA
// error code.
extern "C" int hasco_mamba2(const void* x, const void* a, const void* b, const void* c,
                            const float* h0, void* y, float* hT, int B, int Tlen, int H, int P,
                            int N, const long long* strides, int dtype, void* stream) {
  if (B < 1 || Tlen < 1 || H < 1 || P < 1 || N < 1 || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    return launch<float>(x, a, b, c, h0, y, hT, B, Tlen, H, P, N, st, s);
  if (dtype == hasco::kBFloat16)
    return launch<__nv_bfloat16>(x, a, b, c, h0, y, hT, B, Tlen, H, P, N, st, s);
  return (int)cudaErrorInvalidValue;
}
