// RWKV-6 (Finch) WKV recurrence, chunked: for each (batch, head) the state
// S (Dk x Dv, float32) is carried across chunks of L = 16 tokens, and
// within a chunk (lw = inclusive cumsum of the log-decay w, aq = exclusive,
// both restarting at every chunk):
//
//   o_t  = sum_d r_td e^{aq_td} S[d]                                (carried state)
//        + sum_{s<t} (sum_d r_td k_sd e^{aq_td - lw_sd}) v_s          (pairwise decay)
//        + (sum_d r_td u_d k_td) v_t                                  (diag(u) bonus)
//   S'[d] = e^{lw_Ld} S[d] + sum_s k_sd e^{lw_Ld - lw_sd} v_s         (state update)
//
// Replaces the Pallas TPU kernel `repro/kernels/rwkv6.py::rwkv6` (the same
// formula, its lines 10-13, and its chunk of 16).  Every exponent is <= 0
// for w <= 0 and is clamped there (expf(fminf(x, 0))), so nothing
// overflows however strong the decay.  A sequence of any length T >= 1 is
// taken: the last chunk is masked (r = k = v = 0 and w = 0 past T, which
// adds nothing and leaves S as it was).
//
// Bound on the H100: bytes.  Each token reads r, k, w (Dk each) and v and
// writes o (Dv each), against ~4 Dk Dv + L Dk operations, so the whole
// call is ~30 operations a byte in bfloat16, below the card's ridge.  But
// the recurrence is sequential over chunks: a Pallas grid axis marked
// "arbitrary" carried S in VMEM; here one CTA owns S and loops over the
// chunks itself.  At batch 1 there are only B*H recurrences (40 for
// rwkv6-3b) for 132 SMs, so the CTA owns only 16 columns of S (S[:, j]
// evolves from v[:, j] alone): B*H*Dv/16 CTAs (160 for rwkv6-3b), each
// recomputing the small (L, L) score block of its head.  What bounds this
// simple kernel is the latency of each chunk's five dependent phases
// (load, cumsum, scores, outputs, state update, with a barrier after
// each), not bandwidth; overlapping the next chunk's loads with the
// current chunk's work, and tensor cores for the products, are later work.
//
// Layout: r, k, w (B, T, H, Dk); v, out (B, T, H, Dv), each read or
// written through its own batch, time and head strides (the last dim is
// contiguous); u (H, Dk) float32; S0 and S_T (B, H, Dk, Dv) float32,
// contiguous, S0 may be null (zeros).
#include "common.cuh"

namespace {

using hasco::from_f32;
using hasco::to_f32;

constexpr int THREADS = 256;
constexpr int L = 16;    // chunk length; THREADS == L * L: one thread per score
constexpr int JS = 16;   // columns of S (and of v, o) per CTA
constexpr int MAX_DK = 128;

struct Strides {
  long long b, t, h;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ w, const float* __restrict__ u,
             const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ sT,
             int Tlen, int H, int Dk, int Dv, Strides rs, Strides ks, Strides vs, Strides ws,
             Strides os) {
  extern __shared__ float smem[];
  const int ld = Dk + 1;           // odd row stride: rows of a column hit distinct banks
  float* Rs = smem;                // L x ld   r
  float* Ks = Rs + L * ld;         // L x ld   k
  float* LW = Ks + L * ld;         // L x ld   w, then its inclusive cumsum lw
  float* AQ = LW + L * ld;         // L x ld   exclusive cumsum aq
  float* RQ = AQ + L * ld;         // L x ld   r e^{aq}
  float* KD = RQ + L * ld;         // L x ld   k e^{lw_L - lw}
  float* Vs = KD + L * ld;         // L x JS   v columns of this CTA
  float* A = Vs + L * JS;          // L x (L + 1) scores, bonus on the diagonal
  float* S = A + L * (L + 1);      // Dk x JS  state columns of this CTA
  float* Us = S + Dk * JS;         // Dk       u of this head
  float* DL = Us + Dk;             // Dk       e^{lw_L}

  const int j0 = blockIdx.x * JS, h = blockIdx.y, b = blockIdx.z;
  const int jn = min(JS, Dv - j0);
  const int tid = threadIdx.x;

  for (int i = tid; i < Dk * JS; i += THREADS) {
    const int d = i / JS, j = i - d * JS;
    S[i] = (s0 != nullptr && j < jn)
               ? s0[(((long long)b * H + h) * Dk + d) * Dv + j0 + j] : 0.f;
  }
  for (int d = tid; d < Dk; d += THREADS) Us[d] = u[(long long)h * Dk + d];

  const T* rb = r + (long long)b * rs.b + (long long)h * rs.h;
  const T* kb = k + (long long)b * ks.b + (long long)h * ks.h;
  const T* wb = w + (long long)b * ws.b + (long long)h * ws.h;
  const T* vb = v + (long long)b * vs.b + (long long)h * vs.h + j0;
  T* ob = out + (long long)b * os.b + (long long)h * os.h + j0;

  for (int t0 = 0; t0 < Tlen; t0 += L) {
    const int tn = min(L, Tlen - t0);
    // 1. stage the chunk; rows past T are zero (w = 0: no decay)
    for (int i = tid; i < L * Dk; i += THREADS) {
      const int t = i / Dk, d = i - t * Dk;
      const bool in = t < tn;
      const long long tt = t0 + t;
      Rs[t * ld + d] = in ? to_f32(rb[tt * rs.t + d]) : 0.f;
      Ks[t * ld + d] = in ? to_f32(kb[tt * ks.t + d]) : 0.f;
      LW[t * ld + d] = in ? to_f32(wb[tt * ws.t + d]) : 0.f;
    }
    {
      const int t = tid / JS, j = tid - t * JS;   // THREADS == L * JS
      Vs[tid] = (t < tn && j < jn) ? to_f32(vb[(long long)(t0 + t) * vs.t + j]) : 0.f;
    }
    __syncthreads();

    // 2. per channel: cumsum of the log-decay over the chunk
    for (int d = tid; d < Dk; d += THREADS) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        AQ[t * ld + d] = acc;
        acc += LW[t * ld + d];
        LW[t * ld + d] = acc;
      }
      DL[d] = expf(fminf(acc, 0.f));
    }
    __syncthreads();

    // 3. scores A[t][s] (one per thread), and r e^{aq}, k e^{lw_L - lw}
    {
      const int t = tid / L, s = tid - t * L;
      float acc = 0.f;
      if (s < t) {
        for (int d = 0; d < Dk; ++d)
          acc = fmaf(Rs[t * ld + d] * Ks[s * ld + d],
                     __expf(fminf(AQ[t * ld + d] - LW[s * ld + d], 0.f)), acc);
      } else if (s == t) {
        for (int d = 0; d < Dk; ++d) acc = fmaf(Rs[t * ld + d] * Us[d], Ks[t * ld + d], acc);
      }
      A[t * (L + 1) + s] = acc;
    }
    for (int i = tid; i < L * Dk; i += THREADS) {
      const int t = i / Dk, d = i - t * Dk;
      const float lwl = LW[(L - 1) * ld + d];
      RQ[t * ld + d] = Rs[t * ld + d] * expf(fminf(AQ[t * ld + d], 0.f));
      KD[t * ld + d] = Ks[t * ld + d] * expf(fminf(lwl - LW[t * ld + d], 0.f));
    }
    __syncthreads();

    // 4. outputs: one (t, j) per thread
    {
      const int t = tid / JS, j = tid - t * JS;
      float acc = 0.f;
      for (int d = 0; d < Dk; ++d) acc = fmaf(RQ[t * ld + d], S[d * JS + j], acc);
      for (int s = 0; s <= t; ++s) acc = fmaf(A[t * (L + 1) + s], Vs[s * JS + j], acc);
      if (t < tn && j < jn) ob[(long long)(t0 + t) * os.t + j] = from_f32<T>(acc);
    }
    __syncthreads();  // every read of S is done before it is updated

    // 5. state update
    for (int i = tid; i < Dk * JS; i += THREADS) {
      const int d = i / JS, j = i - d * JS;
      float acc = DL[d] * S[i];
      for (int s = 0; s < L; ++s) acc = fmaf(KD[s * ld + d], Vs[s * JS + j], acc);
      S[i] = acc;
    }
    __syncthreads();  // KD and Vs are read before the next chunk restages them
  }

  for (int i = tid; i < Dk * JS; i += THREADS) {
    const int d = i / JS, j = i - d * JS;
    if (j < jn) sT[(((long long)b * H + h) * Dk + d) * Dv + j0 + j] = S[i];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           const float* s0, void* out, float* sT, int B, int Tlen, int H, int Dk, int Dv,
           const Strides* st, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)6 * L * (Dk + 1) + L * JS + L * (L + 1) + (size_t)Dk * JS + 2 * Dk);
  auto kern = rwkv6_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)hasco::cdiv(Dv, JS), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, s0, static_cast<T*>(out), sT, Tlen, H, Dk, Dv, st[0], st[1],
      st[2], st[3], st[4]);
  return (int)cudaGetLastError();
}

static_assert(THREADS == L * L && THREADS == L * JS, "one thread per score and per output");

}  // namespace

// strides: {batch, time, head} in elements for r, k, v, w and out, in that
// order (15 values); the last dim of each is contiguous.  Returns a CUDA
// error code.
extern "C" int hasco_rwkv6(const void* r, const void* k, const void* v, const void* w,
                           const float* u, const float* s0, void* out, float* sT, int B,
                           int Tlen, int H, int Dk, int Dv, const long long* strides, int dtype,
                           void* stream) {
  if (B < 1 || Tlen < 1 || H < 1 || Dk < 1 || Dk > MAX_DK || Dv < 1)
    return (int)cudaErrorInvalidValue;
  Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    return launch<float>(r, k, v, w, u, s0, out, sT, B, Tlen, H, Dk, Dv, st, s);
  if (dtype == hasco::kBFloat16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, B, Tlen, H, Dk, Dv, st, s);
  return (int)cudaErrorInvalidValue;
}
