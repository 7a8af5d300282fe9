// The rwkv6 block's elementwise and row-norm work between its matrix
// products, fused into five kernels (six ops: the time mix's and the channel
// mix's prologues share one kernel):
//
//   1. time-mix prologue   rms_norm(x, ln1), the token shift, five mixes
//   2. decay               -exp(clamp(float(w0 + lora), -8, 6)) in the
//                          dtype the recurrence takes
//   3. head norm and gate  the per-head RMS norm of the WKV output times
//                          silu(xg @ wg)
//   4. channel-mix prologue  x + att, rms_norm(., ln2), the shift, two mixes
//   5. relu^2              of the channel mix's hidden layer
//   6. channel gate        x + sigmoid(xr @ wcr) * (hidden @ wcv)
//
// Replaces no Pallas kernel: the JAX package writes this glue as plain
// expressions (`src/repro/models/rwkv6.py:95-122` for the time mix,
// `:127-142` for the channel mix and the block) and leaves it to XLA's
// fusion.  Eager PyTorch ran each op as its own pass over the (B, T, D)
// activations, some 80 launches and 3.9 GB of HBM traffic a layer at
// rwkv6-3b's 1 x 4096 tokens; these kernels make 6 launches and move 0.57 GB.
//
// Bound on the H100: bytes, every one of them (a few operations an element,
// against the card's ~295 bf16 operations a byte).  Each kernel reads its
// inputs once and writes its outputs once, in 16-byte vectors (bfloat16 8
// elements, float32 4), and keeps every intermediate in registers.  Each
// kernel's note says how.  The vectors are the only route: the wrappers
// (`kernels/rwkv6_glue.py`) take rows of a multiple of 16 bytes at 16-byte
// aligned addresses, as every rwkv6 config's D, F and dh give, and refuse
// anything else.
//
// Rounding: the plain path's, in registers.  Every op of the plain versions
// (`kernels/rwkv6_glue.py`) rounds its result to the activations' dtype,
// and each kernel rounds at the same points: a mix is
// bf16(x + bf16(bf16(xp - x) * mu)), a norm is bf16(x * rsqrt(mean(x^2) +
// eps) * w) with the float32 products in the plain version's order, and
// silu, sigmoid and exp use the accurate float32 functions (expf, IEEE
// division) as PyTorch's kernels do.  The arithmetic goes through
// __fadd_rn/__fmul_rn so nvcc contracts nothing into an FMA that the plain
// version rounds in two steps.  So kernels 2, 5 and 6 give the plain
// version's bits, and kernels 1, 3 and 4 differ only where the two norms'
// float32 sums of squares (taken in another order) round a value to the
// other side of a bfloat16 boundary.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hasco::block_total;
using hasco::cdiv;
using hasco::from_f32;
using hasco::sm_count;
using hasco::to_f32;

constexpr float EPS = 1e-6f;  // models/layers.py::rms_norm's eps
constexpr int THREADS = 256;  // elementwise kernels' and head_out's block
// the prologue's block at most, and the CTAs of that size an SM must hold:
// at most 48 registers a thread, so that four CTAs of 320 threads fit
constexpr int MIX_THREADS = 640, MIX_MIN_CTAS = 2;

// elements of T in one 16-byte vector
template <typename T>
constexpr int VEC = 16 / sizeof(T);

// x rounded to T's precision, as a float
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<T>(x));
}

// one 16-byte vector of T, as stored (4 registers)
template <typename T>
struct alignas(16) Pack {
  T v[VEC<T>];
};

template <typename T>
__device__ __forceinline__ void ld(Pack<T>& r, const T* __restrict__ p) {
  *reinterpret_cast<uint4*>(&r) = __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void st(T* __restrict__ p, const Pack<T>& r) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
}

template <typename T>
__device__ __forceinline__ void zero(Pack<T>& r) {
#pragma unroll
  for (int i = 0; i < VEC<T>; ++i) r.v[i] = from_f32<T>(0.f);
}

// one vector of T from p, as floats
template <typename T>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[VEC<T>]) {
  Pack<T> r;
  ld(r, p);
#pragma unroll
  for (int i = 0; i < VEC<T>; ++i) v[i] = to_f32(r.v[i]);
}

// a vector of floats to p, each rounded to O: 16-byte stores (two where O
// is wider than the vector's T, as float32 out of bfloat16)
template <typename O, int N>
__device__ __forceinline__ void store(O* __restrict__ p, const float (&v)[N]) {
  constexpr int PER = VEC<O>;
  static_assert(N % PER == 0, "whole 16-byte stores");
#pragma unroll
  for (int j = 0; j < N / PER; ++j) {
    uint4 raw;
    O* e = reinterpret_cast<O*>(&raw);
#pragma unroll
    for (int i = 0; i < PER; ++i) e[i] = from_f32<O>(v[j * PER + i]);
    reinterpret_cast<uint4*>(p)[j] = raw;
  }
}

// ---- 1 and 4: the mixes' prologue -------------------------------------------
//
// x (B, T, D) is the residual stream (plus add, rounded, where add is given:
// kernel 4's x + att, written to x_out); each row is RMS-normed with ln,
// and mix m of row t is bf16(n_t + bf16(bf16(n_{t-1} - n_t) * mu[m])), with
// n_{-1} the carried row prev (B, D) or zeros.  mixes is (n_mix, B, T, D);
// carry (B, D) gets the last normed row.
//
// Design: a CTA takes `rows` consecutive rows of one sequence, each row in
// one pass of the whole CTA (a thread owns the same 16-byte vector of
// every row, so the previous row's normed values stay in its registers and the
// shift reads nothing twice).  The row before the first is normed again
// from x (one row in `rows` read twice).  The launch sizes `rows` so that
// the call's CTAs are all resident at once, as many as the SMs hold (one
// wave, no tail).  The next row's loads are issued before the current
// row's sum, whose one barrier is the only wait.  Rows stay in registers
// as stored (a 16-byte vector in 4 registers), so a thread needs at most
// 48 registers and an SM holds four CTAs of rwkv6-3b's 320 threads: four
// rows and their successors' loads in flight (at three CTAs, 64 registers,
// the channel mix's prologue took 6% longer on the H100).  Each load and
// store has its own `ok` guard: one `if (ok)` around the whole mix loop
// made ptxas spill 88 bytes at the 48-register cap, and the prologues ran
// ~12% slower.  Bytes at B1 T4096 D2560 bf16: kernel 1 reads 21 MB and writes 105, kernel 4 reads 42 and writes 63.
template <typename T>
__global__ void __launch_bounds__(MIX_THREADS, MIX_MIN_CTAS)
    rwkv6_mix_in_kernel(const T* __restrict__ x, const T* __restrict__ add,
                        const T* __restrict__ ln, const T* __restrict__ mu,
                        const T* __restrict__ prev, T* __restrict__ x_out,
                        T* __restrict__ mixes, T* __restrict__ carry, int t_len, int d,
                        int n_mix, int rows) {
  using P = Pack<T>;
  __shared__ float part[2][32];
  const long long b = blockIdx.y;
  const int t0 = blockIdx.x * rows, t1 = min(t0 + rows, t_len);
  const long long plane = (long long)gridDim.y * t_len * d;  // one mix
  const float inv_d = 1.f / (float)d;
  const int col = threadIdx.x * VEC<T>;
  const bool ok = col < d;
  // pn: the previous normed row; cur, ca: this row's x and add as loaded;
  // nx, na: the next row's
  P pn, cur, ca, nx, na;
  zero(pn), zero(cur), zero(ca), zero(nx), zero(na);
  auto fetch = [&](int t, P& vx, P& va) {
    const long long off = (b * t_len + t) * d;
    if (ok) {
      ld(vx, x + off + col);
      if (add != nullptr) ld(va, add + off + col);
    }
  };
  // v := the residual row, x or bf16(x + add)
  auto resid = [&](P& v, const P& a) {
    if (add == nullptr) return;
#pragma unroll
    for (int i = 0; i < VEC<T>; ++i)
      v.v[i] = from_f32<T>(__fadd_rn(to_f32(v.v[i]), to_f32(a.v[i])));
  };
  // v := bf16(v * rsqrt(mean(v^2) + eps) * ln), in the plain version's order
  auto norm = [&](P& v, float* p) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VEC<T>; ++i) ss = fmaf(to_f32(v.v[i]), to_f32(v.v[i]), ss);
    const float inv = rsqrtf(__fadd_rn(__fmul_rn(block_total(ss, p), inv_d), EPS));
    if (ok) {
      P w;
      ld(w, ln + col);
#pragma unroll
      for (int i = 0; i < VEC<T>; ++i)
        v.v[i] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(v.v[i]), inv), to_f32(w.v[i])));
    }
  };

  // the normed row before t0: the carried one, zeros, or row t0 - 1 again
  if (t0 > 0) {
    fetch(t0 - 1, pn, ca);
    resid(pn, ca);
    norm(pn, part[1]);
  } else if (prev != nullptr) {
    if (ok) ld(pn, prev + b * d + col);
  }
  fetch(t0, cur, ca);
  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) fetch(t + 1, nx, na);
    resid(cur, ca);
    const long long off = (b * t_len + t) * d;
    if (x_out != nullptr) {
      if (ok) st(x_out + off + col, cur);
    }
    norm(cur, part[(t - t0) & 1]);
    for (int m = 0; m < n_mix; ++m) {
      if (!ok) continue;
      P mv, o;
      ld(mv, mu + (long long)m * d + col);
#pragma unroll
      for (int i = 0; i < VEC<T>; ++i) {
        const float c = to_f32(cur.v[i]);
        const float dx = rnd<T>(__fsub_rn(to_f32(pn.v[i]), c));
        o.v[i] = from_f32<T>(__fadd_rn(c, rnd<T>(__fmul_rn(dx, to_f32(mv.v[i])))));
      }
      st(mixes + m * plane + off + col, o);
    }
    if (t == t_len - 1) {
      if (ok) st(carry + b * d + col, cur);
    }
    pn = cur, cur = nx, ca = na;
  }
}

// ---- 2: the decay -----------------------------------------------------------
//
// out = -exp(clamp(float(bf16(w0 + lora)), -8, 6)) in O (x's dtype for the
// recurrence kernel, float32 for the one-token decode step): lora (rows,
// HD), w0 (HD) broadcast over the rows.  Design: one 16-byte vector of lora
// a thread (w0's vector comes from L1), so a CTA of 256 threads streams
// 4 KB in and out; at B1 T4096 HD2560 bf16 it reads 21 MB and writes 21.
// clamp lets NaN through, as torch.clamp does.
template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
    rwkv6_decay_kernel(const T* __restrict__ w0, const T* __restrict__ lora, O* __restrict__ out,
                       long long n, int hd) {
  constexpr int V = VEC<T>;
  const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) * V;
  if (i >= n) return;
  float w[V], l[V], o[V];
  load<T>(w0 + i % hd, w);
  load<T>(lora + i, l);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float s = rnd<T>(__fadd_rn(w[k], l[k]));
    s = s < -8.f ? -8.f : (s > 6.f ? 6.f : s);
    o[k] = -expf(s);
  }
  store<O>(out + i, o);
}

// ---- 3: head norm and gate --------------------------------------------------
//
// y = bf16(bf16(rms_norm over each head's dh values of o, times ln_x[h]) *
// bf16(silu(g))): o (B, T, H, dh) from the recurrence, ln_x (H, dh), g
// (B, T, H*dh) the raw xg @ wg, y (B, T, H*dh).  Design: a head's dh values
// on `group` = dh / VEC lanes of a warp, one 16-byte vector each (dh = 64
// bf16: 8 lanes), its sum of squares by a butterfly over those lanes, no
// shared memory and no barrier; the gate's and ln_x's loads are in flight
// with o's before the sum waits; a CTA of 256 threads takes 256 / group
// heads.  At B1 T4096 H40 dh64 bf16 it reads 42 MB and writes 21.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rwkv6_head_out_kernel(const T* __restrict__ o, const T* __restrict__ ln_x,
                          const T* __restrict__ g, T* __restrict__ y, long long heads, int h,
                          int dh, int group) {
  constexpr int V = VEC<T>;
  const int lane = threadIdx.x & (group - 1);
  const long long head = (long long)blockIdx.x * (THREADS / group) + threadIdx.x / group;
  const bool live = head < heads;
  const long long at = head * dh + lane * V;
  float v[V], gg[V], w[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = gg[i] = w[i] = 0.f;
  if (live) {  // every load in flight before the sum waits on o's
    load<T>(o + at, v);
    load<T>(g + at, gg);
    load<T>(ln_x + (long long)(head % h) * dh + lane * V, w);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) ss = fmaf(v[i], v[i], ss);
  for (int off = group >> 1; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (!live) return;
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / (float)dh), EPS));
  float out[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float n = rnd<T>(__fmul_rn(__fmul_rn(v[i], inv), w[i]));
    const float s = rnd<T>(__fdiv_rn(gg[i], __fadd_rn(1.f, expf(-gg[i]))));
    out[i] = __fmul_rn(n, s);
  }
  store<T>(y + at, out);
}

// ---- 5: relu^2 --------------------------------------------------------------
//
// out = bf16(relu(h)^2) over the channel mix's hidden layer (B, T, F).
// Design: one 16-byte vector a thread in and out; at B1 T4096 F8960 bf16
// it reads 73 MB and writes 73.  relu lets NaN through, as torch's does.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rwkv6_relu2_kernel(const T* __restrict__ h, T* __restrict__ out, long long n) {
  constexpr int V = VEC<T>;
  const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) * V;
  if (i >= n) return;
  float v[V];
  load<T>(h + i, v);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float r = v[k] < 0.f ? 0.f : v[k];
    v[k] = __fmul_rn(r, r);
  }
  store<T>(out + i, v);
}

// ---- 6: the channel gate and the residual -----------------------------------
//
// out = bf16(x + bf16(bf16(sigmoid(r)) * cv)), all (B, T, D): r the raw
// xr @ wcr, cv the projected hidden layer.  Design: one 16-byte vector of
// each a thread; at B1 T4096 D2560 bf16 it reads 63 MB and writes 21.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rwkv6_channel_out_kernel(const T* __restrict__ x, const T* __restrict__ r,
                             const T* __restrict__ cv, T* __restrict__ out, long long n) {
  constexpr int V = VEC<T>;
  const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) * V;
  if (i >= n) return;
  float a[V], s[V], c[V];
  load<T>(x + i, a);
  load<T>(r + i, s);
  load<T>(cv + i, c);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float sg = rnd<T>(__fdiv_rn(1.f, __fadd_rn(1.f, expf(-s[k]))));
    a[k] = __fadd_rn(a[k], rnd<T>(__fmul_rn(sg, c[k])));
  }
  store<T>(out + i, a);
}

// ---- launch -----------------------------------------------------------------

// one vector a thread, so D <= 5120 bfloat16, 2560 float32
template <typename T>
int mix_in(const void* x, const void* add, const void* ln, const void* mu, const void* prev,
           void* x_out, void* mixes, void* carry, int b, int t, int d, int n_mix,
           cudaStream_t s) {
  if (d % VEC<T> != 0 || d / VEC<T> > MIX_THREADS) return (int)cudaErrorInvalidValue;
  const auto kernel = rwkv6_mix_in_kernel<T>;
  const int threads = (int)cdiv(d / VEC<T>, 32) * 32;
  // CTAs an SM holds at this block size, asked once a block size
  static int cached_threads = 0, cached_ctas = 1;
  if (threads != cached_threads) {
    int ctas = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, 0);
    cached_ctas = ctas > 0 ? ctas : 1;
    cached_threads = threads;
  }
  const long long per_seq = cdiv((long long)cached_ctas * sm_count(), b);
  const int rows = (int)cdiv(t, per_seq);
  const dim3 grid((unsigned)cdiv(t, rows), (unsigned)b);
  kernel<<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(add), static_cast<const T*>(ln),
      static_cast<const T*>(mu), static_cast<const T*>(prev), static_cast<T*>(x_out),
      static_cast<T*>(mixes), static_cast<T*>(carry), t, d, n_mix, rows);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int decay(const void* w0, const void* lora, void* out, long long n, int hd, cudaStream_t s) {
  if (hd % VEC<T> != 0) return (int)cudaErrorInvalidValue;
  rwkv6_decay_kernel<T, O><<<(unsigned)cdiv(n / VEC<T>, THREADS), THREADS, 0, s>>>(
      static_cast<const T*>(w0), static_cast<const T*>(lora), static_cast<O*>(out), n, hd);
  return (int)cudaGetLastError();
}

// a head on dh / VEC lanes, a power of two up to a warp
template <typename T>
int head_out(const void* o, const void* ln_x, const void* g, void* y, long long heads, int h,
             int dh, cudaStream_t s) {
  const int lanes = dh / VEC<T>;
  if (dh % VEC<T> != 0 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  rwkv6_head_out_kernel<T><<<(unsigned)cdiv(heads, THREADS / lanes), THREADS, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(ln_x), static_cast<const T*>(g),
      static_cast<T*>(y), heads, h, dh, lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int relu2(const void* h, void* out, long long n, cudaStream_t s) {
  if (n % VEC<T> != 0) return (int)cudaErrorInvalidValue;
  rwkv6_relu2_kernel<T><<<(unsigned)cdiv(n / VEC<T>, THREADS), THREADS, 0, s>>>(
      static_cast<const T*>(h), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

template <typename T>
int channel_out(const void* x, const void* r, const void* cv, void* out, long long n,
                cudaStream_t s) {
  if (n % VEC<T> != 0) return (int)cudaErrorInvalidValue;
  rwkv6_channel_out_kernel<T><<<(unsigned)cdiv(n / VEC<T>, THREADS), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(cv),
      static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point takes contiguous tensors whose rows are whole 16-byte
// vectors at 16-byte-aligned addresses (the wrappers in
// `kernels/rwkv6_glue.py` check shapes, dtypes, devices and alignment; the
// entry points refuse sizes off the vectors with cudaErrorInvalidValue),
// launches on the given stream and returns cudaGetLastError() after the
// launch.
// x, add, x_out (B, T, D); add and x_out null for the time mix; ln (D); mu
// (n_mix, D); prev (B, D) or null (zeros); mixes (n_mix, B, T, D); carry (B, D)
extern "C" int hasco_rwkv6_mix_in(const void* x, const void* add, const void* ln, const void* mu,
                                  const void* prev, void* x_out, void* mixes, void* carry, int b,
                                  int t, int d, int n_mix, int dtype, void* stream) {
  if (b < 1 || b > 65535 || t < 1 || d < 1 || n_mix < 1 || (add == nullptr) != (x_out == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    return mix_in<float>(x, add, ln, mu, prev, x_out, mixes, carry, b, t, d, n_mix, s);
  if (dtype == hasco::kBFloat16)
    return mix_in<bf16>(x, add, ln, mu, prev, x_out, mixes, carry, b, t, d, n_mix, s);
  return (int)cudaErrorInvalidValue;
}

// w0 (HD); lora and out (n / HD, HD); out in out_dtype (x's dtype or float32)
extern "C" int hasco_rwkv6_decay(const void* w0, const void* lora, void* out, long long n, int hd,
                                 int dtype, int out_dtype, void* stream) {
  if (n < 1 || hd < 1 || n % hd != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32 && out_dtype == hasco::kFloat32)
    return decay<float, float>(w0, lora, out, n, hd, s);
  if (dtype == hasco::kBFloat16 && out_dtype == hasco::kBFloat16)
    return decay<bf16, bf16>(w0, lora, out, n, hd, s);
  if (dtype == hasco::kBFloat16 && out_dtype == hasco::kFloat32)
    return decay<bf16, float>(w0, lora, out, n, hd, s);
  return (int)cudaErrorInvalidValue;
}

// o (heads, dh) with heads = B * T * H; ln_x (H, dh); g and y (heads, dh)
extern "C" int hasco_rwkv6_head_out(const void* o, const void* ln_x, const void* g, void* y,
                                    long long heads, int h, int dh, int dtype, void* stream) {
  if (heads < 1 || h < 1 || dh < 1 || heads % h != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32) return head_out<float>(o, ln_x, g, y, heads, h, dh, s);
  if (dtype == hasco::kBFloat16) return head_out<bf16>(o, ln_x, g, y, heads, h, dh, s);
  return (int)cudaErrorInvalidValue;
}

// h and out: n elements
extern "C" int hasco_rwkv6_relu2(const void* h, void* out, long long n, int dtype, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32) return relu2<float>(h, out, n, s);
  if (dtype == hasco::kBFloat16) return relu2<bf16>(h, out, n, s);
  return (int)cudaErrorInvalidValue;
}

// x, r, cv and out: n elements
extern "C" int hasco_rwkv6_channel_out(const void* x, const void* r, const void* cv, void* out,
                                       long long n, int dtype, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32) return channel_out<float>(x, r, cv, out, n, s);
  if (dtype == hasco::kBFloat16) return channel_out<bf16>(x, r, cv, out, n, s);
  return (int)cudaErrorInvalidValue;
}
