// The Zamba2 Mamba layer's elementwise and row-norm work around its two
// matrix products (in_proj, out_proj) and the SSD, fused into three kernels:
//
//   1. norm_in    rms_norm(x + t, ln), or rms_norm(x, ln) where t is absent
//   2. conv_in    from in_proj's output, read in place: the window-4
//                 depthwise causal conv of [x | B | C] with its bias and
//                 silu, dt = softplus(dt_raw + dt_bias), the log-decay
//                 -dt * exp(a_log), x scaled by dt, the carried tail
//   3. gate_out   the D skip, silu(z) gating and the RMS norm over each of
//                 `groups` equal parts of the inner width, times norm_w
//
// Replaces no Pallas kernel: the JAX package writes this glue as plain
// expressions (`src/repro/models/zamba2.py`) and leaves it to XLA's fusion.
// Eager PyTorch ran it as ~45 passes over the (B, S, ...) activations a
// layer, ~2.2 ms a layer at zamba2-7b's 1 x 4096 tokens; these kernels move
// ~0.53 GB a layer, ~160 us at 3.35 TB/s.
//
// Bound on the H100: bytes.  Each kernel reads its inputs once and writes
// its outputs once, in 16-byte vectors (bfloat16 8 elements, float32 4;
// conv_in in halves of them), and keeps every intermediate in registers.
// The vectors are the only route: the wrappers (`kernels/mamba2_glue.py`)
// take rows of whole 16-byte vectors at 16-byte-aligned addresses (d, the
// inner width, a head, the B/C width, in_proj's row), as every zamba2
// config gives, and refuse anything else.
//
// Rounding: the plain path's (`kernels/mamba2_glue.py`'s *_plain), in
// registers.  Every bfloat16 op of the plain versions rounds its result,
// and so does each kernel, at the same points: a bfloat16 product or sum is
// one mul.rn/add.rn.bf16x2 (two lanes an instruction), which rounds the
// exact result once, as PyTorch's float32 op followed by its rounding does
// for bfloat16 operands (their float32 product is exact, and a float32 sum
// that is not exact lies far below half a bfloat16 ulp of the larger
// operand).  float32 work runs through __fadd_rn/__fmul_rn, so nvcc
// contracts nothing into an FMA that the plain version rounds in two steps;
// silu, softplus and exp use the accurate float32 functions (expf, log1pf,
// IEEE division) as PyTorch's kernels do, and the norms sum their squares
// in the order PyTorch's CUDA reduction takes (torch_order_sum).  So every
// kernel gives the plain version's bits on the H100 with PyTorch 2.11;
// with a PyTorch that sums in another order, the norms differ only where
// the two sums move a value across a rounding boundary.
#include <algorithm>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hasco::cdiv;
using hasco::from_f32;
using hasco::sm_count;
using hasco::to_f32;

constexpr int CONV_K = 4;        // models/zamba2.py's CONV_K
constexpr int CONV_LANES = 32;   // conv_in: a warp over 32 channel vectors
constexpr int CONV_RUNS = 4;     // ... and four runs of rows a CTA
constexpr int CONV_UNROLL = 2;   // rows whose loads are in flight together
constexpr int CONV_MIN_CTAS = 8; // conv_in's CTAs an SM holds at least
constexpr int CONV_BYTES = 8;    // conv_in's channels a thread, in bytes
constexpr int NORM_THREADS = 512;  // a norm CTA's threads at most
constexpr int NORM_WIDTH = 8192;   // a norm's row at most: its squares in
                                   // shared memory, within 48 KB

// elements of T in one 16-byte vector
template <typename T>
constexpr int VEC = 16 / sizeof(T);

// N values of T as stored: a 16-byte vector (4 registers) or, for
// conv_in's, an 8-byte one (CONV_BYTES)
template <typename T, int N = VEC<T>>
struct alignas(N * sizeof(T)) Pack {
  static constexpr int WORDS = N * sizeof(T) / 4;
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ unsigned* words(Pack<T, N>& p) {
  return reinterpret_cast<unsigned*>(p.v);
}

template <typename T, int N>
__device__ __forceinline__ const unsigned* words(const Pack<T, N>& p) {
  return reinterpret_cast<const unsigned*>(p.v);
}

template <typename T, int N>
__device__ __forceinline__ void ld(Pack<T, N>& r, const T* __restrict__ p) {
  if constexpr (Pack<T, N>::WORDS == 4)
    *reinterpret_cast<uint4*>(r.v) = __ldg(reinterpret_cast<const uint4*>(p));
  else
    *reinterpret_cast<uint2*>(r.v) = __ldg(reinterpret_cast<const uint2*>(p));
}

template <typename T, int N>
__device__ __forceinline__ void st(T* __restrict__ p, const Pack<T, N>& r) {
  if constexpr (Pack<T, N>::WORDS == 4)
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r.v);
  else
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(r.v);
}

template <typename T, int N>
__device__ __forceinline__ void zero(Pack<T, N>& r) {
#pragma unroll
  for (int i = 0; i < Pack<T, N>::WORDS; ++i) words(r)[i] = 0u;
}

// the vector's lanes as floats
template <typename T, int N>
__device__ __forceinline__ void unpack(const Pack<T, N>& p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = to_f32(p.v[i]);
}

// floats rounded to T, to nearest even (bfloat16: two lanes an instruction)
__device__ __forceinline__ unsigned bf2_pack(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&r);
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> pack(const float (&v)[N]) {
  Pack<T, N> r;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) words(r)[i] = bf2_pack(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r.v[i] = v[i];
  }
  return r;
}

// lane-wise a * b and a + b, each rounded once to T
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <int N>
__device__ __forceinline__ Pack<bf16, N> pmul(const Pack<bf16, N>& a, const Pack<bf16, N>& b) {
  Pack<bf16, N> r;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) words(r)[i] = bf2_mul(words(a)[i], words(b)[i]);
  return r;
}

template <int N>
__device__ __forceinline__ Pack<bf16, N> padd(const Pack<bf16, N>& a, const Pack<bf16, N>& b) {
  Pack<bf16, N> r;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) words(r)[i] = bf2_add(words(a)[i], words(b)[i]);
  return r;
}

template <int N>
__device__ __forceinline__ Pack<float, N> pmul(const Pack<float, N>& a, const Pack<float, N>& b) {
  Pack<float, N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = __fmul_rn(a.v[i], b.v[i]);
  return r;
}

template <int N>
__device__ __forceinline__ Pack<float, N> padd(const Pack<float, N>& a, const Pack<float, N>& b) {
  Pack<float, N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = __fadd_rn(a.v[i], b.v[i]);
  return r;
}

// F.silu's float32 arithmetic: x / (1 + exp(-x))
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// F.softplus's, beta 1, threshold 20
__device__ __forceinline__ float softplus(float x) { return x > 20.f ? x : log1pf(expf(x)); }

// The sum of a row's squares in the order PyTorch's CUDA reduction takes
// for the plain version's torch.mean(x * x, -1) (Reduce.cuh's vectorized
// path, PyTorch 2.11 on the H100): virtual lane v of `lanes` adds the
// float4 groups v, v + lanes, ... of the row into four accumulators, adds
// those ((a0 + a1) + a2) + a3, the lanes are halved in shared memory down
// to 32, and a shuffle-down tree with offsets 16, 8, 4, 2, 1 ends in lane
// 0.  `lanes` is that reduction's block width for the call's rows
// (torch_lanes below).  So the normalizer is the plain version's bits, and
// where another PyTorch takes another order, the two differ by their sums'
// order alone.  s holds the thread's values (vector j of thread i is i + j *
// blockDim.x), zeros past the row; smem holds the row's squares and the
// lanes.  Every thread of the CTA calls it: it holds barriers.
template <typename T, int NV>
__device__ __forceinline__ float torch_order_sum(const Pack<T> (&s)[NV], int nvec, int lanes,
                                                 float* smem) {
  const int n = nvec * VEC<T>, tid = threadIdx.x, nt = blockDim.x;
  float* sq = smem;
  float* lane = smem + n;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = tid + j * nt;
    if (vi >= nvec) continue;
    float v[VEC<T>];
    unpack(s[j], v);
#pragma unroll
    for (int i = 0; i < VEC<T>; ++i) sq[vi * VEC<T> + i] = __fmul_rn(v[i], v[i]);
  }
  __syncthreads();
  const float4* q4 = reinterpret_cast<const float4*>(sq);
  for (int v = tid; v < lanes; v += nt) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int g = v; g < n / 4; g += lanes) {
      const float4 q = q4[g];
      a0 = __fadd_rn(a0, q.x), a1 = __fadd_rn(a1, q.y);
      a2 = __fadd_rn(a2, q.z), a3 = __fadd_rn(a3, q.w);
    }
    lane[v] = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
  }
  __syncthreads();
  for (int off = lanes / 2; off >= 32; off >>= 1) {
    for (int v = tid; v < off; v += nt) lane[v] = __fadd_rn(lane[v], lane[v + off]);
    __syncthreads();
  }
  if (tid < 32) {
    const int width = lanes < 32 ? lanes : 32;
    float x = tid < width ? lane[tid] : 0.f;
    for (int off = width / 2; off > 0; off >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
    if (tid == 0) lane[0] = x;
  }
  __syncthreads();
  return lane[0];
}

// out = bf16(s * rsqrt(mean(s^2) + eps) * w) over the row of the CTA's NV
// vectors a thread, the mean's sum in torch_order_sum's order.
template <typename T, int NV>
__device__ __forceinline__ void norm_out(const Pack<T> (&s)[NV], const T* __restrict__ w,
                                         T* __restrict__ out, int nvec, int lanes, float eps) {
  extern __shared__ float smem[];
  const float inv_n = 1.f / (float)(nvec * VEC<T>);
  const float inv =
      rsqrtf(__fadd_rn(__fmul_rn(torch_order_sum(s, nvec, lanes, smem), inv_n), eps));
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = threadIdx.x + j * blockDim.x;
    if (vi >= nvec) continue;
    Pack<T> wp;
    ld(wp, w + vi * VEC<T>);
    float v[VEC<T>], g[VEC<T>];
    unpack(s[j], v);
    unpack(wp, g);
#pragma unroll
    for (int i = 0; i < VEC<T>; ++i) v[i] = __fmul_rn(__fmul_rn(v[i], inv), g[i]);
    st(out + vi * VEC<T>, pack<T, VEC<T>>(v));
  }
}

// ---- 1: the layer's input norm ----------------------------------------------
//
// out = rms_norm(bf16(x + t), ln) or rms_norm(x, ln) where t is null: x, t,
// out (rows, d).  Design: one row a CTA, NV 16-byte vectors a thread, every
// load issued before the row's first barrier; the CTAs an SM holds (nine of
// 224 threads at d 3584 bf16) keep the loads of several rows in flight.  At
// zamba2-7b's 1 x 4096 x 3584 bf16 it reads 29 MB (58 with t) and writes 29.
template <typename T, int NV>
__global__ void __launch_bounds__(NORM_THREADS)
    mamba2_norm_in_kernel(const T* __restrict__ x, const T* __restrict__ t,
                          const T* __restrict__ ln, T* __restrict__ out, int d, int lanes,
                          float eps) {
  const long long off = (long long)blockIdx.x * d;
  const int nvec = d / VEC<T>;
  Pack<T> s[NV], a[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = threadIdx.x + j * blockDim.x;
    zero(s[j]), zero(a[j]);
    if (vi < nvec) {
      ld(s[j], x + off + vi * VEC<T>);
      if (t != nullptr) ld(a[j], t + off + vi * VEC<T>);
    }
  }
  if (t != nullptr) {
#pragma unroll
    for (int j = 0; j < NV; ++j) s[j] = padd(s[j], a[j]);
  }
  norm_out<T, NV>(s, ln, out + off, nvec, lanes, eps);
}

// ---- 2: the conv, dt and the SSD's inputs -------------------------------------
//
// zx is in_proj's output (B, S, ld) = [z (hp) | x (hp) | B (gn) | C (gn) |
// dt (h)], read in place.  Over the c = hp + 2 gn conv channels [x | B | C]:
// xbc = silu(bf16(bf16(bf16(bf16(0 + e0 k0) + e1 k1) + e2 k2) + e3 k3) +
// bias) (B, S, c) with e0..e3 rows s-3..s of the conv's input (tail rows,
// or zeros, before row 0) and each product rounded, laid out as the plain
// version's (xs, B and C are its views; the SSD takes as long on them as on
// B and C stored apart); x_scaled = bf16(xs * dt) (B, S, hp) with dt =
// softplus(float(dt_raw) + dt_bias) of the channel's head.  The first
// thread of each head writes log_decay = -dt * exp(a_log) in D (B, S, h);
// the threads of the last rows write new_tail (B, 3, c), the last three
// input rows (tail rows where S < 3).
//
// Design: a thread keeps an 8-byte vector of channels (CONV_BYTES) over a
// run of `rows` rows and slides the four-row window in registers: each
// input row is read once, and the three rows before its run once more (the
// previous run's, in L2).  A warp takes 32 consecutive vectors of one row,
// a CTA four consecutive runs, and the launch sizes the runs so that all
// CTAs are resident at once (one wave).  The loads of the next CONV_UNROLL
// rows are in flight while this batch computes.  dt is the softplus of one
// value a head and row, which the head's threads read from L1 and compute
// alike.  The silu (an accurate expf and an IEEE division an element) is
// what the kernel waits on beyond its bytes: 8-byte vectors keep a thread
// at 64 registers, so an SM holds eight CTAs to hide it (on the H100 at
// zamba2-7b's shape: 16-byte vectors took 116 registers, four CTAs, and
// 90 us against 87; without the silu and softplus, 74).  At zamba2-7b's
// 1 x 4096 tokens (c 7424, h 112) bf16 it reads 61 MB and writes 120.
template <typename T, typename D>
__global__ void __launch_bounds__(CONV_LANES* CONV_RUNS, CONV_MIN_CTAS)
    mamba2_conv_in_kernel(const T* __restrict__ zx, long long ld_zx, int hp, int c, int h,
                          int ph, const T* __restrict__ cw, const T* __restrict__ cb,
                          const float* __restrict__ dt_bias, const float* __restrict__ a_log,
                          const T* __restrict__ tail, T* __restrict__ xbc, T* __restrict__ xsc,
                          D* __restrict__ decay, T* __restrict__ new_tail, int s, int rows) {
  constexpr int N = CONV_BYTES / sizeof(T);
  using P = Pack<T, N>;
  const int col = (blockIdx.x * CONV_LANES + threadIdx.x) * N;
  const int r0 = (blockIdx.y * CONV_RUNS + threadIdx.y) * rows;
  if (col >= c || r0 >= s) return;  // no barrier in this kernel
  const int r1 = min(r0 + rows, s);
  const long long b = blockIdx.z;
  const T* __restrict__ in = zx + b * s * ld_zx + hp + col;  // row r: in + r * ld_zx
  P k[CONV_K], bias;
#pragma unroll
  for (int i = 0; i < CONV_K; ++i) ld(k[i], cw + (long long)i * c + col);
  ld(bias, cb + col);
  // the window: the conv's input rows r - 3, r - 2, r - 1
  P w[CONV_K - 1];
#pragma unroll
  for (int i = 0; i < CONV_K - 1; ++i) {
    const int r = r0 - (CONV_K - 1) + i;
    if (r >= 0)
      ld(w[i], in + r * ld_zx);
    else if (tail != nullptr)
      ld(w[i], tail + (b * (CONV_K - 1) + (CONV_K - 1) + r) * c + col);
    else
      zero(w[i]);
  }
  const bool is_x = col < hp;
  const int head = is_x ? col / ph : 0;
  const bool lead = is_x && col % ph == 0;
  const float bias_dt = is_x ? dt_bias[head] : 0.f;
  const float ea = is_x ? expf(a_log[head]) : 0.f;
  const T* __restrict__ dt_in = zx + b * s * ld_zx + hp + c + head;
  T* __restrict__ out = xbc + b * s * c + col;  // row r: out + r * c
  P zeros;
  zero(zeros);
  // the next CONV_UNROLL input rows and their dt_raw, in flight while this
  // batch computes
  P next[CONV_UNROLL];
  float next_dt[CONV_UNROLL];
  auto fetch = [&](int r) {
#pragma unroll
    for (int u = 0; u < CONV_UNROLL; ++u) {
      next_dt[u] = 0.f;
      if (r + u < r1) {
        ld(next[u], in + (r + u) * ld_zx);
        if (is_x) next_dt[u] = to_f32(dt_in[(r + u) * ld_zx]);
      }
    }
  };
  fetch(r0);
  for (int r = r0; r < r1; r += CONV_UNROLL) {
    P e[CONV_UNROLL];
    float dt_raw[CONV_UNROLL];
#pragma unroll
    for (int u = 0; u < CONV_UNROLL; ++u) e[u] = next[u], dt_raw[u] = next_dt[u];
    fetch(r + CONV_UNROLL);
#pragma unroll
    for (int u = 0; u < CONV_UNROLL; ++u) {
      if (r + u >= r1) break;
      const long long row = r + u;
      P acc = padd(zeros, pmul(w[0], k[0]));
      acc = padd(acc, pmul(w[1], k[1]));
      acc = padd(acc, pmul(w[2], k[2]));
      acc = padd(acc, pmul(e[u], k[3]));
      acc = padd(acc, bias);
      float v[N];
      unpack(acc, v);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = silu(v[i]);
      const P o = pack<T, N>(v);
      st(out + row * c, o);
      if (is_x) {
        const float dt = softplus(__fadd_rn(dt_raw[u], bias_dt));
        unpack(o, v);
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = __fmul_rn(v[i], dt);
        st(xsc + b * s * hp + col + row * hp, pack<T, N>(v));
        if (lead) decay[(b * s + row) * h + head] = from_f32<D>(__fmul_rn(-dt, ea));
      }
      w[0] = w[1], w[1] = w[2], w[2] = e[u];
    }
  }
  if (r1 == s) {
#pragma unroll
    for (int i = 0; i < CONV_K - 1; ++i) st(new_tail + (b * (CONV_K - 1) + i) * c + col, w[i]);
  }
}

// ---- 3: the D skip, the gate and the group norm -------------------------------
//
// g = bf16(bf16(y + bf16(xs * bf16(d_skip[head]))) * bf16(silu(z))), then
// out = rms_norm(g, w) over each of `groups` equal parts of a row's hp: y,
// out (rows, hp); xs and z (rows, hp) at row strides ld_x and ld_z
// (conv_in's output and in_proj's, read in place); d_skip (hp / ph)
// float32; w (hp).  Design: one (row, group) a CTA, as norm_in's: every
// load issued before the first barrier, the gated values kept as stored.
// At zamba2-7b's 1 x 4096 x 7168 bf16 in two groups it reads 176 MB and
// writes 59.
template <typename T, int NV>
__global__ void __launch_bounds__(NORM_THREADS)
    mamba2_gate_out_kernel(const T* __restrict__ y, const T* __restrict__ xs, long long ld_x,
                           const T* __restrict__ z, long long ld_z,
                           const float* __restrict__ d_skip, const T* __restrict__ w,
                           T* __restrict__ out, int hp, int groups, int ph, int lanes,
                           float eps) {
  const long long row = blockIdx.x / groups;
  const int width = hp / groups, g0 = (blockIdx.x % groups) * width;
  const int nvec = width / VEC<T>;
  const long long off = row * hp + g0;
  Pack<T> gy[NV], gx[NV], gz[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = threadIdx.x + j * blockDim.x;
    zero(gy[j]), zero(gx[j]), zero(gz[j]);
    if (vi < nvec) {
      ld(gy[j], y + off + vi * VEC<T>);
      ld(gx[j], xs + row * ld_x + g0 + vi * VEC<T>);
      ld(gz[j], z + row * ld_z + g0 + vi * VEC<T>);
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = threadIdx.x + j * blockDim.x;
    Pack<T> dp;
    const T dv = from_f32<T>(vi < nvec ? d_skip[(g0 + vi * VEC<T>) / ph] : 0.f);
#pragma unroll
    for (int i = 0; i < VEC<T>; ++i) dp.v[i] = dv;
    float v[VEC<T>];
    unpack(gz[j], v);
#pragma unroll
    for (int i = 0; i < VEC<T>; ++i) v[i] = silu(v[i]);
    gy[j] = pmul(padd(gy[j], pmul(gx[j], dp)), pack<T, VEC<T>>(v));
  }
  norm_out<T, NV>(gy, w + g0, out + off, nvec, lanes, eps);
}

// ---- launch -----------------------------------------------------------------

// The norm kernels' vectors a thread: the fewer of 2 and 4 that keeps a CTA
// within NORM_THREADS; 0 where the row is too wide for that.
int vectors_a_thread(int nvec) {
  for (int nv = 2; nv <= 4; nv *= 2)
    if (cdiv(nvec, nv) <= NORM_THREADS) return nv;
  return 0;
}

int norm_threads(int nvec, int nv) { return (int)cdiv(cdiv(nvec, nv), 32) * 32; }

// A norm CTA's shared memory: the row's squares and torch_order_sum's lanes
size_t norm_smem(int width) { return (size_t)(width + NORM_THREADS) * sizeof(float); }

int last_pow2(long long n) {
  int p = 1;
  while ((long long)p * 2 <= n) p *= 2;
  return p;
}

// The block width PyTorch's CUDA reduction gives torch.mean over the last
// dim of `rows` contiguous rows of `width` float32 values, vectorized by 4
// (Reduce.cuh: setReduceConfig, ReduceConfig::set_block_dimension with 512
// threads at most): the virtual lanes of torch_order_sum.
int torch_lanes(long long rows, int width) {
  const int dim0 = width / 4, max_threads = NORM_THREADS;
  const int d0 = dim0 < max_threads ? last_pow2(dim0) : max_threads;
  const int d1 = rows < max_threads ? last_pow2(rows) : max_threads;
  const int bh = std::min(d1, max_threads / std::min(d0, 32));
  return std::min(d0, max_threads / bh);
}

template <typename T, int NV>
int norm_in_nv(const void* x, const void* t, const void* ln, void* out, long long rows, int d,
               float eps, cudaStream_t s) {
  mamba2_norm_in_kernel<T, NV>
      <<<(unsigned)rows, norm_threads(d / VEC<T>, NV), norm_smem(d), s>>>(
          static_cast<const T*>(x), static_cast<const T*>(t), static_cast<const T*>(ln),
          static_cast<T*>(out), d, torch_lanes(rows, d), eps);
  return (int)cudaGetLastError();
}

template <typename T>
int norm_in(const void* x, const void* t, const void* ln, void* out, long long rows, int d,
            float eps, cudaStream_t s) {
  if (d % VEC<T> != 0 || d > NORM_WIDTH) return (int)cudaErrorInvalidValue;
  switch (vectors_a_thread(d / VEC<T>)) {
    case 2: return norm_in_nv<T, 2>(x, t, ln, out, rows, d, eps, s);
    case 4: return norm_in_nv<T, 4>(x, t, ln, out, rows, d, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename D>
int conv_in(const void* zx, long long ld_zx, int hp, int c, int h, int ph, const void* cw,
            const void* cb, const void* dt_bias, const void* a_log, const void* tail, void* xbc,
            void* xsc, void* decay, void* new_tail, int b, int s, cudaStream_t st) {
  if (ld_zx % VEC<T> != 0 || hp % VEC<T> != 0 || c % VEC<T> != 0 || ph % VEC<T> != 0)
    return (int)cudaErrorInvalidValue;
  const auto kernel = mamba2_conv_in_kernel<T, D>;
  constexpr int threads = CONV_LANES * CONV_RUNS;
  static int cached_ctas = 0;  // CTAs an SM holds, asked once
  if (cached_ctas == 0) {
    int ctas = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, 0);
    cached_ctas = ctas > 0 ? ctas : 1;
  }
  const long long lanes = cdiv(c / (CONV_BYTES / sizeof(T)), CONV_LANES);
  // runs of rows so that every CTA is resident at once: a CTA more than the
  // SMs hold would run a whole run in a second wave
  const long long per_lanes = std::max(1LL, (long long)cached_ctas * sm_count() / (lanes * b));
  const int rows = (int)cdiv(s, per_lanes * CONV_RUNS);
  const dim3 grid((unsigned)lanes, (unsigned)cdiv(cdiv(s, rows), CONV_RUNS), (unsigned)b);
  kernel<<<grid, dim3(CONV_LANES, CONV_RUNS), 0, st>>>(
      static_cast<const T*>(zx), ld_zx, hp, c, h, ph, static_cast<const T*>(cw),
      static_cast<const T*>(cb), static_cast<const float*>(dt_bias),
      static_cast<const float*>(a_log), static_cast<const T*>(tail), static_cast<T*>(xbc),
      static_cast<T*>(xsc), static_cast<D*>(decay), static_cast<T*>(new_tail), s, rows);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
int gate_out_nv(const void* y, const void* xs, long long ld_x, const void* z, long long ld_z,
                const void* d_skip, const void* w, void* out, long long rows, int hp,
                int groups, int ph, float eps, cudaStream_t s) {
  const int width = hp / groups;
  mamba2_gate_out_kernel<T, NV>
      <<<(unsigned)(rows * groups), norm_threads(width / VEC<T>, NV), norm_smem(width), s>>>(
          static_cast<const T*>(y), static_cast<const T*>(xs), ld_x, static_cast<const T*>(z), ld_z,
          static_cast<const float*>(d_skip), static_cast<const T*>(w), static_cast<T*>(out), hp,
          groups, ph, torch_lanes(rows * groups, width), eps);
  return (int)cudaGetLastError();
}

template <typename T>
int gate_out(const void* y, const void* xs, long long ld_x, const void* z, long long ld_z,
             const void* d_skip, const void* w, void* out, long long rows, int hp, int groups,
             int ph, float eps, cudaStream_t s) {
  if (hp % groups != 0 || (hp / groups) % VEC<T> != 0 || hp / groups > NORM_WIDTH ||
      ph % VEC<T> != 0 || ld_x % VEC<T> != 0 || ld_z % VEC<T> != 0)
    return (int)cudaErrorInvalidValue;
  switch (vectors_a_thread(hp / groups / VEC<T>)) {
    case 2:
      return gate_out_nv<T, 2>(y, xs, ld_x, z, ld_z, d_skip, w, out, rows, hp, groups, ph, eps, s);
    case 4:
      return gate_out_nv<T, 4>(y, xs, ld_x, z, ld_z, d_skip, w, out, rows, hp, groups, ph, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry point takes operands whose rows are whole 16-byte vectors at
// 16-byte-aligned addresses (the wrappers in `kernels/mamba2_glue.py` check
// shapes, dtypes, devices and alignment; the entry points refuse sizes off
// the vectors with cudaErrorInvalidValue), launches on the given stream and
// returns cudaGetLastError() after the launch.
// x, t, out (rows, d), t null where absent; ln (d)
extern "C" int hasco_mamba2_norm_in(const void* x, const void* t, const void* ln, void* out,
                                    long long rows, int d, float eps, int dtype, void* stream) {
  if (rows < 1 || rows > 2147483647LL || d < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32) return norm_in<float>(x, t, ln, out, rows, d, eps, s);
  if (dtype == hasco::kBFloat16) return norm_in<bf16>(x, t, ln, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

// zx (b, s, ld_zx) = [z (hp) | x (hp) | B (gn) | C (gn) | dt (h)] with ld_zx
// >= hp + c + h and c = hp + 2 gn the conv's channels; cw (4, c), cb (c),
// dt_bias and a_log (h) float32, tail (b, 3, c) or null (zeros); xbc (b, s,
// c), xsc (b, s, hp), decay (b, s, h) in decay_dtype (dtype or float32),
// new_tail (b, 3, c); a head is ph = hp / h channels
extern "C" int hasco_mamba2_conv_in(const void* zx, long long ld_zx, int hp, int c, int h,
                                    int ph, const void* cw, const void* cb, const void* dt_bias,
                                    const void* a_log, const void* tail, void* xbc, void* xsc,
                                    void* decay, void* new_tail, int b, int s, int dtype,
                                    int decay_dtype, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || ph < 1 || hp != h * ph || c <= hp ||
      ld_zx < (long long)hp + c + h)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32 && decay_dtype == hasco::kFloat32)
    return conv_in<float, float>(zx, ld_zx, hp, c, h, ph, cw, cb, dt_bias, a_log, tail, xbc,
                                 xsc, decay, new_tail, b, s, st);
  if (dtype == hasco::kBFloat16 && decay_dtype == hasco::kBFloat16)
    return conv_in<bf16, bf16>(zx, ld_zx, hp, c, h, ph, cw, cb, dt_bias, a_log, tail, xbc,
                               xsc, decay, new_tail, b, s, st);
  if (dtype == hasco::kBFloat16 && decay_dtype == hasco::kFloat32)
    return conv_in<bf16, float>(zx, ld_zx, hp, c, h, ph, cw, cb, dt_bias, a_log, tail, xbc,
                                xsc, decay, new_tail, b, s, st);
  return (int)cudaErrorInvalidValue;
}

// y, out (rows, hp); xs, z (rows, hp) at row strides ld_x, ld_z; d_skip (hp / ph)
// float32; w (hp); the norm over each of `groups` equal parts of hp
extern "C" int hasco_mamba2_gate_out(const void* y, const void* xs, long long ld_x, const void* z,
                                     long long ld_z, const void* d_skip, const void* w, void* out,
                                     long long rows, int hp, int groups, int ph, float eps,
                                     int dtype, void* stream) {
  if (rows < 1 || hp < 1 || groups < 1 || ph < 1 || ld_x < hp || ld_z < hp ||
      rows * groups > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    return gate_out<float>(y, xs, ld_x, z, ld_z, d_skip, w, out, rows, hp, groups, ph, eps, s);
  if (dtype == hasco::kBFloat16)
    return gate_out<bf16>(y, xs, ld_x, z, ld_z, d_skip, w, out, rows, hp, groups, ph, eps, s);
  return (int)cudaErrorInvalidValue;
}
