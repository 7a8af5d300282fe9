// RWKV-6 (Finch) WKV recurrence, chunk-parallel.  For each (batch, head) the
// state S (Dk x Dv, float32) evolves over chunks of L = 16 tokens; within a
// chunk (lw = inclusive cumsum of the per-channel log-decay w, aq = lw - w the
// exclusive one, both restarting at every chunk):
//
//   o_t  = sum_d r_td e^{aq_td} S[d]                                (carried state)
//        + sum_{s<t} (sum_d r_td k_sd e^{aq_td - lw_sd}) v_s          (pairwise decay)
//        + (sum_d r_td u_d k_td) v_t                                  (diag(u) bonus)
//   S'[d] = e^{lw_Ld} S[d] + sum_s k_sd e^{lw_Ld - lw_sd} v_s         (state update)
//
// Replaces the Pallas TPU kernel `repro/kernels/rwkv6.py::rwkv6` (the same
// formula, its lines 10-13, and its chunk of 16, the unit of the cumsum).
// Every exponent is <= 0 for w <= 0 and is clamped there (expf(fminf(x, 0))),
// so nothing overflows at any decay: the model's reaches -403 a token, which
// is also why the pairwise term cannot be factored into a plain product (its
// factors would be e^{+-6000} over a chunk) and stays an exp-and-FMA block.
// Any T >= 1 is taken: rows past T are staged as r = k = v = 0, w = 0, which
// adds nothing and leaves S as it was.
//
// Bound on the H100: bytes.  At rwkv6-3b's forward (B1 T4096 H40 Dk=Dv=64
// bfloat16) r, k, w, v and o are 21 MB each, 105 MB in all: 0.0315 ms at
// 3.35 TB/s, against ~3 GFLOP of chunked products and ~80 M exps.  The TPU
// kernel carries S along a sequential grid axis; here three passes run over
// SPANS of NC chunks (NC = span_chunks, chosen by `kernels/rwkv6.py::plan`),
// as in mamba2.cu:
//
//   1. span states: every (span, head, batch, 64 columns of S) in parallel
//      walks its chunks from S = 0 (k, w and v only) and writes its local
//      state S_j and its per-channel decay D_j[d] = prod_c e^{lw_L^c[d]};
//   2. state passing (state_pass.cuh, shared with mamba2 at one decay a
//      span): H_{j+1}[d, e] = D_j[d] H_j[d, e] + S_j[d, e] in order over the
//      spans from the given state (or 0); H_j overwrites S_j, and the last
//      value is the final state;
//   3. outputs: every (span, head, batch, 64 columns) walks its chunks from
//      H_j: the chunk's pairwise score block with the bonus once a head (Dv
//      <= 64: one CTA owns every column), o = (r o e^{aq}) S + A V, and the
//      state update between chunks, which redoes NC - 1 updates a span that
//      pass 1 did.
//
// Each CTA loads the next chunk's r, k, w and v by cp.async (where the rows
// are 16-byte aligned) while the current one computes, three barriers a
// chunk (four in pass 3, whose outputs read the state before it moves).
// The plan takes spans of 16 chunks (256 tokens) where T is long: 640 CTAs a
// pass at rwkv6-3b's forward, and the span states take NS x B x H x Dk x Dv
// x 4 bytes = 10.5 MB, written by pass 1, read and written by pass 2, read
// by pass 3: 42 MB of traffic, a floor of 0.0125 ms at the HBM rate
// (derived, not measured; they fit in the 50 MB L2).  Spans of 8 chunks
// would double that (21 MB), spans of 4 take 42 MB, next to the L2's size.
// A shorter T halves the span while a pass would have fewer than 4 CTAs an
// SM, or one span would hold every chunk.
//
// Rounding.  bfloat16 ("tc"): the state's product sum_s (k o e^{lw_L -
// lw})_s v_s^T (Dk x 16 x 64 a chunk, passes 1 and 3) runs on mma.sync
// m16n8k16, one k step a chunk: v is exact in bfloat16, and the decayed k is
// split into three bfloat16 terms (k1 = bf16(x), k2 = bf16(x - k1), k3 =
// bf16(x - k1 - k2), ~24 bits), each product in a fresh accumulator added in
// float32, as mamba2's state products are.  The output terms run on float32
// FMA in the plain version's order of terms: (r o e^{aq}) S in order over d,
// then A V in order over s; the pairwise exponent uses the accurate expf,
// as the plain version's torch.exp (the fast __expf moved the call's time
// by a few percent on the H100, and nothing else).  float32 ("simt"): the
// same three passes, every product on float32 FMA (no TF32).
//
// One CTA layout serves both: 8 warps; the state's block (64 or 128 rows x
// 64 columns, float32) in shared memory, which the outputs read and each
// warp updates on its mma fragment (16 rows x 32 columns); the outputs 4
// rows x 1 column a thread; the scores two rows a warp (t and 15 - t: 15
// pairs, each over the two channel parities by two lanes, and the two bonus
// terms by a butterfly over the warp).  Every loop over the channels runs to
// Dk padded to 64 or 128 with zeros, unrolled, so that each lane keeps
// several exps and loads in flight, and the decayed k's bfloat16 terms are
// made once a chunk into planes that ldmatrix reads as A fragments.  At Dk
// <= 64 a bfloat16 CTA takes 58 KB of shared memory and at most 80
// registers a thread, so three are resident an SM: the passes wait on
// latency (loads, exps, barriers) more than on throughput, and at two CTAs
// an SM they ran slower.  A few loops stay rolled so that 80 registers hold.
//
// Layout: r, k, w (B, T, H, Dk); v, out (B, T, H, Dv), each read or written
// through its own batch, time and head strides (the last dim contiguous); u
// (H, Dk) float32; S0 and S_T (B, H, Dk, Dv) float32, contiguous, S0 may be
// null (zeros); the span states (B, H, NS, Dk, Dv) and decays (B, H, NS, Dk)
// float32 scratch.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "state_pass.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hasco::from_f32;
using hasco::to_f32;

constexpr int THREADS = 256;  // 8 warps
constexpr int L = 16;         // chunk length
constexpr int CB = 64;        // columns of S (and of v, o) a CTA owns
constexpr int MAX_DK = 128;
constexpr int STAGES = 2;     // chunks in flight: the current one and the next
// terms of the decayed k on the tensor cores: three keep ~24 bits, as
// mamba2's state products (tests/test_torch_rwkv6_chunks.py)
constexpr int TERMS = 3;

static_assert(THREADS / 32 == L / 2, "a warp owns two rows of the score block");
static_assert(THREADS == L / 4 * CB && CB == 64, "a thread owns 4 output rows of one column");

struct Strides {
  long long b, t, h;
};

// Shared memory of a CTA, DKT = 64 or 128 state rows (Dk padded)
template <typename T, int DKT>
struct Smem {
  static constexpr bool TC = std::is_same<T, bf16>::value;
  static constexpr int SLD = DKT + 16 / (int)sizeof(T);  // staged r, k, w: 16-byte rows
  static constexpr int VLD = CB + 16 / (int)sizeof(T);   // staged v
  static constexpr int FLD = DKT + 2;  // lw, aq: rows of 16 over two channel parities hit 32 banks
  static constexpr int HLD = CB + 4;   // the state
  static constexpr int KLD = DKT + 4;  // simt: k e^{lw_L - lw}, [s][d]
  static constexpr int KTLD = L + 8;   // tc: its TERMS bfloat16 terms, [term][d][s], 48-byte
                                       // rows: ldmatrix's 8 rows hit distinct banks
  static constexpr size_t stage_elems = 3 * (size_t)L * SLD + (size_t)L * VLD;  // one buffer
  static constexpr size_t kd_bytes =
      TC ? sizeof(bf16) * TERMS * DKT * KTLD : sizeof(float) * L * KLD;
  static constexpr size_t bytes =
      sizeof(T) * STAGES * stage_elems + kd_bytes +
      sizeof(float) * ((size_t)DKT * HLD + (size_t)DKT * L + L * L + 2 * (size_t)L * FLD +
                       2 * (size_t)DKT);
};

// CTAs an SM: three for the bfloat16 route at Dk <= 64 (58 KB of shared
// memory each, at most 80 registers a thread), two for float32, one at
// Dk > 64
template <typename T, int DKT>
constexpr int min_ctas() {
  return DKT > 64 ? 1 : Smem<T, DKT>::TC ? 3 : 2;
}

// L x COLS elements from global (row stride rs; rows >= rn and columns >= cn
// zero) into shared memory (row stride lds): by cp.async, 16 bytes a copy,
// where vec (16-byte aligned rows, cn a multiple of 16 bytes), else an
// element a load
template <typename T, int COLS>
__device__ __forceinline__ void stage_rows(T* dst, int lds, const T* src, long long rs, int rn,
                                           int cn, bool vec) {
  if (vec) {
    constexpr int PER = 16 / (int)sizeof(T), CH = COLS / PER;
    for (int i = threadIdx.x; i < L * CH; i += THREADS) {
      const int row = i / CH, col = (i % CH) * PER;
      const bool ok = row < rn && col < cn;
      hasco::cp_async16(dst + row * lds + col, ok ? src + row * rs + col : src, ok);
    }
  } else {
#pragma unroll 1  // rolled: unrolled, its addresses were kept across chunks and spilled
    for (int i = threadIdx.x; i < L * COLS; i += THREADS) {
      const int row = i / COLS, col = i % COLS;
      dst[row * lds + col] = (row < rn && col < cn) ? src[row * rs + col] : from_f32<T>(0.f);
    }
  }
}

// The state's block (DKT rows x CB columns, float32) lives in shared memory;
// its update runs on fragments (common.cuh): warp (rt, cq) owns rows 64 r +
// 16 rt .. + 15 and columns 32 cq .. 32 cq + 31, hs[j][e] at row 64 r + 16
// rt + g (+8 if e > 1), column 32 cq + 8 j + 2 tq (+1 if e odd).  OUT =
// false: pass 1; OUT = true: pass 3.
template <typename T, int DKT, bool OUT>
__global__ void __launch_bounds__(THREADS, min_ctas<T, DKT>())
rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ w, const float* __restrict__ u, float* __restrict__ S,
                   float* __restrict__ dec, T* __restrict__ out, int Tlen, int H, int Dk,
                   int Dv, int span_chunks, int col_blocks, Strides rs, Strides ks, Strides vs,
                   Strides ws, Strides os, int vec_rkw, int vec_v) {
  using M = Smem<T, DKT>;
  constexpr bool TC = M::TC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stage = reinterpret_cast<T*>(smem_raw);  // STAGES buffers: r, k, w (L x SLD), v (L x VLD)
  float* Hf = reinterpret_cast<float*>(stage + STAGES * M::stage_elems);  // DKT x HLD  state
  float* RQT = Hf + DKT * M::HLD;  // DKT x L   r e^{aq}, transposed
  float* AT = RQT + DKT * L;       // L x L     scores A[t][s] at AT[s][t], bonus on the diagonal
  unsigned char* kd_raw = reinterpret_cast<unsigned char*>(AT + L * L);
  float* KD = reinterpret_cast<float*>(kd_raw);  // simt: L x KLD  k e^{lw_L - lw}
  bf16* KDT = reinterpret_cast<bf16*>(kd_raw);   // tc: TERMS x DKT x KTLD, its bf16 terms
  float* LW = reinterpret_cast<float*>(kd_raw + M::kd_bytes);  // L x FLD  inclusive cumsum
  float* AQ = LW + L * M::FLD;     // L x FLD   exclusive: lw - w
  float* Us = AQ + L * M::FLD;     // DKT       u of this head
  float* DL = Us + DKT;            // DKT       e^{lw_L}

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
  const int rt = warp & 3, cq = warp >> 2;
  const int cb = blockIdx.x % col_blocks, span = blockIdx.x / col_blocks;
  const int NS = gridDim.x / col_blocks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = cb * CB, cn = min(CB, Dv - c0);
  const int nc = (int)hasco::cdiv(Tlen, L);
  const int k0 = span * span_chunks, k1 = min(k0 + span_chunks, nc);
  const long long bh = (long long)b * H + h;
  float* Sj = S + (bh * NS + span) * Dk * Dv + c0;

  // the state entering the span: H_j (pass 3) or 0 (pass 1); rows past Dk
  // and columns past Dv stay 0
  for (int i = tid; i < DKT * CB; i += THREADS) {
    const int d = i / CB, col = i % CB;
    Hf[d * M::HLD + col] = (OUT && d < Dk && col < cn) ? Sj[(long long)d * Dv + col] : 0.f;
  }
  for (int i = tid; i < DKT; i += THREADS) Us[i] = OUT && i < Dk ? u[(long long)h * Dk + i] : 0.f;
  if (OUT)
    for (int i = tid; i < L * L; i += THREADS) AT[i] = 0.f;  // s > t stays 0
  float dprod = 1.f;  // pass 1: channel tid's decay over the span

  const T* rb = r + (long long)b * rs.b + (long long)h * rs.h;
  const T* kb = k + (long long)b * ks.b + (long long)h * ks.h;
  const T* wb = w + (long long)b * ws.b + (long long)h * ws.h;
  const T* vb = v + (long long)b * vs.b + (long long)h * vs.h + c0;
  T* ob = out + (long long)b * os.b + (long long)h * os.h + c0;
  // chunk c into buffer c % STAGES (one cp.async group a chunk, empty past
  // the span)
  const auto stage_chunk = [&](int c) {
    if (c < k1) {
      T* base = stage + (c % STAGES) * M::stage_elems;
      const long long t0 = (long long)c * L;
      const int tn = min(L, Tlen - c * L);
      if (OUT) stage_rows<T, DKT>(base, M::SLD, rb + t0 * rs.t, rs.t, tn, Dk, vec_rkw);
      stage_rows<T, DKT>(base + L * M::SLD, M::SLD, kb + t0 * ks.t, ks.t, tn, Dk, vec_rkw);
      stage_rows<T, DKT>(base + 2 * L * M::SLD, M::SLD, wb + t0 * ws.t, ws.t, tn, Dk, vec_rkw);
      stage_rows<T, CB>(base + 3 * L * M::SLD, M::VLD, vb + t0 * vs.t, vs.t, tn, cn, vec_v);
    }
    hasco::cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) stage_chunk(k0 + i);
  for (int c = k0; c < k1; ++c) {
    const int tn = min(L, Tlen - c * L);
    hasco::cp_async_wait<STAGES - 2>();
    __syncthreads();  // the chunk has landed; every read of the last one is done
    stage_chunk(c + STAGES - 1);  // into the buffer the last chunk used
    const T* Rst = stage + (c % STAGES) * M::stage_elems;
    const T* Kst = Rst + L * M::SLD;
    const T* Wst = Kst + L * M::SLD;
    const T* Vst = Wst + L * M::SLD;

    // 1. per channel: the cumsums lw and aq = lw - w (the reference's), and
    //    e^{lw_L}
    if (tid < DKT) {
      float acc = 0.f;
#pragma unroll 4
      for (int t = 0; t < L; ++t) {
        const float wv = to_f32(Wst[t * M::SLD + tid]);
        acc += wv;
        LW[t * M::FLD + tid] = acc;
        AQ[t * M::FLD + tid] = acc - wv;
      }
      DL[tid] = expf(fminf(acc, 0.f));
      if (!OUT) dprod *= DL[tid];
    }
    __syncthreads();

    // 2. k e^{lw_L - lw} for the state update (tc: as TERMS bfloat16 terms,
    //    x1 = bf16(x), x2 = bf16(x - x1), ...); pass 3 also r e^{aq} and the
    //    score block
#pragma unroll 1  // rolled, as the next two loops are partly: unrolled, they spilled
    for (int i = tid; i < L * DKT; i += THREADS) {
      const int s = i % L, d = i / L;
      float x = to_f32(Kst[s * M::SLD + d]) *
                expf(fminf(LW[(L - 1) * M::FLD + d] - LW[s * M::FLD + d], 0.f));
      if constexpr (TC) {
#pragma unroll
        for (int q = 0; q < TERMS; ++q) {
          const bf16 term = __float2bfloat16_rn(x);
          KDT[(q * DKT + d) * M::KTLD + s] = term;
          x -= __bfloat162float(term);
        }
      } else {
        KD[s * M::KLD + d] = x;
      }
    }
    if (OUT) {
#pragma unroll 1
      for (int i = tid; i < L * DKT; i += THREADS) {
        const int t = i % L, d = i / L;
        RQT[d * L + t] = to_f32(Rst[t * M::SLD + d]) * expf(fminf(AQ[t * M::FLD + d], 0.f));
      }
      // warp w: rows ta = w and tb = 15 - w, 15 pairs s < t in all, each
      // summed by lanes 2 p and 2 p + 1 over the two channel parities, in
      // order over d (the padded channels past Dk add 0; lanes 30 and 31
      // repeat pair 14 and drop it)
      const int ta = warp, tb = L - 1 - warp, par = lane & 1;
      const int p = min(lane >> 1, L - 2);
      const int t = p < ta ? ta : tb, s = p < ta ? p : p - ta;
      const T *rq = Rst + t * M::SLD + par, *kk = Kst + s * M::SLD + par;
      const float *aq = AQ + t * M::FLD + par, *lw = LW + s * M::FLD + par;
      float acc = 0.f;
#pragma unroll 4
      for (int d = 0; d < DKT; d += 2)
        acc = fmaf(to_f32(rq[d]) * to_f32(kk[d]), expf(fminf(aq[d] - lw[d], 0.f)), acc);
      const float odd = __shfl_down_sync(0xffffffffu, acc, 1);
      if (par == 0 && lane < 30) AT[s * L + t] = acc + odd;
      // the bonus (r_t o u) . k_t of rows ta and tb: lane l over channels l,
      // l + 32, ..., then a fixed-order butterfly over the warp
      float ba = 0.f, bb = 0.f;
      for (int d = lane; d < DKT; d += 32) {
        ba = fmaf(to_f32(Rst[ta * M::SLD + d]) * Us[d], to_f32(Kst[ta * M::SLD + d]), ba);
        bb = fmaf(to_f32(Rst[tb * M::SLD + d]) * Us[d], to_f32(Kst[tb * M::SLD + d]), bb);
      }
      ba = hasco::warp_sum(ba);
      bb = hasco::warp_sum(bb);
      if (lane == 0) AT[ta * L + ta] = ba, AT[tb * L + tb] = bb;
    }
    __syncthreads();

    // 3. outputs: rows 4 rg .. 4 rg + 3, column 32 (warp / 4) + lane of the
    //    block; (r o e^{aq}) S in order over d (rows of RQT and S past Dk are
    //    0), then A V in order over s (A is 0 past the diagonal), on float32
    //    FMA
    if (OUT) {
      const int rg = warp & 3, col = 32 * (warp >> 2) + lane;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d = 0; d < DKT; ++d) {
        const float4 q = *reinterpret_cast<const float4*>(RQT + d * L + 4 * rg);
        const float hv = Hf[d * M::HLD + col];
        o[0] = fmaf(q.x, hv, o[0]);
        o[1] = fmaf(q.y, hv, o[1]);
        o[2] = fmaf(q.z, hv, o[2]);
        o[3] = fmaf(q.w, hv, o[3]);
      }
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        const float4 a = *reinterpret_cast<const float4*>(AT + s * L + 4 * rg);
        const float vv = to_f32(Vst[s * M::VLD + col]);
        o[0] = fmaf(a.x, vv, o[0]);
        o[1] = fmaf(a.y, vv, o[1]);
        o[2] = fmaf(a.z, vv, o[2]);
        o[3] = fmaf(a.w, vv, o[3]);
      }
      if (col < cn)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * rg + i;
          if (t < tn) ob[((long long)c * L + t) * os.t + col] = from_f32<T>(o[i]);
        }
      if (c + 1 < k1) __syncthreads();  // every read of the state is done
    }

    // 4. state update (pass 3 skips it after the span's last chunk):
    //    S = e^{lw_L} S + KD^T V, each warp on its fragment of S
    if (!OUT || c + 1 < k1) {
      // (a half fragment at a time: 16 columns, two n tiles of 8)
#pragma unroll
      for (int ri = 0; ri < DKT / 64; ++ri)
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          const int n0 = 64 * ri + 16 * rt + g, c16 = 32 * cq + 16 * dp;
          float* h0 = Hf + n0 * M::HLD + c16 + 2 * tq;
          float* h8 = h0 + 8 * M::HLD;
          const float dl0 = DL[n0], dl1 = DL[n0 + 8];
          float hs[2][4];  // columns c16 + 8 j + 2 tq (+1)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2 x0 = *reinterpret_cast<const float2*>(h0 + 8 * j);
            const float2 x8 = *reinterpret_cast<const float2*>(h8 + 8 * j);
            hs[j][0] = x0.x * dl0, hs[j][1] = x0.y * dl0;
            hs[j][2] = x8.x * dl1, hs[j][3] = x8.y * dl1;
          }
          if constexpr (TC) {
            // on the tensor cores, one k step of 16: KD^T (rows d, k = s)
            // term by term as A, smallest first, v exact as B; each product
            // joins the state in float32 (mma_add)
            unsigned bx[4];
            hasco::ldsm_x4_t(bx, reinterpret_cast<const bf16*>(Vst) + c16 +
                                     ((lane & 7) + (((lane >> 3) & 1) << 3)) * M::VLD +
                                     ((lane >> 4) << 3));
            const bf16* kt =
                KDT + (64 * ri + 16 * rt + (lane & 15)) * M::KTLD + ((lane >> 4) << 3);
#pragma unroll
            for (int q = TERMS - 1; q >= 0; --q) {
              unsigned a[4];
              hasco::ldsm_x4(a, kt + q * DKT * M::KTLD);
              hasco::mma_add(hs[0], a, bx[0], bx[1]);
              hasco::mma_add(hs[1], a, bx[2], bx[3]);
            }
          } else {
            // on float32 FMA, in order over s
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int d = n0 + (e >> 1) * 8, col = c16 + 8 * j + 2 * tq + (e & 1);
#pragma unroll 4
                for (int s = 0; s < L; ++s)
                  hs[j][e] = fmaf(KD[s * M::KLD + d], to_f32(Vst[s * M::VLD + col]), hs[j][e]);
              }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            *reinterpret_cast<float2*>(h0 + 8 * j) = make_float2(hs[j][0], hs[j][1]);
            *reinterpret_cast<float2*>(h8 + 8 * j) = make_float2(hs[j][2], hs[j][3]);
          }
        }
    }
  }

  if (!OUT) {
    __syncthreads();  // every warp's last update is in
    for (int i = tid; i < DKT * CB; i += THREADS) {
      const int d = i / CB, col = i % CB;
      if (d < Dk && col < cn) Sj[(long long)d * Dv + col] = Hf[d * M::HLD + col];
    }
    if (cb == 0 && tid < Dk) dec[(bh * NS + span) * Dk + tid] = dprod;
  }
}

template <typename T, int DKT, bool OUT>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           float* S, float* dec, void* out, int B, int Tlen, int H, int Dk, int Dv,
           int span_chunks, int NS, const Strides* st, int vec_rkw, int vec_v,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<T, DKT>::bytes;
  auto kern = rwkv6_chunk_kernel<T, DKT, OUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int col_blocks = (int)hasco::cdiv(Dv, CB);
  const dim3 grid((unsigned)(NS * col_blocks), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, S, dec, static_cast<T*>(out), Tlen, H, Dk, Dv, span_chunks,
      col_blocks, st[0], st[1], st[2], st[3], st[4], vec_rkw, vec_v);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* r, const void* k, const void* v, const void* w, const float* u,
        const float* s0, void* out, float* sT, float* S, float* dec, int B, int Tlen, int H,
        int Dk, int Dv, int span_chunks, const Strides* st, cudaStream_t stream) {
  const int NS = (int)hasco::cdiv(hasco::cdiv(Tlen, L), span_chunks);
  constexpr int PER = 16 / (int)sizeof(T);
  const auto al = [](const void* p, const Strides& z) {
    return ((uintptr_t)p & 15u) == 0 && z.b % PER == 0 && z.t % PER == 0 && z.h % PER == 0;
  };
  const int vec_rkw = al(r, st[0]) && al(k, st[1]) && al(w, st[3]) && Dk % PER == 0;
  const int vec_v = al(v, st[2]) && Dv % PER == 0;
  for (int pass = 1; pass <= 3; ++pass) {
    int rc;
    if (pass == 2)
      rc = hasco::state_pass(S, dec, s0, sT, (long long)B * H, NS, (long long)Dk * Dv, Dk,
                             stream);
    else if (Dk <= 64)
      rc = pass == 1 ? launch<T, 64, false>(r, k, v, w, u, S, dec, out, B, Tlen, H, Dk, Dv,
                                            span_chunks, NS, st, vec_rkw, vec_v, stream)
                     : launch<T, 64, true>(r, k, v, w, u, S, dec, out, B, Tlen, H, Dk, Dv,
                                           span_chunks, NS, st, vec_rkw, vec_v, stream);
    else
      rc = pass == 1 ? launch<T, 128, false>(r, k, v, w, u, S, dec, out, B, Tlen, H, Dk, Dv,
                                             span_chunks, NS, st, vec_rkw, vec_v, stream)
                     : launch<T, 128, true>(r, k, v, w, u, S, dec, out, B, Tlen, H, Dk, Dv,
                                            span_chunks, NS, st, vec_rkw, vec_v, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// strides: {batch, time, head} in elements for r, k, v, w and out, in that
// order (15 values); the last dim of each is contiguous.  S and dec: the span
// states (B, H, NS, Dk, Dv) and decays (B, H, NS, Dk) float32 scratch, NS =
// cdiv(cdiv(T, 16), span_chunks).  Returns a CUDA error code.
extern "C" int hasco_rwkv6(const void* r, const void* k, const void* v, const void* w,
                           const float* u, const float* s0, void* out, float* sT, float* S,
                           float* dec, int B, int Tlen, int H, int Dk, int Dv,
                           const long long* strides, int span_chunks, int dtype, void* stream) {
  if (B < 1 || Tlen < 1 || H < 1 || Dk < 1 || Dk > MAX_DK || Dv < 1 || span_chunks < 1)
    return (int)cudaErrorInvalidValue;
  Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32)
    return run<float>(r, k, v, w, u, s0, out, sT, S, dec, B, Tlen, H, Dk, Dv, span_chunks, st, s);
  if (dtype == hasco::kBFloat16)
    return run<bf16>(r, k, v, w, u, s0, out, sT, S, dec, B, Tlen, H, Dk, Dv, span_chunks, st, s);
  return (int)cudaErrorInvalidValue;
}
