// Pass 2 of the chunk-parallel recurrences (mamba2.cu, rwkv6.cu): the state
// entering each span, and the final state.
//
// Pass 1 leaves, for every (batch, head) and span j, the span's local state
// S_j (rows x cols, float32, computed from a zero state) and its decay.  In
// order over the spans, from the given state h0 (or zeros):
//
//   H_0 = h0,  H_{j+1}[row, col] = D_j[row] H_j[row, col] + S_j[row, col]
//
// H_j overwrites S_j and the last value is the final state.  The decay is
// one value per row group: R = 1 gives one decay a span for the whole state
// (mamba2's per-head decay), R = rows one a row (rwkv6's per-channel decay).
#pragma once

#include <cuda_runtime.h>

namespace hasco {
namespace {

constexpr int PASS_THREADS = 256, PASS_BATCH = 8;

// One thread an element of (batch, head, row, col): its states over the
// spans in order, PASS_BATCH loads in flight ahead of the recurrence.  S is
// (BH, NS, NPe) and dec (BH, NS, R), NPe = rows x cols elements a state.
__global__ void __launch_bounds__(PASS_THREADS)
state_pass_kernel(float* __restrict__ S, const float* __restrict__ dec,
                  const float* __restrict__ h0, float* __restrict__ hT, long long BH, int NS,
                  long long NPe, int R) {
  const long long i = (long long)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (i >= BH * NPe) return;
  const long long bh = i / NPe, e = i - bh * NPe;
  float run = h0 != nullptr ? h0[i] : 0.f;
  float* s = S + bh * NS * NPe + e;
  // decay (bh NS + j) R + e / (NPe / R): this element's row group
  const float* d = dec + bh * NS * R + e / (NPe / R);
  for (int j0 = 0; j0 < NS; j0 += PASS_BATCH) {
    float sj[PASS_BATCH], dj[PASS_BATCH];
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u) {
      sj[u] = j0 + u < NS ? s[(long long)(j0 + u) * NPe] : 0.f;
      dj[u] = j0 + u < NS ? d[(long long)(j0 + u) * R] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PASS_BATCH; ++u) {
      if (j0 + u >= NS) break;
      s[(long long)(j0 + u) * NPe] = run;
      run = dj[u] * run + sj[u];
    }
  }
  hT[i] = run;
}

// launches pass 2 on the stream; returns a CUDA error code
inline int state_pass(float* S, const float* dec, const float* h0, float* hT, long long BH,
                      int NS, long long NPe, int R, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((BH * NPe + PASS_THREADS - 1) / PASS_THREADS);
  state_pass_kernel<<<blocks, PASS_THREADS, 0, stream>>>(S, dec, h0, hT, BH, NS, NPe, R);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hasco
