// The DQN bank's product, one per slot of the bank:
//   out[n, i, j] = act(sum_k a[n, i, k] * b[n, k, j] + bias[n, j])
// float32 in and out, float32 FMA (no TF32); act is the identity or ReLU,
// and bias is optional.
// a and b are read through their element strides, so a transposed view
// (h^T for a weight gradient, W^T for an input gradient) or a broadcast
// (stride 0: a row of ones sums b's rows) costs no copy.
//
// Replaces no TPU kernel.  The reference's bank
// (`repro/core/qlearning.py::_bank_forward`, `_bank_train_steps`) leaves
// its products to XLA under vmap.  On the H100, the same step through
// PyTorch's batched products (cuBLAS) and row sums gave a slot of a 16-slot
// bank other bits than the same slot alone: those libraries pick their
// kernels, and so their order of summation, by the whole batch's shape.  A
// bank slot must keep the bits of a standalone DQN.  Here each output is
// one thread's sum over k in order 0..K-1 by FMA, then the bias, then the
// ReLU: the same arithmetic whatever N, M or the grid, so a slot's bits do
// not depend on how many slots share the call.
//
// Bound on the H100: bytes on paper (some 8 float32 operations a byte moved
// at these shapes, below the card's 20), but at the bank's shapes (N up to a few dozen slots, M = 32 rows,
// K and P up to 64) a call moves under 2 MB and does under 20 MFLOP, a
// fraction of a microsecond at the card's rates, so a call costs its
// launch.  A block of 256 threads takes
// 256 consecutive outputs of one slot: neighbouring threads take
// neighbouring j, so b's loads coalesce where its last dim is contiguous,
// and a warp shares a's element.  The bank replays a round's calls from a
// CUDA graph, which takes the launches' host cost away.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void bank_mm_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int m, int p, int k,
                               long long sa_n, long long sa_i, long long sa_k,
                               long long sb_n, long long sb_k, long long sb_j,
                               int relu) {
  const long long n = blockIdx.y;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)m * p) return;
  const long long i = idx / p, j = idx % p;
  const float* ap = a + n * sa_n + i * sa_i;
  const float* bp = b + n * sb_n + j * sb_j;
  float acc = 0.f;
  for (int kk = 0; kk < k; ++kk) acc = fmaf(ap[kk * sa_k], bp[kk * sb_k], acc);
  if (bias != nullptr) acc += bias[n * p + j];
  if (relu && acc < 0.f) acc = 0.f;
  out[(n * m + i) * p + j] = acc;
}

}  // namespace

// out (n, m, p) contiguous; bias (n, p) contiguous or null; strides in
// elements.  Returns cudaGetLastError() after the launch.
extern "C" int hasco_bank_mm(const float* a, const float* b,
                             const float* bias, float* out, int n, int m,
                             int p, int k, long long sa_n, long long sa_i,
                             long long sa_k, long long sb_n, long long sb_k,
                             long long sb_j, int relu, cudaStream_t stream) {
  const dim3 grid((unsigned)((1LL * m * p + THREADS - 1) / THREADS),
                  (unsigned)n);
  bank_mm_kernel<<<grid, THREADS, 0, stream>>>(a, b, bias, out, m, p, k,
                                               sa_n, sa_i, sa_k, sb_n, sb_k,
                                               sb_j, relu);
  return (int)cudaGetLastError();
}
