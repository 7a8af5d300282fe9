// CONV2D intrinsic: direct 'valid' convolution, no batch, unit stride,
//   out[k,x,y] = sum_{c,r,s} a[c,x+r,y+s] * w[k,c,r,s],  float32 accumulation.
//
// Replaces the Pallas TPU kernel `repro/kernels/conv2d.py::conv2d`.
//
// Bound on the H100: operations.  At the main path's ResNet-50 3x3 layer
// (K=C=256, 14x14 out) the 2*K*C*R*S*X*Y flops against 67 TFLOP/s take
// several times longer than moving its 1.3 MB.  The TPU kernel keeps the
// whole input resident per program (it has megabytes of VMEM); a CTA here
// has at most 227 KB of shared memory, so each CTA stages only its 8x16
// output tile plus the (R-1, S-1) halo, one chunk of input channels at a
// time, with the matching weights, and loops over C and the R*S taps with
// float32 accumulators in registers.  No im2col buffer exists in device
// memory (the point of the paper's Fig. 11), and shared memory per CTA is
// bounded whatever C, H and W are.
//
// The block bk (output channels per CTA) is honoured as given, any positive
// value: the grid is cdiv(K,bk) x spatial tiles, and a CTA walks its bk
// channels 32 at a time (8 warps x 4 channels, 4 positions per lane).
#include "common.cuh"

namespace {

using hasco::from_f32;
using hasco::to_f32;

constexpr int THREADS = 256, KSUB = 32, WST = KSUB + 1, TSX = 8, TSY = 16;
constexpr int SMEM_SOFT = 48 * 1024, SMEM_MAX = 227 * 1024;

// shared memory one input channel needs: its halo tile plus its weights
__host__ __device__ inline int channel_bytes(int R, int S) {
  return ((TSX + R - 1) * (TSY + S - 1) + R * S * WST) * (int)sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_kernel(const T* __restrict__ a, const T* __restrict__ w, T* __restrict__ out, int C,
              int H, int W, int K, int R, int S, int bk, int cc) {
  extern __shared__ float smem[];
  const int X = H - R + 1, Y = W - S + 1, RS = R * S;
  const int HX = TSX + R - 1, HY = TSY + S - 1;
  float* in_s = smem;                 // [cc][HX][HY]
  float* w_s = smem + cc * HX * HY;   // [cc][R*S][WST]
  const int tiles_y = (int)hasco::cdiv(Y, TSY);
  const int x0 = (blockIdx.y / tiles_y) * TSX, y0 = (blockIdx.y % tiles_y) * TSY;
  const int k_lo = blockIdx.x * bk, k_hi = min(k_lo + bk, K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int kk0 = k_lo; kk0 < k_hi; kk0 += KSUB) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < C; c0 += cc) {
      const int ct = min(cc, C - c0);
      for (int i = threadIdx.x; i < ct * HX * HY; i += THREADS) {
        const int c = i / (HX * HY), rem = i % (HX * HY);
        const int gx = x0 + rem / HY, gy = y0 + rem % HY;
        in_s[i] = (gx < H && gy < W) ? to_f32(a[((size_t)(c0 + c) * H + gx) * W + gy]) : 0.f;
      }
      for (int i = threadIdx.x; i < KSUB * ct * RS; i += THREADS) {
        const int kq = i / (ct * RS), rem = i % (ct * RS);  // rem = c * RS + rs
        const int k = kk0 + kq;
        w_s[rem * WST + kq] =
            k < k_hi ? to_f32(w[((size_t)k * C + c0) * RS + rem]) : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < ct; ++c) {
        for (int r = 0; r < R; ++r) {
          for (int s = 0; s < S; ++s) {
            const float* wp = w_s + (c * RS + r * S + s) * WST + warp * 4;
            const float* ip = in_s + (c * HX + r) * HY + s;
            float wv[4], av[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) wv[i] = wp[i];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int p = lane + 32 * j;
              av[j] = ip[(p / TSY) * HY + p % TSY];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], av[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kk0 + warp * 4 + i;
      if (k >= k_hi) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = lane + 32 * j;
        const int gx = x0 + p / TSY, gy = y0 + p % TSY;
        if (gx < X && gy < Y) out[((size_t)k * X + gx) * Y + gy] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* w, void* out, int C, int H, int W, int K, int R,
           int S, int bk, cudaStream_t stream) {
  const int per_channel = channel_bytes(R, S);
  if (per_channel > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // as many input channels per stage as fit the default 48 KB; one channel
  // at least, with the opt-in above 48 KB when a single one needs more
  const int cc = max(1, min(C, SMEM_SOFT / per_channel));
  const int smem = cc * per_channel;
  if (smem > SMEM_SOFT) {
    cudaError_t e = cudaFuncSetAttribute(conv2d_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int X = H - R + 1, Y = W - S + 1;
  const dim3 grid((unsigned)hasco::cdiv(K, bk),
                  (unsigned)(hasco::cdiv(X, TSX) * hasco::cdiv(Y, TSY)));
  conv2d_kernel<T><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(a),
                                                    static_cast<const T*>(w),
                                                    static_cast<T*>(out), C, H, W, K, R, S,
                                                    bk, cc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hasco_conv2d(const void* a, const void* w, void* out, int C, int H, int W,
                            int K, int R, int S, int bk, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == hasco::kFloat32) return launch<float>(a, w, out, C, H, W, K, R, S, bk, s);
  if (dtype == hasco::kBFloat16)
    return launch<__nv_bfloat16>(a, w, out, C, H, W, K, R, S, bk, s);
  return (int)cudaErrorInvalidValue;
}
