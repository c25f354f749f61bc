// The optical flow's 3x3 medians: `passes` consecutive edge-clamped 3x3
// medians of every [h, w] plane of a float32 tensor, up to two passes a
// launch.
//
// Replaces no TPU kernel: the JAX package computes the median with plain jnp
// ops (cartslam_tpu/ops/optflow.py `_median3x3`, Smith's 19-exchange min/max
// network on nine clamped shifts), which XLA fuses on the TPU.  Here each of
// the flow's searched pyramid levels runs its two passes as one launch.
//
// What bounds it on this card: the bytes, one read of the field and one
// write (1.9 MB at the KITTI flow's finest level, under a microsecond at
// 3.35 TB/s); the 19 exchanges a median are 76 operations an element for
// two passes, under half of that time at 67 T/s.  At these sizes a launch's own latency
// is the larger cost, so the design keeps the launches few and the
// intermediate out of device memory: a block owns a TH x TW output tile of
// one plane (the planes are the grid's z axis), loads a (TH + 2P) x (TW + 2P)
// input tile with edge-clamped rows and columns into shared memory, runs the
// first of two passes over the (TH + 2) x (TW + 2) ring into a second shared
// tile, and the last pass from there into device memory.
//
// Edges: the ring's value at tile position (i, j) is the first pass taken at
// the *clamped* global position, so the second pass reads exactly what a
// second clamped launch would read, at every border and for h or w as small
// as 1.  Each median is the network the JAX function runs (fminf / fmaxf);
// it selects one of its nine inputs, so the result equals torch.median's.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 32, TW = 32, THREADS = 256;

__device__ __forceinline__ void exchange(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// The 3x3 median around (r, c) of a row-major shared tile of width W.
template <int W>
__device__ __forceinline__ float median9(const float* s, int r, int c) {
  const float* q = s + (r - 1) * W + (c - 1);
  float p0 = q[0], p1 = q[1], p2 = q[2];
  float p3 = q[W], p4 = q[W + 1], p5 = q[W + 2];
  float p6 = q[2 * W], p7 = q[2 * W + 1], p8 = q[2 * W + 2];
  // Smith's median-of-9 network, in the JAX function's order; the median
  // lands in p4.
  exchange(p1, p2); exchange(p4, p5); exchange(p7, p8);
  exchange(p0, p1); exchange(p3, p4); exchange(p6, p7);
  exchange(p1, p2); exchange(p4, p5); exchange(p7, p8);
  exchange(p0, p3); exchange(p5, p8); exchange(p4, p7);
  exchange(p3, p6); exchange(p1, p4); exchange(p2, p5);
  exchange(p4, p7); exchange(p4, p2); exchange(p6, p4);
  exchange(p4, p2);
  return p4;
}

__device__ __forceinline__ int clamp_to(int v, int n) { return min(max(v, 0), n - 1); }

template <int PASSES>
__global__ void __launch_bounds__(THREADS)
median3x3_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w) {
  constexpr int IH = TH + 2 * PASSES, IW = TW + 2 * PASSES;  // the input tile
  constexpr int MH = TH + 2, MW = TW + 2;                    // the first pass's ring
  __shared__ float s_in[IH * IW];
  __shared__ float s_mid[PASSES == 2 ? MH * MW : 1];

  const size_t plane = (size_t)blockIdx.z * h * w;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  // s_in[r][c] = in[clamp(y0 - PASSES + r)][clamp(x0 - PASSES + c)]
  for (int k = threadIdx.x; k < IH * IW; k += THREADS) {
    const int r = k / IW, c = k % IW;
    s_in[k] = in[plane + (size_t)clamp_to(y0 - PASSES + r, h) * w + clamp_to(x0 - PASSES + c, w)];
  }
  __syncthreads();

  const float* last = s_in;  // the last pass's source, indexed like s_mid
  if constexpr (PASSES == 2) {
    // s_mid[i][j] = the first pass at (clamp(y0 - 1 + i), clamp(x0 - 1 + j)),
    // whose centre lies at s_in[that row - (y0 - 2)][that column - (x0 - 2)].
    for (int k = threadIdx.x; k < MH * MW; k += THREADS) {
      const int i = k / MW, j = k % MW;
      s_mid[k] = median9<IW>(s_in, clamp_to(y0 - 1 + i, h) - y0 + 2,
                             clamp_to(x0 - 1 + j, w) - x0 + 2);
    }
    __syncthreads();
    last = s_mid;
  }
  // Both sources hold the values at clamp(y0 - 1 + r), clamp(x0 - 1 + c) in
  // row r, column c, so output (y0 + i, x0 + j) is the median around
  // (i + 1, j + 1).
  for (int k = threadIdx.x; k < TH * TW; k += THREADS) {
    const int i = k / TW, j = k % TW;
    const int y = y0 + i, x = x0 + j;
    if (y < h && x < w) out[plane + (size_t)y * w + x] = median9<MW>(last, i + 1, j + 1);
  }
}

}  // namespace

// in, out: float32 [planes, h, w] on the card, contiguous, not overlapping;
// passes 1 or 2; planes <= 65535, h, w >= 1 (the wrapper checks).
extern "C" int median3x3(const void* in, void* out, int planes, int h, int w, int passes,
                         void* stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, planes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (passes == 2) {
    median3x3_kernel<2><<<grid, THREADS, 0, s>>>((const float*)in, (float*)out, h, w);
  } else if (passes == 1) {
    median3x3_kernel<1><<<grid, THREADS, 0, s>>>((const float*)in, (float*)out, h, w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
