// The 9x7 census of one or two uint8 [h, w] images: for each pixel two int32
// words, bit k set when the k-th neighbour of its window (row-major over dy
// -3..3, dx -4..4, the centre skipped) is strictly greater than the centre;
// bits 0-30 in word 0, bits 31-61 in word 1 (word k / 31, shift k % 31).
//
// Replaces no TPU kernel: the JAX package computes the census with plain jnp
// ops (cartslam_tpu/ops/stereo.py `census_transform`, 62 shifted compares,
// shifts and ORs on an edge-padded image), which XLA fuses on the TPU.  The
// port's plain version is the same chain as ~257 tensor ops an image.  Here
// both images of a stereo pair are one launch.
//
// What bounds it on this card: the bytes, one read of each image and two
// int32 words written a pixel (8.4 MB for a KITTI pair, 2.5 us at 3.35
// TB/s); the 62 compares, shifts and ORs a pixel are of the same order.  At
// one launch a pair the design keeps each input byte read from device memory
// about once and the compares out of device memory: a block owns a TH x TW
// output tile of one image (the images are the grid's z axis), loads the
// (TH + 6) x (TW + 8) input tile with edge-clamped rows and columns into
// shared memory as int32, and each thread builds the 62 bits of 4 adjacent
// pixels from three 16-byte shared loads a window row.  The words are staged
// in shared memory, so that the stores to device memory are coalesced rows.
//
// Edges: the tile's value at (r, c) is the image at the *clamped* global
// position, which is the plain version's edge padding (`pad_edge`) at every
// border and for h or w as small as 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RY = 3, RX = 4;         // the window's half height and half width
constexpr int TH = 16, TW = 64;       // an output tile
constexpr int PX = 4;                 // adjacent pixels a thread, along a row
constexpr int THREADS = TH * TW / PX;  // 256
constexpr int IH = TH + 2 * RY, IW = TW + 2 * RX;  // the input tile, 22 x 72
constexpr int SPAN = PX + 2 * RX;     // a thread's window row: 12 values
static_assert(IW % 4 == 0 && TW % PX == 0 && SPAN % 4 == 0, "16-byte shared loads");

__device__ __forceinline__ int clamp_to(int v, int n) { return min(max(v, 0), n - 1); }

__global__ void __launch_bounds__(THREADS)
census_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
              int32_t* __restrict__ out, int h, int w) {
  __shared__ __align__(16) int s_in[IH * IW];
  __shared__ __align__(16) int s_out[2][TH * TW];

  const uint8_t* img = blockIdx.z == 0 ? a : b;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  // s_in[r][c] = img[clamp(y0 - RY + r)][clamp(x0 - RX + c)]
  for (int k = threadIdx.x; k < IH * IW; k += THREADS) {
    const int r = k / IW, c = k % IW;
    s_in[k] = img[(size_t)clamp_to(y0 - RY + r, h) * w + clamp_to(x0 - RX + c, w)];
  }
  __syncthreads();

  // This thread's pixels: tile row i, columns j .. j + PX - 1.  The window of
  // column j + p spans s_in rows i .. i + 2 RY and columns j + p .. j + p + 2 RX.
  const int i = threadIdx.x / (TW / PX), j = threadIdx.x % (TW / PX) * PX;
  int centre[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) centre[p] = s_in[(i + RY) * IW + j + RX + p];
  uint32_t w0[PX] = {}, w1[PX] = {};
#pragma unroll
  for (int dy = 0; dy <= 2 * RY; ++dy) {
    int v[SPAN];
    const int4* q = reinterpret_cast<const int4*>(s_in + (i + dy) * IW + j);
#pragma unroll
    for (int t = 0; t < SPAN / 4; ++t) {
      const int4 u = q[t];
      v[4 * t] = u.x; v[4 * t + 1] = u.y; v[4 * t + 2] = u.z; v[4 * t + 3] = u.w;
    }
#pragma unroll
    for (int dx = 0; dx <= 2 * RX; ++dx) {
      const int pos = dy * (2 * RX + 1) + dx, centre_pos = RY * (2 * RX + 1) + RX;
      if (pos == centre_pos) continue;
      const int k = pos - (pos > centre_pos);  // the bit, the centre skipped
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        // The bits are disjoint, so adding them sets them as ORs would.
        // Written as ORs, the compares' predicates were packed into words
        // (P2R) by ptxas 12.8 at -O3, which set wrong bits in half the
        // pixels (right at -O0); the sums compile without P2R.
        const uint32_t bit = v[p + dx] > centre[p];
        if (k < 31) w0[p] += bit << k;
        else w1[p] += bit << (k - 31);
      }
    }
  }
  reinterpret_cast<int4*>(s_out[0] + i * TW + j)[0] =
      make_int4((int)w0[0], (int)w0[1], (int)w0[2], (int)w0[3]);
  reinterpret_cast<int4*>(s_out[1] + i * TW + j)[0] =
      make_int4((int)w1[0], (int)w1[1], (int)w1[2], (int)w1[3]);
  __syncthreads();

  // out[z][word][y][x], consecutive threads on consecutive columns.
  int32_t* o = out + (size_t)blockIdx.z * 2 * h * w;
  for (int k = threadIdx.x; k < TH * TW; k += THREADS) {
    const int y = y0 + k / TW, x = x0 + k % TW;
    if (y < h && x < w) {
      o[(size_t)y * w + x] = s_out[0][k];
      o[(size_t)h * w + (size_t)y * w + x] = s_out[1][k];
    }
  }
}

}  // namespace

// a, b: uint8 [h, w] on the card, contiguous (b is read only when images is
// 2); out: int32 [images, 2, h, w], contiguous, not overlapping them;
// h, w >= 1, h <= 65535 x 16 (the wrapper checks).
extern "C" int census(const void* a, const void* b, void* out, int images, int h, int w,
                      void* stream) {
  if (images < 1 || images > 2 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, images);
  census_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)(images == 2 ? b : a), (int32_t*)out, h, w);
  return (int)cudaGetLastError();
}
