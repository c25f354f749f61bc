// Kernel K1: census-Hamming semi-global matching, 4 paths, then WTA + LR.
// Kernel K6: the same 4 paths, summed into the aggregated cost volume.
//
// K1 replaces the Pallas TPU kernels of cartslam_tpu/ops/pallas/sgm.py
// (sgm_fused_pallas :654 with _make_hsweep :97, _make_vsweep :172,
// _make_btwta_kernel :201) and ops/pallas/wta.py:wta_lr_row :66.
// Bit-identical to the XLA path of ops/stereo.py (sgm_disparity,
// backend="xla"), which the plain version in cartslam_tpu_torch/ops/stereo.py
// follows line by line.
//
// K6 replaces sgm_aggregate_pallas (ops/pallas/sgm.py:510): census words in,
// the 4-path aggregated cost out as int16 [H, W, D] with d ascending (the
// TPU's reversed-d layout, flip=False, is not carried over).  It runs the
// path kernel below with int16 path storage, so it takes the JAX op's whole
// P2 range (each path value <= 62 + P2 <= 8062, the 4-path sum < 32767),
// then sgm_sum4 adds the four volumes.  What bounds it: the path recurrence's
// serial steps, as for K1, and then the sum's device-memory traffic (four
// int16 volumes read, one written: 1.2 GB at 376x1248x256).
//
// K5 replaces sgm_fused_pallas_sharded (ops/pallas/sgm.py:320, with
// _make_vcarry :241, _make_vsweep_cin :267, _make_btwta_cin_kernel :288): K1
// on one row shard of a height-sharded frame, the two vertical paths seeded
// with the predecessor shard's final carry (the split-scan chain of
// parallel/sgm_sharded.py).  It is K1's path kernel with three options:
// carry-in pointers for the vertical directions (int32 [W, D]; null is a zero
// carry), carry-out pointers, and no volume pointer for the settle sweeps
// (sgm_vcarry: the two vertical directions only, emitting just the final
// carries).  sgm_sharded_paths runs all four directions with the settled
// carries, then sgm_wta runs as it is.  The TPU's transposed [W, h] census,
// VMEM W tiles and 1-row blocks are not carried over.  A carry-in must set
// the first step's path minimum m to the carry's minimum over d (lanes with
// d >= D hold kBig and load nothing), as _recurrence does; K1's zero carry
// has m = 0.  The uint8 storage still holds: every step's value is at most
// COST + P2 <= 62 + P2, whatever the carry.  What bounds it: the chain's
// n-1 settle rounds, each sweeping every shard's rows serially (on one card
// the shards' launches queue on one stream), on top of K1's own bound.
//
// What bounds it on an H100: the path recurrence is serial along each
// scanline (1248 steps for a KITTI row, 376 for a column), so latency per
// step, not bandwidth, bounds the path kernel; the four uint8 path volumes
// (4 x H x W x D bytes, 480 MB at 376x1248x256) are written once and read by
// the WTA kernel, so device-memory traffic bounds the WTA kernel.
//
// Design:
//  * sgm_paths: one warp per scanline and direction (2H + 2W warps, all
//    resident at once).  Disparities are interleaved over lanes
//    (d = 32k + lane, k < 8), so d+-1 are the neighbouring lanes (__shfl) and
//    the path minimum is a warp reduction; no shared memory, no block
//    barriers.  The Hamming cost is computed on the fly with __popc; a
//    candidate reading left of the right image costs 62.  Each sweep starts
//    at the real first column/row with a zero carry, as the XLA scan does.
//    Path values are bounded by 62 + P2 and stored as uint8.
//  * sgm_wta: one block per row, one warp per pixel.  A first pass computes
//    the right-view winner best_r[x'] (S[x' + d + minD, d], 32767 past the
//    edge) into shared memory; the second pass takes the keyed minimum
//    (value * D + d: lowest-d tie-break), the OpenCV uniqueness test, the
//    quadratic subpixel fit with FLOOR division, cols >= best + minD, and
//    the +-1 left-right agreement.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kMaxK = 8;  // disparities per lane: D <= 256
constexpr int kBig = 1 << 20;
constexpr int kCostInvalid = 62;
constexpr int kBig16 = 32767;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// T: the path value's storage type, uint8_t for K1 and K5 (P2 <= 193),
// int16_t for K6.  first_warp: 0 runs all four directions, 2H only the two
// vertical ones.  cin/cout (K5): per-column carries [W, D] of the vertical
// directions, or null (zero carry in; no carry out).  vol null: no volume
// writes (the settle sweeps).
template <typename T>
__global__ void sgm_paths_kernel(const int* __restrict__ l0, const int* __restrict__ l1,
                                 const int* __restrict__ r0, const int* __restrict__ r1,
                                 T* __restrict__ vol, const int* __restrict__ cin_tb,
                                 const int* __restrict__ cin_bt, int* __restrict__ cout_tb,
                                 int* __restrict__ cout_bt, int H, int W, int D,
                                 int minD, int p1, int p2, int first_warp) {
  const int warp = first_warp + ((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= 2 * H + 2 * W) return;  // warp-uniform
  int dir, line;
  if (warp < 2 * H) {
    dir = warp / H;  // 0: left->right, 1: right->left
    line = warp % H;
  } else {
    dir = 2 + (warp - 2 * H) / W;  // 2: top->bottom, 3: bottom->top
    line = (warp - 2 * H) % W;
  }
  const int steps = dir < 2 ? W : H;
  const int nk = (D + 31) / 32;
  T* out = vol != nullptr ? vol + (size_t)dir * H * W * D : nullptr;
  const int* cin = dir == 2 ? cin_tb : (dir == 3 ? cin_bt : nullptr);
  int* cout = dir == 2 ? cout_tb : (dir == 3 ? cout_bt : nullptr);

  int L[kMaxK];
  int m = 0;  // min over d of the carry
  if (cin != nullptr) {  // warp-uniform
    int cmin = kBig;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const int d = k * 32 + lane;
      L[k] = d < D ? cin[(size_t)line * D + d] : kBig;
      cmin = min(cmin, L[k]);
    }
    m = warp_min(cmin);
  } else {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) L[k] = (k * 32 + lane < D) ? 0 : kBig;
  }

  for (int s = 0; s < steps; ++s) {
    int y, x;
    if (dir == 0) { y = line; x = s; }
    else if (dir == 1) { y = line; x = W - 1 - s; }
    else if (dir == 2) { y = s; x = line; }
    else { y = H - 1 - s; x = line; }
    const int pix = y * W + x;
    const unsigned a0 = (unsigned)l0[pix], a1 = (unsigned)l1[pix];

    int nl[kMaxK];
    int lmin = kBig;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < nk) {  // warp-uniform
        int dn = __shfl_up_sync(kFull, L[k], 1);    // d - 1 (lane - 1)
        int up = __shfl_down_sync(kFull, L[k], 1);  // d + 1 (lane + 1)
        int prev_last = kBig, next_first = kBig;
        if (k > 0) prev_last = __shfl_sync(kFull, L[k > 0 ? k - 1 : 0], 31);
        if (k + 1 < kMaxK && k + 1 < nk)
          next_first = __shfl_sync(kFull, L[k + 1 < kMaxK ? k + 1 : k], 0);
        if (lane == 0) dn = prev_last;
        if (lane == 31) up = next_first;
        const int d = k * 32 + lane;
        int v = kBig;
        if (d < D) {
          const int xr = x - minD - d;
          int c = kCostInvalid;
          if (xr >= 0) {
            const int q = y * W + xr;
            c = __popc(a0 ^ (unsigned)r0[q]) + __popc(a1 ^ (unsigned)r1[q]);
          }
          const int best = min(min(L[k], min(dn, up) + p1), m + p2);
          v = c + best - m;
          if (out != nullptr) out[(size_t)pix * D + d] = (T)v;
        }
        nl[k] = v;
        lmin = min(lmin, v);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < nk) L[k] = nl[k];
    m = warp_min(lmin);
  }
  if (cout != nullptr) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const int d = k * 32 + lane;
      if (d < D) cout[(size_t)line * D + d] = L[k];
    }
  }
}

// out[i] = v[i] + v[n + i] + v[2n + i] + v[3n + i]; eight values per thread
// through 16-byte loads (n % 8 == 0), else one.
__global__ void sgm_sum4_vec_kernel(const int16_t* __restrict__ v, int16_t* __restrict__ out,
                                    size_t n) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  int4 q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = *reinterpret_cast<const int4*>(v + k * n + i);
  int4 r;
  int16_t* pr = reinterpret_cast<int16_t*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) s += reinterpret_cast<const int16_t*>(&q[k])[j];
    pr[j] = (int16_t)s;
  }
  *reinterpret_cast<int4*>(out + i) = r;
}

__global__ void sgm_sum4_kernel(const int16_t* __restrict__ v, int16_t* __restrict__ out,
                                size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int16_t)((int)v[i] + v[n + i] + v[2 * n + i] + v[3 * n + i]);
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void sgm_wta_kernel(const uint8_t* __restrict__ vol, int16_t* __restrict__ out,
                               int H, int W, int D, int minD, int uniqueness,
                               int subpixel, int lr_check) {
  extern __shared__ int best_r[];  // [W]
  const int y = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const size_t plane = (size_t)H * W * D;
  const uint8_t* v0 = vol;
  const uint8_t* v1 = vol + plane;
  const uint8_t* v2 = vol + 2 * plane;
  const uint8_t* v3 = vol + 3 * plane;
  const size_t row = (size_t)y * W;
  auto S = [&](int x, int d) -> int {
    const size_t i = (row + x) * D + d;
    return (int)v0[i] + (int)v1[i] + (int)v2[i] + (int)v3[i];
  };

  if (lr_check) {
    for (int xr = wid; xr < W; xr += nw) {
      int key = INT_MAX;
      for (int d = lane; d < D; d += 32) {
        const int xs = xr + d + minD;
        const int s = xs < W ? S(xs, d) : kBig16;
        key = min(key, s * D + d);
      }
      key = warp_min(key);
      if (lane == 0) best_r[xr] = key % D;
    }
    __syncthreads();
  }

  for (int x = wid; x < W; x += nw) {
    int key = INT_MAX;
    for (int d = lane; d < D; d += 32) key = min(key, S(x, d) * D + d);
    key = warp_min(key);
    const int best = key % D;
    const int min_s = key / D;
    int second = kBig16;
    for (int d = lane; d < D; d += 32)
      if (abs(d - best) > 1) second = min(second, S(x, d));
    second = warp_min(second);
    if (lane == 0) {
      bool ok = second * (100 - uniqueness) >= min_s * 100;
      int delta = 0;
      if (subpixel && best > 0 && best < D - 1) {
        const int sm = S(x, best - 1), sp = S(x, best + 1);
        const int denom2 = max(sm + sp - 2 * min_s, 1);
        delta = floor_div((sm - sp) * 16 + denom2, denom2 * 2);
      }
      ok = ok && x >= best + minD;
      if (lr_check) {
        const int xr = x - best - minD;
        ok = ok && xr >= 0 && abs(best_r[xr] - best) <= 1;
      }
      out[row + x] = (int16_t)(ok ? (best + minD) * 16 + delta : -32768);
    }
  }
}

constexpr int kPathThreads = 128;

// Launches the uint8 path kernel over warps [first_warp, 2H + 2W).
int launch_paths_u8(const void* l0, const void* l1, const void* r0, const void* r1,
                    void* vol, const void* cin_tb, const void* cin_bt, void* cout_tb,
                    void* cout_bt, int H, int W, int D, int minD, int p1, int p2,
                    int first_warp, void* stream) {
  const int warps = 2 * H + 2 * W - first_warp;
  const int blocks = (warps * 32 + kPathThreads - 1) / kPathThreads;
  sgm_paths_kernel<uint8_t><<<blocks, kPathThreads, 0, (cudaStream_t)stream>>>(
      (const int*)l0, (const int*)l1, (const int*)r0, (const int*)r1, (uint8_t*)vol,
      (const int*)cin_tb, (const int*)cin_bt, (int*)cout_tb, (int*)cout_bt, H, W, D, minD,
      p1, p2, first_warp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sgm_paths(const void* l0, const void* l1, const void* r0, const void* r1,
                         void* vol, int H, int W, int D, int minD, int p1, int p2,
                         void* stream) {
  return launch_paths_u8(l0, l1, r0, r1, vol, nullptr, nullptr, nullptr, nullptr, H, W, D,
                         minD, p1, p2, 0, stream);
}

// K5, the output sweeps: the four paths of one row shard into vol (uint8
// [4, H, W, D]), the vertical ones seeded with cin_tb / cin_bt (int32 [W, D],
// or null for a zero carry).  sgm_wta follows.
extern "C" int sgm_sharded_paths(const void* l0, const void* l1, const void* r0,
                                 const void* r1, void* vol, const void* cin_tb,
                                 const void* cin_bt, int H, int W, int D, int minD, int p1,
                                 int p2, void* stream) {
  return launch_paths_u8(l0, l1, r0, r1, vol, cin_tb, cin_bt, nullptr, nullptr, H, W, D,
                         minD, p1, p2, 0, stream);
}

// K5, one settle round: both vertical paths of one row shard from cin_tb /
// cin_bt (or zero), writing only their final carries cout_tb / cout_bt
// (int32 [W, D]).
extern "C" int sgm_vcarry(const void* l0, const void* l1, const void* r0, const void* r1,
                          const void* cin_tb, const void* cin_bt, void* cout_tb,
                          void* cout_bt, int H, int W, int D, int minD, int p1, int p2,
                          void* stream) {
  return launch_paths_u8(l0, l1, r0, r1, nullptr, cin_tb, cin_bt, cout_tb, cout_bt, H, W, D,
                         minD, p1, p2, 2 * H, stream);
}

// K6. vol: int16 scratch [4, H, W, D]; out: int16 [H, W, D].
extern "C" int sgm_aggregate(const void* l0, const void* l1, const void* r0, const void* r1,
                             void* vol, void* out, int H, int W, int D, int minD, int p1,
                             int p2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int warps = 2 * H + 2 * W;
  sgm_paths_kernel<int16_t>
      <<<(warps * 32 + kPathThreads - 1) / kPathThreads, kPathThreads, 0, s>>>(
          (const int*)l0, (const int*)l1, (const int*)r0, (const int*)r1, (int16_t*)vol,
          nullptr, nullptr, nullptr, nullptr, H, W, D, minD, p1, p2, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)H * W * D;
  if (n % 8 == 0)
    sgm_sum4_vec_kernel<<<(unsigned)((n / 8 + 255) / 256), 256, 0, s>>>(
        (const int16_t*)vol, (int16_t*)out, n);
  else
    sgm_sum4_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        (const int16_t*)vol, (int16_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int sgm_wta(const void* vol, void* out, int H, int W, int D, int minD,
                       int uniqueness, int subpixel, int lr_check, void* stream) {
  const size_t smem = lr_check ? (size_t)W * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sgm_wta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sgm_wta_kernel<<<H, 256, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)vol, (int16_t*)out, H, W, D, minD, uniqueness, subpixel, lr_check);
  return (int)cudaGetLastError();
}
