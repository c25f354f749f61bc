// Kernels K2 (moment tally), K4 (vote tally) and K7 (label tally): per-label
// integer sums.
//
// K2 replaces the Pallas moment_tally_pallas (cartslam_tpu/ops/pallas/
// tally.py:231, body :178): the per-label table [1 + 2C, L] of pixel count,
// per-channel sums and per-channel sums of squares, labels outside [0, L)
// dropped.  K4 replaces vote_tally_pallas (ops/pallas/tally.py:102, body
// :61): per-label counts [L, P] of the plane classes.  K7 replaces
// label_tally_pallas (ops/pallas/tally.py:318): per-label sums of C integer
// columns of any width, here channel-major (data [C, N] -> table [C, L]);
// init_stats sends its rows [1, d, d^2] here when it has more than 8
// channels.
//
// On the TPU all three are one-hot matmuls over bf16 byte planes (K7 with a
// Khatri-Rao decomposition of the label), exact while a table entry stays
// below 2^24.  Here they are integer sums.
//
// The exact-sum rule (K2, K7): every entry is accumulated as an exact int64
// (atomicAdd on unsigned long long, two's complement) and rounded to float32
// ONCE at the end.  The JAX CPU path scatter-adds in float32 instead, which
// is exact only while an entry stays below 2^24; at full KITTI geometry the
// coordinate sums of squares (about 1247^2 x 144 per label) and any label
// holding invalid derivatives (-32768^2 = 2^30 per pixel) pass that bound,
// so there the JAX CPU and TPU tables already differ in their low bits.  The
// port's tables are the exact sums, rounded once.
//
// What bounds K2, K4 and K7 on an H100: the bytes, and at these sizes the
// fixed costs.  Each reads its inputs once (K2 at the flagship, 7 channels:
// 15 MB, 0.0045 ms at 3.35 TB/s; K4: 2.3 MB, 0.0007 ms; K7 at 19 columns:
// 37.6 MB, 0.0113 ms) and does a few integer operations a byte, so a launch
// and a memset (about 1 us each) weigh as much as the reading.  What kept them far above that was the
// reduction: one device-memory atomic per pixel (K4), or a group leader
// looping serially over its peers and then one int64 device atomic per
// table row and label group (K2, about 660k a call).
//
// Their design:
// * Block-private accumulation.  A block owns a tile of kTileRows rows of 32
//   quads (4 pixels each: 128 pixels) of the label image; the caller lays
//   the tiles out (kernels/tally.tiling: an image's row width, or contiguous
//   chunks of a flat input).  Superpixel labels are spatially coherent, so a
//   16 x 128 tile touches about 30 labels.  The block keeps their sums in
//   shared memory, 32-bit words in a kSlots-slot open-addressing map from
//   label to slot, and at the tile's end adds each used (slot, table row) to
//   device memory with one int64 atomic: about 30 x 15 a tile for K2.  A
//   label that finds no free slot in kProbes probes (random labels, a tile
//   with more labels than slots) adds straight to device memory: exact for
//   any labels, only the speed depends on coherence.
// * Per-lane shared atomics.  A lane reads its quad with one 16-byte load an
//   array (masked scalar loads at a ragged end or an unaligned row) and, for
//   each distinct label of its 4 pixels (usually one), adds their count,
//   sums and square halves (K4: per class, their count) to the label's slot
//   with 32-bit shared-memory atomics, zeros skipped.  On the H100 this beat
//   reducing over the warp first (__match_any_sync groups with a
//   __reduce_add_sync each, which serializes under divergent group masks, or
//   a segmented shuffle scan over runs of equal labels) and 64-bit shared
//   atomics; PERF.md has the times.  K2's data domain is the TPU kernel's,
//   [-32768, 32767], which keeps every 32-bit word of a slot exact (below).
// * K7 is K2's design on C columns of any int32 values: a slot keeps each
//   column as two 32-bit words, the sum of the values' low 16 bits and the
//   sum of their signed high 16 bits, both exact over a 2048-pixel tile
//   (below 2^27 and 2^26 in magnitude), joined into an int64 at the flush.
//   The lane finds its distinct labels and their slots once, then walks the
//   columns, one 16-byte load of its quad a column, channel-major as K2
//   reads its data.  A block keeps up to kLabelCols columns (32 KB of
//   sums); a wider table runs one block a (tile, column group).
// * One block a tile, between a memset of the table and (K2 and K7 with a
//   float32 output) the rounding kernel.  A single cooperative launch that zeroed,
//   tallied and rounded behind grid barriers lost to these separate
//   operations on the H100 (PERF.md).
//
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K2 / K4 tiles: kTileRows quad rows (one a warp) of 32 quads (one a
// lane).  A slot's sums over a tile fit in 32 bits: at most 2048 pixels, so
// a count below 2^12, a sum of values below 2^26 in magnitude, and square
// halves (below 2^16 and 2^14) below 2^27.
constexpr int kTileRows = 16;
constexpr int kTileThreads = 32 * kTileRows;
constexpr int kSlotBits = 7;
constexpr int kSlots = 1 << kSlotBits;
constexpr int kProbes = 8;
// K4 keeps up to kMaxP classes a slot; a wider table adds to device memory.
constexpr int kMaxP = 16;
// K7's columns a block: their slot sums take 2 x 32 x 128 words, 32 KB.
constexpr int kLabelCols = 32;

// The tiling of n pixels: quad q holds pixels 4q..4q+3; quad rows are wq
// quads wide; tiles are kTileRows quad rows x 32 quads, `cols` to a row of
// tiles (one block each).
struct Tiles {
  int n, nq, wq, cols;
};

// The quad of lane `lane` in quad row `row` of tile `tile`, or nq (no quad:
// every pixel masked) outside the image.
__device__ inline int quad_of(const Tiles& t, int tile, int row, int lane) {
  const int c = (tile % t.cols) * 32 + lane;
  const long long q = (long long)((tile / t.cols) * kTileRows + row) * t.wq + c;
  return c < t.wq && q < t.nq ? (int)q : t.nq;
}

// Quad q of a row of n ints into v[0..3]: one 16-byte load where the quad is
// whole and the row 16-byte aligned, else scalar loads with `fill` beyond n.
__device__ inline void load_quad(const int* __restrict__ p, int q, int n, bool vec, int fill,
                                 int* v) {
  const long long i = 4LL * q;
  if (vec && i + 3 < n) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p) + q);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = i + k < n ? p[i + k] : fill;
}

// Quad q of n bytes into v[0..3] (one 4-byte load where whole and aligned).
__device__ inline void load_bytes(const uint8_t* __restrict__ p, int q, int n, bool vec, int* v) {
  const long long i = 4LL * q;
  if (vec && i + 3 < n) {
    const unsigned x = __ldg(reinterpret_cast<const unsigned*>(p) + q);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = x >> (8 * k) & 255;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = i + k < n ? p[i + k] : 0;
}

// The block's slot for `label` (inserted if new), or -1 when kProbes probes
// find neither it nor a free slot.
__device__ inline int slot_of(int* keys, int label) {
  const unsigned h = ((unsigned)label * 2654435761u) >> (32 - kSlotBits);
  for (int p = 0; p < kProbes; ++p) {
    const int s = (h + p) & (kSlots - 1);
    const int seen = ((volatile int*)keys)[s];
    if (seen == label) return s;
    if (seen == -1) {
      const int old = atomicCAS(&keys[s], -1, label);
      if (old == -1 || old == label) return s;
    }
  }
  return -1;
}

// The pixels of `todo` that hold the label of its first pixel (removed from
// todo), and that label.
__device__ inline unsigned take_label(const int (&lab)[4], unsigned& todo, int& label) {
  // An unrolled pick, not lab[__ffs(todo) - 1]: a dynamic index would move
  // the array to local memory.
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (todo >> k & 1) label = lab[k];
  unsigned sel = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) sel |= (unsigned)((todo >> k & 1) && lab[k] == label) << k;
  todo &= ~sel;
  return sel;
}

// K2 on a lane's pixels: per distinct label, the count, sums and square
// halves of its pixels, added to the block's 32-bit slot sums (words: count,
// C sums, C low and C high square halves; zeros skipped), or as int64 table
// rows to device memory when the label has no slot.
template <int C>
__device__ void moment_pixels(const int (&lab)[4], const int (&val)[C][4],
                              int L, int* keys, unsigned (*sums)[kSlots],
                              unsigned long long* __restrict__ acc) {
  unsigned todo = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) todo |= (unsigned)(lab[k] >= 0 && lab[k] < L) << k;
  while (todo) {
    int label;
    const unsigned sel = take_label(lab, todo, label);
    const int slot = slot_of(keys, label);
    unsigned long long* row = acc + label;
    if (slot >= 0)
      atomicAdd(&sums[0][slot], (unsigned)__popc(sel));
    else
      atomicAdd(row, (unsigned long long)__popc(sel));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int sum = 0;
      unsigned lo = 0, hi = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (sel >> k & 1) {
          const unsigned sq = (unsigned)val[c][k] * (unsigned)val[c][k];
          sum += val[c][k];
          lo += sq & 0xffffu;
          hi += sq >> 16;
        }
      }
      if (slot >= 0) {
        if (sum) atomicAdd(&sums[1 + c][slot], (unsigned)sum);
        if (lo) atomicAdd(&sums[1 + C + c][slot], lo);
        if (hi) atomicAdd(&sums[1 + 2 * C + c][slot], hi);
      } else {
        if (sum) atomicAdd(row + (size_t)(1 + c) * L, (unsigned long long)(long long)sum);
        if (lo | hi) atomicAdd(row + (size_t)(1 + C + c) * L, ((unsigned long long)hi << 16) + lo);
      }
    }
  }
}

// K2: one tile a block, into acc (zeroed before).  Two blocks an SM (64
// registers a thread at most), so the flagship's 240 tiles run at once on
// 132 SMs.
template <int C>
__global__ void __launch_bounds__(kTileThreads, 2)
    moment_tally_kernel(const int* __restrict__ labels, const int* __restrict__ data, Tiles t,
                        int L, int vec, unsigned long long* __restrict__ acc) {
  constexpr int R = 1 + 2 * C, S = 1 + 3 * C;
  __shared__ int keys[kSlots];
  __shared__ unsigned sums[S][kSlots];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lab[4], val[C][4];
  const int q = quad_of(t, blockIdx.x, warp, lane);
  load_quad(labels, q, t.n, vec, -1, lab);
#pragma unroll
  for (int c = 0; c < C; ++c) load_quad(data + (size_t)c * t.n, q, t.n, vec, 0, val[c]);
  for (int s = threadIdx.x; s < kSlots; s += kTileThreads) keys[s] = -1;
  for (int e = threadIdx.x; e < S * kSlots; e += kTileThreads) sums[e >> kSlotBits][e & (kSlots - 1)] = 0;
  __syncthreads();
  moment_pixels<C>(lab, val, L, keys, sums, acc);
  __syncthreads();
  // Table row r of slot s: its count, a sum (sign-extended), or a square sum
  // joined from its halves.
  for (int e = threadIdx.x; e < R * kSlots; e += kTileThreads) {
    const int s = e & (kSlots - 1), r = e >> kSlotBits;
    if (sums[0][s] == 0) continue;
    const unsigned long long v =
        r == 0 ? sums[0][s]
        : r <= C ? (unsigned long long)(long long)(int)sums[r][s]
                 : ((unsigned long long)sums[r + C][s] << 16) + sums[r][s];
    if (v != 0) atomicAdd(&acc[(size_t)r * L + keys[s]], v);
  }
}

// K4 on a lane's pixels: per distinct (label, class), its pixel count added
// to the block's slot counts, or to device memory when the label has no slot
// (or the table more than kMaxP classes).
__device__ void vote_pixels(const int (&lab)[4], const int (&vote)[4], int L,
                            int P, int* keys, int (*counts)[kSlots], int* __restrict__ out) {
  unsigned todo = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    todo |= (unsigned)(lab[k] >= 0 && lab[k] < L && vote[k] < P) << k;
  while (todo) {
    int label = 0, v = 0;
#pragma unroll
    for (int k = 3; k >= 0; --k)
      if (todo >> k & 1) label = lab[k], v = vote[k];
    unsigned sel = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sel |= (unsigned)((todo >> k & 1) && lab[k] == label && vote[k] == v) << k;
    todo &= ~sel;
    const int slot = P <= kMaxP ? slot_of(keys, label) : -1;
    if (slot >= 0)
      atomicAdd(&counts[v][slot], __popc(sel));
    else
      atomicAdd(&out[(size_t)label * P + v], __popc(sel));
  }
}

// K4: one tile a block, into out (zeroed before).
__global__ void __launch_bounds__(kTileThreads)
    vote_tally_kernel(const int* __restrict__ labels, const uint8_t* __restrict__ votes, Tiles t,
                      int L, int P, int vec, int* __restrict__ out) {
  __shared__ int keys[kSlots];
  __shared__ int counts[kMaxP][kSlots];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kept = min(P, kMaxP) * kSlots;
  int lab[4], vote[4];
  const int q = quad_of(t, blockIdx.x, warp, lane);
  load_quad(labels, q, t.n, vec, -1, lab);
  load_bytes(votes, q, t.n, vec, vote);
  for (int s = threadIdx.x; s < kSlots; s += kTileThreads) keys[s] = -1;
  for (int e = threadIdx.x; e < kept; e += kTileThreads) counts[e >> kSlotBits][e & (kSlots - 1)] = 0;
  __syncthreads();
  vote_pixels(lab, vote, L, P, keys, counts, out);
  __syncthreads();
  for (int e = threadIdx.x; e < kept; e += kTileThreads) {
    const int s = e & (kSlots - 1), p = e >> kSlotBits;
    const int c = counts[p][s];
    if (c != 0) atomicAdd(&out[(size_t)keys[s] * P + p], c);
  }
}

// K7: one (tile, group of kLabelCols columns) a block, into acc [C, L]
// (zeroed before).
__global__ void __launch_bounds__(kTileThreads, 2)
    label_tally_kernel(const int* __restrict__ labels, const int* __restrict__ values, Tiles t,
                       int C, int L, int vec, unsigned long long* __restrict__ acc) {
  __shared__ int keys[kSlots];
  __shared__ unsigned sums[2 * kLabelCols][kSlots];  // a column's low and high half sums
  const int c0 = blockIdx.y * kLabelCols, nc = min(kLabelCols, C - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lab[4];
  const int q = quad_of(t, blockIdx.x, warp, lane);
  load_quad(labels, q, t.n, vec, -1, lab);
  for (int s = threadIdx.x; s < kSlots; s += kTileThreads) keys[s] = -1;
  for (int e = threadIdx.x; e < 2 * nc * kSlots; e += kTileThreads)
    sums[e >> kSlotBits][e & (kSlots - 1)] = 0;
  __syncthreads();
  // The lane's distinct labels (usually one): their pixels, label and slot.
  unsigned todo = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) todo |= (unsigned)(lab[k] >= 0 && lab[k] < L) << k;
  unsigned sel[4];
  int glab[4], slot[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    sel[g] = 0, glab[g] = 0, slot[g] = -1;
    if (todo) {
      sel[g] = take_label(lab, todo, glab[g]);
      slot[g] = slot_of(keys, glab[g]);
    }
  }
  const int* col = values + (size_t)c0 * t.n;
  for (int j = 0; j < nc; ++j, col += t.n) {
    int v[4];
    load_quad(col, q, t.n, vec, 0, v);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (sel[g] == 0) continue;
      unsigned lo = 0;
      int hi = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (sel[g] >> k & 1) {
          lo += (unsigned)v[k] & 0xffffu;
          hi += v[k] >> 16;
        }
      }
      if (slot[g] >= 0) {
        if (lo) atomicAdd(&sums[2 * j][slot[g]], lo);
        if (hi) atomicAdd(&sums[2 * j + 1][slot[g]], (unsigned)hi);
      } else {
        const long long sum = (long long)hi * 65536 + lo;
        if (sum) atomicAdd(&acc[(size_t)(c0 + j) * L + glab[g]], (unsigned long long)sum);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nc * kSlots; e += kTileThreads) {
    const int s = e & (kSlots - 1), j = e >> kSlotBits;
    if (keys[s] == -1) continue;
    const long long v = (long long)(int)sums[2 * j + 1][s] * 65536 + sums[2 * j][s];
    if (v != 0) atomicAdd(&acc[(size_t)(c0 + j) * L + keys[s]], (unsigned long long)v);
  }
}

__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ll2float_rn((long long)acc[i]);
}

const void* moment_kernel(int C) {
  switch (C) {
    case 1: return (const void*)moment_tally_kernel<1>;
    case 2: return (const void*)moment_tally_kernel<2>;
    case 3: return (const void*)moment_tally_kernel<3>;
    case 4: return (const void*)moment_tally_kernel<4>;
    case 5: return (const void*)moment_tally_kernel<5>;
    case 6: return (const void*)moment_tally_kernel<6>;
    case 7: return (const void*)moment_tally_kernel<7>;
    case 8: return (const void*)moment_tally_kernel<8>;
  }
  return nullptr;
}

}  // namespace

// K2.  labels int32 [N], data int32 [C, N] (C <= 8, values in [-32768,
// 32767]) in `count` tiles of wq-quad rows (cols tiles a row), acc int64
// scratch [1 + 2C, L], out float32 [1 + 2C, L], or null to leave the exact
// int64 sums in acc.
extern "C" int moment_tally(const void* labels, const void* data, int N, int C, int L, int wq,
                            int cols, int count, void* acc, void* out, void* stream) {
  const void* kernel = moment_kernel(C);
  if (kernel == nullptr || wq < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int table = (1 + 2 * C) * L;
  Tiles t{N, (N + 3) / 4, wq, cols};
  int vec = (uintptr_t)labels % 16 == 0 && (uintptr_t)data % 16 == 0 && N % 4 == 0;
  const int* lab = (const int*)labels;
  const int* dat = (const int*)data;
  unsigned long long* a = (unsigned long long*)acc;
  void* args[] = {&lab, &dat, &t, &L, &vec, &a};
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)table * sizeof(unsigned long long), s);
  if (e == cudaSuccess && count > 0) e = cudaLaunchKernel(kernel, count, kTileThreads, args, 0, s);
  if (e == cudaSuccess && out != nullptr && table > 0)
    to_float_kernel<<<(table + 255) / 256, 256, 0, s>>>(a, (float*)out, table);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// K4.  labels int32 [N], votes uint8 [N] in tiles as K2's, out int32 [L, P].
extern "C" int vote_tally(const void* labels, const void* votes, int N, int L, int P, int wq,
                          int cols, int count, void* out, void* stream) {
  if (wq < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)L * P * sizeof(int), s);
  if (e == cudaSuccess && count > 0)
    vote_tally_kernel<<<count, kTileThreads, 0, s>>>(
        (const int*)labels, (const uint8_t*)votes, Tiles{N, (N + 3) / 4, wq, cols}, L, P,
        (uintptr_t)labels % 16 == 0 && (uintptr_t)votes % 4 == 0, (int*)out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// K7.  labels int32 [N], values int32 [C, N] in tiles as K2's, acc int64
// scratch [C, L], out float32 [C, L], or null to leave the exact int64 sums
// in acc.
extern "C" int label_tally(const void* labels, const void* values, int N, int C, int L, int wq,
                           int cols, int count, void* acc, void* out, void* stream) {
  if (wq < 1 || C < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int table = C * L;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)table * sizeof(unsigned long long), s);
  if (e == cudaSuccess && count > 0 && C > 0)
    label_tally_kernel<<<dim3(count, (C + kLabelCols - 1) / kLabelCols), kTileThreads, 0, s>>>(
        (const int*)labels, (const int*)values, Tiles{N, (N + 3) / 4, wq, cols}, C, L,
        (uintptr_t)labels % 16 == 0 && (uintptr_t)values % 16 == 0 && N % 4 == 0,
        (unsigned long long*)acc);
  if (e == cudaSuccess && out != nullptr && table > 0)
    to_float_kernel<<<(table + 255) / 256, 256, 0, s>>>((const unsigned long long*)acc,
                                                        (float*)out, table);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The rounding step of K2 and K7 on its own: out[i] = float32(acc[i]), n
// entries.  The height-sharded mode sums the shards' int64 tables first, so
// the psum'd table is rounded once, as the full frame's is.
extern "C" int tally_to_float(const void* acc, void* out, int n, void* stream) {
  if (n > 0)
    to_float_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)acc, (float*)out, n);
  return (int)cudaGetLastError();
}
