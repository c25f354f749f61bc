// Kernel K1: census-Hamming semi-global matching, 4 paths, then WTA + LR.
// Kernel K6: the same 4 paths, summed into the aggregated cost volume.
// Kernel K5: K1 on one row shard, vertical carries handed between shards.
//
// K1 replaces the Pallas TPU kernels of cartslam_tpu/ops/pallas/sgm.py
// (sgm_fused_pallas :654 with _make_hsweep :97, _make_vsweep :172,
// _make_btwta_kernel :201) and ops/pallas/wta.py:wta_lr_row :66.
// Bit-identical to the XLA path of ops/stereo.py (sgm_disparity,
// backend="xla"), which the plain version in cartslam_tpu_torch/ops/stereo.py
// follows line by line.  Every value is an integer, so any order of the min
// and sum operations is exact: bit-equality is a matter of indexing.
//
// K6 replaces sgm_aggregate_pallas (ops/pallas/sgm.py:510): census words in,
// the 4-path aggregated cost out as int16 [H, W, D] with d ascending (the
// TPU's reversed-d layout, flip=False, is not carried over).  It runs the
// path kernels below in their accumulate form (kAcc), which add the paths
// into the output itself: no path volume, no summing pass.  It takes the JAX
// op's whole P2 range: each path value is a non-negative integer <= 62 + P2
// <= 8062, so every partial sum of the four is < 32767, a 32-bit add of two
// packed int16 pairs carries nothing between the halves, and every order of
// the adds is exact.
//  * Row pass (sgm_hpaths_kernel<int16_t, KP, true>): the block's two warps
//    sweep the row from its two ends.  In the first W / 2 steps each warp
//    stores its own values to the cells it reaches first; a __syncthreads()
//    at the midpoint makes them visible to the other warp, which from then on
//    adds its value to the cell and stores the sum.  Those cells were stored
//    long before, so they come from device memory: a lane copies them 15
//    steps ahead with cp.async into a ring of its own in shared memory.  The
//    middle cell of an odd W is reached by both warps at once:
//    left-to-right stores, a second barrier, right-to-left adds.
//  * Column pass (sgm_vpaths_acc_kernel): one block of 12 warps holds both
//    vertical directions of 6 columns (two census rings), and adds both into
//    the row sums under the per-step barrier the rings already take.  A cell
//    is reached by the two directions at steps a and H-1-a.  Each lane's
//    cells ride in its step's cp.async group, 3 steps ahead, except at the
//    two steps after H / 2 - 1, whose cell the other direction may have
//    reached less than 3 steps before: those load after their step's
//    barrier, and the middle row of an odd H is added top-down first, then,
//    after a second barrier, bottom-up.
//  * Each pass's first half, middle and second half are separate loops: the
//    sweeps are latency- and issue-bound, and a per-step test of where a
//    step lies cost a quarter of the row pass (PERF.md).
//  Bytes: the row pass writes, reads and writes the output once each, the
//  column pass reads and writes it twice: 1.68 GB at 376x1248, D = 256,
//  where four int16 scratch planes and a summing pass moved 2.16 GB, and a
//  call allocates only its output.  Lanes store to the output's stride D
//  with one vector access where D is a multiple of their run of
//  disparities, else with masked scalar accesses (and load in the step).
//  Zeroing the output and adding every direction with 32-bit atomics of
//  packed pairs, in any order, took twice as long (PERF.md).
//
// K5 replaces sgm_fused_pallas_sharded (ops/pallas/sgm.py:320, with
// _make_vcarry :241, _make_vsweep_cin :267, _make_btwta_cin_kernel :288): K1
// on one row shard of a height-sharded frame, the two vertical paths seeded
// with the predecessor shard's final carry (the split-scan chain of
// parallel/sgm_sharded.py).  The column paths take carry-in pointers
// (int32 [W, D]; null is a zero carry).  A carry-in sets the first step's
// path minimum m to the carry's minimum over d (d >= D holds kBig and loads
// nothing), as _recurrence does; a zero carry has m = 0.  The uint8 storage
// holds whatever the carry: every step's value is at most COST + P2 <=
// 62 + P2.
//  * The settle sweeps (sgm_vcarry, sgm_settle_kernel): the column-path
//    body with no volume, writing only the final carries, one launch of
//    the direction(s) whose carry-out pointer is non-null.  The chain
//    sweeps only what it keeps: in round j shard j sweeps top-down and
//    shard n-1-j bottom-up, 2(n-1) direction-sweeps a frame (14 at n = 8),
//    each 47 steps deep on 156 blocks, one after another.
//  * The output pass is split: the row paths (planes 0-1, sgm_sharded_rows)
//    need no carry and are launched before the chain on a side stream of
//    the shard; the seeded column paths (planes 2-3, sgm_sharded_cols) and
//    sgm_wta follow the chain on that side stream (kernels/sgm.py).  A
//    shard's 47-row grids (47 row blocks, 47 WTA blocks) fill a third of
//    the SMs; the eight shards' side streams run them side by side, and
//    the row paths under the latency-bound chain.
//
// What bounds it on an H100.  The four uint8 path volumes (4 x H x W x D
// bytes, 480 MB at 376x1248x256) are written once by the path kernels and
// read once by the WTA kernel: 0.143 ms each way at 3.35 TB/s, the floor of
// both kernels, and what bounds the WTA.  The path kernels are bound by
// instruction issue: a cell costs each direction about 12 integer
// instructions, two of them population counts, which issue at a quarter of
// the rate of the others (16 a clock per SM on compute capability 9.0, CUDA
// C++ Programming Guide).  The recurrence is serial along each scanline
// (1248 steps for a KITTI row), and the 2 x 376 row scanlines are 752 warps
// for the card's 528 warp schedulers: a scheduler that holds two of them
// issues both, so a row sweep takes about two warps' issue time a step.
//
// Design:
//  * Path kernels, one warp per scanline and direction.  Each lane holds KP
//    consecutive disparities, d = KP * lane + k (KP = 8 at D = 256), so d-1
//    and d+1 are registers of the same lane except at the lane's two ends:
//    a step costs 2 shuffles and one __reduce_min_sync for the path minimum.
//    Each lane writes its KP values with one store of KP bytes (K6: adds
//    them to the output's int16 cells), so a warp writes one contiguous run
//    per step.
//    - Row paths (sgm_hpaths): one block per image row holds both of its
//      directions.  The row's census words are staged in shared memory once,
//      the right view as (r0, r1) pairs with one pad pair after every 8
//      (lanes 8 pairs apart then fall in distinct banks).  Each lane keeps a
//      sliding window of its KP right pairs, so a step loads one new pair
//      and the left pair, one step ahead of their use.
//    - Column paths (sgm_vpaths): one block per 8 neighbouring columns and
//      direction.  Each step's right-row segment [x0 - minD - 32 KP + 1,
//      x0 + 7 - minD] and the 8 left pairs are copied into a 4-stage ring in
//      shared memory with cp.async, 3 steps ahead of the step that uses them;
//      each thread's copies are fixed once but for the row.  The column
//      sweeps are many (2W warps) and short, so issue, not a step's latency,
//      bounds them: a lane keeps its values as 16-bit pairs and runs the
//      recurrence with Hopper's DPX instructions (__viaddmin_u16x2,
//      __vimin3_u16x2), two disparities an instruction.  (The row sweeps
//      keep int32 values: on the same 16-bit pairs they took 13% longer on
//      an H100, 0.46 ms against 0.41 at 376x1248, D = 256; PERF.md.)
//    - The row sweeps, then the column sweeps, on the caller's stream.  Both
//      are issue-bound: run beside the row sweeps on a forked stream, the
//      column sweeps slowed the row sweeps, the longer of the two, and the
//      pair took longer than one after the other (0.893 ms against 0.824
//      for both kernels on an H100; PERF.md).
//    The recurrence is the XLA scan's: kBig for d >= D, the cost of 62 for a
//    candidate left of the right image, a zero carry and m = 0 at the first
//    step (or the carry-in and its minimum).  The volume's d axis is padded
//    to Dp = D rounded up to 16, for the WTA's 16-byte loads.
//  * sgm_wta: one block per row, one half-warp per pixel.  Each lane loads
//    16 consecutive disparities of each of the four volumes with one 16-byte
//    load and sums them in registers: one coalesced pass over the volumes.
//    The keyed minimum (value * D + d: lowest-d tie-break), the second
//    minimum over |d - best| > 1 and the subpixel neighbours S(best +- 1)
//    come from registers and half-warp reductions.  The right view's winner
//    best_r[xr] = argmin_d S(xr + d + minD, d) is a shared-memory atomicMin
//    of the key S(x, d) * D + d into rkey[x - d - minD], each entry seeded
//    with the least out-of-frame key 32767 * D + d (the least d with
//    xr + d + minD >= W); a minimum is the same in any order.  After one
//    barrier, the +-1 left-right agreement, the OpenCV uniqueness test with
//    integer arithmetic, the subpixel step with FLOOR division and
//    x >= best + minD decide each pixel, as before.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 20;
constexpr int kCostInvalid = 62;
constexpr int kBig16 = 32767;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVCols = 8;      // columns per block of the column-path kernel
constexpr int kAccCols = 6;    // columns per block of K6's column-path kernel (both directions)
constexpr int kRowRing = 16;   // slots of K6's row-sweep cell ring: cells copied 15 steps ahead
constexpr int kVStages = 4;    // cp.async ring depth of the column-path kernel
constexpr int kWtaThreads = 256;

// Index of pair i in a staged right-census row: one pad pair after every 8.
__host__ __device__ constexpr int skew8(int i) { return i + (i >> 3); }
// Index of entry i of the WTA's right-view key row: one pad after every 16.
__host__ __device__ constexpr int skew16(int i) { return i + (i >> 4); }

__host__ __device__ constexpr int padded_d(int d) { return (d + 15) & ~15; }
// The row-path kernel's shared memory: the staged right and left pairs,
// then (K6) its ring of prefetched cells, 16-byte aligned; in int2 units.
__host__ __device__ constexpr int row_ring_offset(int W) { return (skew8(W - 1) + 2 + W) & ~1; }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return (unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) | ((unsigned)(c & 0xff) << 16) |
         ((unsigned)(d & 0xff) << 24);
}
__device__ __forceinline__ unsigned pack2(int a, int b) {
  return (unsigned)(a & 0xffff) | ((unsigned)(b & 0xffff) << 16);
}

// Writes a lane's KP path values to p with one store (T: uint8_t or int16_t).
template <typename T, int KP>
__device__ __forceinline__ void store_run(T* p, const int (&v)[KP]) {
  if constexpr (sizeof(T) == 1) {
    if constexpr (KP == 8)
      *reinterpret_cast<uint2*>(p) = make_uint2(pack4(v[0], v[1], v[2], v[3]),
                                                pack4(v[4], v[5], v[6], v[7]));
    else if constexpr (KP == 4)
      *reinterpret_cast<unsigned*>(p) = pack4(v[0], v[1], v[2], v[3]);
    else if constexpr (KP == 2)
      *reinterpret_cast<uint16_t*>(p) = (uint16_t)((v[0] & 0xff) | ((v[1] & 0xff) << 8));
    else
      *p = (T)v[0];
  } else {
    if constexpr (KP == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                                pack2(v[4], v[5]), pack2(v[6], v[7]));
    else if constexpr (KP == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
    else if constexpr (KP == 2)
      *reinterpret_cast<unsigned*>(p) = pack2(v[0], v[1]);
    else
      *p = (T)v[0];
  }
}

// K6's output cells: a lane's n <= 2 NW consecutive int16 values at p, as NW
// packed pairs (value 2i in the low half).  vec: one vector access (n is 2 NW
// and p is 4 NW-byte aligned); else n scalar accesses, zeros beyond n.
template <int NW>
__device__ __forceinline__ void load_cells(const int16_t* p, int n, bool vec, unsigned (&w)[NW]) {
  if (vec) {
    if constexpr (NW == 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else if constexpr (NW == 2) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x, w[1] = q.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i)
    w[i] = (2 * i < n ? (unsigned)(uint16_t)p[2 * i] : 0u) |
           (2 * i + 1 < n ? (unsigned)(uint16_t)p[2 * i + 1] << 16 : 0u);
}
template <int NW>
__device__ __forceinline__ void store_cells(int16_t* p, int n, bool vec, const unsigned (&w)[NW]) {
  if (vec) {
    if constexpr (NW == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (NW == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<unsigned*>(p) = w[0];
    return;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (2 * i < n) p[2 * i] = (int16_t)(w[i] & 0xffffu);
    if (2 * i + 1 < n) p[2 * i + 1] = (int16_t)(w[i] >> 16);
  }
}
// Copies a lane's NW packed cell pairs from src to the shared address dst
// with one cp.async (src 4 NW-byte aligned).
template <int NW>
__device__ __forceinline__ void cp_cells(const void* dst, const int16_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (NW == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if constexpr (NW == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// w += v pairwise: each half's sum stays below 2^15 (see K6 above), so one
// 32-bit add carries nothing between the halves.
template <int NW>
__device__ __forceinline__ void add_cells(unsigned (&w)[NW], const unsigned (&v)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] += v[i];
}

// One step of the recurrence for the lane's disparities dbase..dbase+KP-1:
//   L(d) <- C(d) + min(L(d), L(d+-1) + P1, m + P2) - m,   kBig for d >= D,
// returning the new path minimum over d.
template <int KP>
__device__ __forceinline__ int path_step(int (&L)[KP], const int (&c)[KP], int m, int p1, int p2,
                                         int lane, int dbase, int D) {
  int left = __shfl_up_sync(kFull, L[KP - 1], 1);  // d - 1 of k = 0
  int right = __shfl_down_sync(kFull, L[0], 1);    // d + 1 of k = KP - 1
  if (lane == 0) left = kBig;
  if (lane == 31) right = kBig;
  int nl[KP];
  int lmin = INT_MAX;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int dn = k == 0 ? left : L[k - 1];
    const int up = k == KP - 1 ? right : L[k + 1];
    const int best = min(min(L[k], min(dn, up) + p1), m + p2);
    nl[k] = dbase + k < D ? c[k] + best - m : kBig;
    lmin = min(lmin, nl[k]);
  }
#pragma unroll
  for (int k = 0; k < KP; ++k) L[k] = nl[k];
  return __reduce_min_sync(kFull, lmin);
}

__device__ __forceinline__ int hamming(int2 a, int2 r) {
  return __popc((unsigned)(a.x ^ r.x)) + __popc((unsigned)(a.y ^ r.y));
}

// Row paths: block y holds image row y, warp 0 sweeps left->right, warp 1
// right->left.  K1 / K5: each into its plane (0, 1) of vol [4, H, W, Dp], or
// no volume (null).  kAcc (K6): the sum of both into vol = out [H, W, D]:
// the first half's steps store, the second half's add (see K6 above).  The
// three parts are separate loops: the sweeps are latency-bound (752 warps
// for 528 schedulers), so every per-step test of where the step lies would
// lengthen every step.
template <typename T, int KP, bool kAcc>
__global__ void __launch_bounds__(64) sgm_hpaths_kernel(
    const int* __restrict__ l0, const int* __restrict__ l1, const int* __restrict__ r0,
    const int* __restrict__ r1, T* __restrict__ vol, int H, int W, int D, int minD, int p1,
    int p2) {
  static_assert(!kAcc || sizeof(T) == 2, "K6 accumulates int16 sums");
  extern __shared__ int2 hsm[];
  int2* rs = hsm;                     // right pairs, skew8 layout
  int2* ls = hsm + skew8(W - 1) + 1;  // left pairs
  const int y = blockIdx.x;
  const size_t row = (size_t)y * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    rs[skew8(x)] = make_int2(r0[row + x], r1[row + x]);
    ls[x] = make_int2(l0[row + x], l1[row + x]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int dir = threadIdx.x >> 5;  // warp-uniform
  const int dbase = KP * lane;
  const int Dp = padded_d(D);
  T* out = (vol != nullptr && dbase < (kAcc ? D : Dp))
               ? vol + (kAcc ? row * D : ((size_t)dir * H * W + row) * Dp) + dbase
               : nullptr;
  int L[KP];  // a zero carry, kBig for d >= D; m = 0
#pragma unroll
  for (int k = 0; k < KP; ++k) L[k] = dbase + k < D ? 0 : kBig;
  int m = 0;
  const int step = dir == 0 ? 1 : -1;
  int x = dir == 0 ? 0 : W - 1;
  // win[k]: the right pair at xr = x - minD - dbase - k (clamped reads;
  // xr < 0 costs kCostInvalid).
  int2 win[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) win[k] = rs[skew8(max(x - minD - dbase - k, 0))];
  int2 a = ls[x];
  // Step s at x: L <- the path values of x; then x moves on.
  auto sweep = [&](int s) {
    const int xn = x + step;
    int2 an = a, wn = win[0];
    if (s + 1 < W) {  // the next step's left pair and new window pair
      an = ls[xn];
      wn = rs[skew8(max(xn - minD - dbase - (dir == 0 ? 0 : KP - 1), 0))];
    }
    int c[KP];
    const int xr0 = x - minD - dbase;  // xr of the lane's first disparity
    if (xr0 - (KP - 1) >= 0) {         // every candidate reads the right image
#pragma unroll
      for (int k = 0; k < KP; ++k) c[k] = hamming(a, win[k]);
    } else {
#pragma unroll
      for (int k = 0; k < KP; ++k) c[k] = xr0 - k >= 0 ? hamming(a, win[k]) : kCostInvalid;
    }
    m = path_step<KP>(L, c, m, p1, p2, lane, dbase, D);
    if (dir == 0) {
#pragma unroll
      for (int k = KP - 1; k > 0; --k) win[k] = win[k - 1];
      win[0] = wn;
    } else {
#pragma unroll
      for (int k = 0; k < KP - 1; ++k) win[k] = win[k + 1];
      win[KP - 1] = wn;
    }
    a = an;
    x = xn;
  };
  if constexpr (!kAcc) {
    for (int s = 0; s < W; ++s) {
      T* o = out + (size_t)x * Dp;
      sweep(s);
      if (out != nullptr) store_run<T, KP>(o, L);
    }
  } else {
    // The lane's n cells a pixel, as NW packed pairs, at `cell` (x's).  After
    // the midpoint a lane whose cells take one vector access (vec) has them
    // copied kRowRing - 1 steps ahead into its slots of a ring in shared
    // memory (the other warp stored them long before: they come from device
    // memory); another lane loads them in the step.
    constexpr int NW = (KP + 1) / 2;
    const int n = min(KP, D - dbase);
    const bool vec = KP > 1 && D % KP == 0;
    const int half = W / 2;
    const bool ring = out != nullptr && vec;
    const ptrdiff_t cstep = (ptrdiff_t)step * D;
    int16_t* cell = out + (ptrdiff_t)x * D;
    unsigned* hring = reinterpret_cast<unsigned*>(hsm + row_ring_offset(W)) + threadIdx.x * NW;
    const int16_t* ahead = cell + half * cstep;
    // The copy of step t's cell (none past the row's end) and its group.
    auto fetch = [&](int t) {
      if (t < W) cp_cells<NW>(hring + (t & (kRowRing - 1)) * 64 * NW, ahead);
      ahead += cstep;
      cp_async_commit();
    };
    // Step t's cells from the ring, the copy of step t + kRowRing - 1 issued.
    auto from_ring = [&](int t, unsigned (&w)[NW]) {
      fetch(t + kRowRing - 1);
      cp_async_wait<kRowRing - 1>();  // step t's group landed
      const unsigned* p = hring + (t & (kRowRing - 1)) * 64 * NW;
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = p[i];
    };
    auto pack = [&](unsigned (&v)[NW]) {
#pragma unroll
      for (int i = 0; i < NW; ++i) v[i] = pack2(L[2 * i], 2 * i + 1 < KP ? L[2 * i + 1] : 0);
    };
    unsigned v[NW], cur[NW];
    int s = 0;
    for (; s < half; ++s, cell += cstep) {  // the cells this warp reaches first
      sweep(s);
      pack(v);
      if (out != nullptr) store_cells<NW>(cell, n, vec, v);
    }
    __syncthreads();  // those stores are visible to the other warp
    if (ring) {
      if (W & 1) {  // the middle cell is not copied: it waits for the second barrier
        cp_async_commit();
        ahead += cstep;
      }
      for (int t = half + (W & 1); t < half + kRowRing - 1; ++t) fetch(t);
    }
    if (W & 1) {  // the middle cell: left-to-right stores, then right-to-left adds
      if (ring) from_ring(s, cur);
      sweep(s);
      pack(v);
      if (dir == 0 && out != nullptr) store_cells<NW>(cell, n, vec, v);
      __syncthreads();
      if (dir == 1 && out != nullptr) {
        load_cells<NW>(cell, n, vec, cur);
        add_cells<NW>(v, cur);
        store_cells<NW>(cell, n, vec, v);
      }
      ++s, cell += cstep;
    }
    for (; s < W; ++s, cell += cstep) {  // the cells the other warp stored
      if (ring)
        from_ring(s, cur);
      else if (out != nullptr)
        load_cells<NW>(cell, n, vec, cur);
      sweep(s);
      pack(v);
      if (out != nullptr) {
        add_cells<NW>(v, cur);
        store_cells<NW>(cell, n, vec, v);
      }
    }
  }
}

// --- Column paths, on packed 16-bit pairs -------------------------------
// The column sweeps are many (2W warps) and short (H steps), so they are
// bound by issue, not by a step's latency: they keep each lane's path values
// as NP pairs of 16-bit halves, P[i] = (d = 2 NP lane + 2i, 2i + 1), and run
// the recurrence with Hopper's DPX min instructions, two disparities each.
// kBig2 is 16384 in both halves: above any m + P2 (m <= 62 + P2 <= 8062),
// and kBig2 + P1 fits in 16 bits.
constexpr unsigned kBig2 = 0x40004000u;

template <int NP>
__device__ __forceinline__ int path_step2(unsigned (&P)[NP], const unsigned (&C)[NP],
                                          const unsigned (&keep)[NP], int m, unsigned p1x2,
                                          int p2, int lane) {
  unsigned left = __shfl_up_sync(kFull, P[NP - 1], 1);  // high half: d - 1 of i = 0
  unsigned right = __shfl_down_sync(kFull, P[0], 1);    // low half: d + 1 of i = NP - 1
  if (lane == 0) left = kBig2;
  if (lane == 31) right = kBig2;
  const unsigned mp2 = (unsigned)(m + p2) * 0x10001u, mm = (unsigned)m * 0x10001u;
  unsigned nv[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const unsigned dn = __byte_perm(i == 0 ? left : P[i - 1], P[i], 0x5432);
    const unsigned up = __byte_perm(P[i], i == NP - 1 ? right : P[i + 1], 0x5432);
    const unsigned w = __viaddmin_u16x2(dn, p1x2, up + p1x2);  // min(L(d+-1)) + P1
    const unsigned best = __vimin3_u16x2(P[i], mp2, w);
    // best >= m in both halves and best + C < 2^16, so one 32-bit add and
    // subtract carry nothing between the halves.
    const unsigned v = best + C[i] - mm;
    nv[i] = (v & keep[i]) | (kBig2 & ~keep[i]);
  }
  unsigned lm = nv[0];
#pragma unroll
  for (int i = 1; i < NP; ++i) lm = __vimin3_u16x2(lm, nv[i], nv[i]);
#pragma unroll
  for (int i = 0; i < NP; ++i) P[i] = nv[i];
  return __reduce_min_sync(kFull, min((int)(lm & 0xffffu), (int)(lm >> 16)));
}

// Writes a lane's 2 NP packed path values to p with one store.
template <typename T, int NP>
__device__ __forceinline__ void store_pairs(T* p, const unsigned (&P)[NP]) {
  if constexpr (sizeof(T) == 1) {
    if constexpr (NP == 4)
      *reinterpret_cast<uint2*>(p) =
          make_uint2(__byte_perm(P[0], P[1], 0x6420), __byte_perm(P[2], P[3], 0x6420));
    else if constexpr (NP == 2)
      *reinterpret_cast<unsigned*>(p) = __byte_perm(P[0], P[1], 0x6420);
    else
      *reinterpret_cast<uint16_t*>(p) = (uint16_t)__byte_perm(P[0], 0, 0x20);
  } else {
    if constexpr (NP == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(P[0], P[1], P[2], P[3]);
    else if constexpr (NP == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(P[0], P[1]);
    else
      *reinterpret_cast<unsigned*>(p) = P[0];
  }
}

// Column paths: block bx holds columns [8 bx, 8 bx + 8), warp w column
// 8 bx + w; dir 0 sweeps top->bottom (volume plane 2, carries cin_tb /
// cout_tb), dir 1 bottom->top (plane 3, cin_bt / cout_bt).  kSettle: no
// volume, the final carry written to cout_tb / cout_bt; else the volume
// written, no carry out.  kAcc (K6): the block holds both directions of
// kAccCols columns (warps 0-5 top-down, 6-11 bottom-up, one cp.async ring
// each, dir from the thread) and adds both into vol = out [H, W, D], which
// holds the row sums (see K6 above): 208 blocks of 12 warps at W = 1248, at
// most 24 warps an SM as in K1's column kernel; 8 columns a block made 156
// blocks of 16 warps that load the SMs unevenly, and 4 or 5 columns cost
// more census copies a column (PERF.md has the times).
template <typename T, int NP, bool kSettle, bool kAcc = false>
__device__ __forceinline__ void vpaths_body(
    const int* __restrict__ l0, const int* __restrict__ l1, const int* __restrict__ r0,
    const int* __restrict__ r1, T* __restrict__ vol, const int* __restrict__ cin_tb,
    const int* __restrict__ cin_bt, int* __restrict__ cout_tb, int* __restrict__ cout_bt, int H,
    int W, int D, int minD, int p1, int p2, int dir) {
  static_assert(!kAcc || (sizeof(T) == 2 && !kSettle), "K6 accumulates int16 sums");
  constexpr int KP = 2 * NP;
  constexpr int kCols = kAcc ? kAccCols : kVCols;
  constexpr int kSpan = 32 * KP + kCols - 1;  // right pairs a step needs
  constexpr int kRight = skew8(kSpan - 1) + 1;
  constexpr int kStage = kRight + kCols;      // + the columns' left pairs
  constexpr int kCopies = 2 * kSpan + 2 * kCols;
  constexpr int kItems = (kCopies + kCols * 32 - 1) / (kCols * 32);
  constexpr int kRings = kAcc ? 2 : 1;
  __shared__ int2 rings[kRings][kVStages][kStage];
  // kAcc: each lane's cells of a step, copied with the step's census words
  // (kVStages - 1 steps ahead) where no other direction may still store them.
  __shared__ __align__(16) unsigned cells[kAcc ? kVStages : 1][kAcc ? 2 * kCols * 32 : 1][NP];
  const int tid = threadIdx.x % (kCols * 32);  // the thread within its direction
  auto& ring = rings[kAcc ? dir : 0];
  const int x0 = blockIdx.x * kCols;
  const int base = x0 - minD - (32 * KP - 1);  // xr of staged pair 0
  const int warp = tid >> 5, lane = tid & 31;
  const int x = x0 + warp;

  // This thread's 4-byte copies of a step, fixed but for the row: the
  // right words base..base + kSpan - 1 of both planes into the skew8
  // layout, then the block's left words.
  unsigned dst[kItems];
  const int* src[kItems];
  bool copy[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = tid + q * kCols * 32;
    int plane = 0, word = 0, col = -1;
    if (i < 2 * kSpan) {
      plane = i >= kSpan;
      const int j = i - plane * kSpan;
      word = 2 * skew8(j) + plane;
      col = base + j;
    } else if (i < kCopies) {
      const int t = i - 2 * kSpan;
      plane = t >= kCols;
      const int j = t - plane * kCols;
      word = 2 * (kRight + j) + plane;
      col = x0 + j < W ? x0 + j : -1;
    }
    copy[q] = col >= 0 && col < W;
    dst[q] = (unsigned)__cvta_generic_to_shared(reinterpret_cast<int*>(&ring[0][0]) + word);
    const int* plane_base = i < 2 * kSpan ? (plane ? r1 : r0) : (plane ? l1 : l0);
    src[q] = plane_base + (copy[q] ? col : 0);
  }
  // kAcc: a lane's cells of step t are copied with the step's census words,
  // kVStages - 1 = 3 steps ahead, unless the other direction reaches them at
  // most 3 steps before t (0 <= 2t - (H - 1) <= 3: t = H / 2 and H / 2 + 1;
  // at t = H / 2 of an odd H it reaches them at the same step): those are
  // loaded in the step, after its barrier (the middle row bottom-up after a
  // second barrier).  A cell the other direction reaches later sees this
  // one's store before its own copy is issued.  Without one vector access
  // (D not a multiple of KP) every step's cells are loaded in the step.
  const int dbase = KP * lane;
  const int n = min(KP, D - dbase);
  const bool vec = D % KP == 0;
  static_assert(kVStages == 4, "the near steps below are those of a ring 3 steps ahead");
  auto in_step = [&](int t) { return !vec || (unsigned)(t - H / 2) < 2u; };  // t = H/2, H/2 + 1
  const size_t row0 = dir == 0 ? 0 : H - 1;
  const ptrdiff_t out_step = (dir == 0 ? 1 : -1) * (ptrdiff_t)W * (kAcc ? D : padded_d(D));
  const int16_t* cells0 =
      kAcc && x < W && dbase < D ? reinterpret_cast<const int16_t*>(vol) + (row0 * W + x) * D +
                                       dbase
                                 : nullptr;
  // Issues the copies of step s (row y) into ring slot s % kVStages.
  auto stage = [&](int s) {
    if (s < H) {
      if constexpr (kAcc) {
        if (cells0 != nullptr && !in_step(s))
          cp_cells<NP>(cells[s % kVStages][threadIdx.x], cells0 + s * out_step);
      }
      const size_t row = (size_t)(dir == 0 ? s : H - 1 - s) * W;
      const unsigned slot = (unsigned)((s % kVStages) * kStage * sizeof(int2));
#pragma unroll
      for (int q = 0; q < kItems; ++q)
        if (copy[q])
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst[q] + slot),
                       "l"(src[q] + row)
                       : "memory");
    }
    cp_async_commit();  // empty past the last step: keeps the group count uniform
  };
#pragma unroll
  for (int s = 0; s < kVStages - 1; ++s) stage(s);

  const bool live = x < W;  // warp-uniform
  const int Dp = padded_d(D);
  const int* cin = dir == 0 ? cin_tb : cin_bt;
  int* cout = dir == 0 ? cout_tb : cout_bt;
  T* out = (!kSettle && live && dbase < (kAcc ? D : Dp))
               ? vol + (kAcc ? (row0 * W + x) * D
                             : ((size_t)(2 + dir) * H + row0) * W * Dp + (size_t)x * Dp) +
                     dbase
               : nullptr;
  unsigned cur[NP];  // kAcc: the cells of this step
  unsigned P[NP], keep[NP];
  int cmin = INT_MAX;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int d = dbase + 2 * i;
    keep[i] = (d < D ? 0xffffu : 0u) | (d + 1 < D ? 0xffff0000u : 0u);
    unsigned v = 0;  // a zero carry
    if (cin != nullptr && live) {
      const int lo = d < D ? cin[(size_t)x * D + d] : 0;
      const int hi = d + 1 < D ? cin[(size_t)x * D + d + 1] : 0;
      v = (unsigned)lo | ((unsigned)hi << 16);
      if (d < D) cmin = min(cmin, lo);
      if (d + 1 < D) cmin = min(cmin, hi);
    }
    P[i] = (v & keep[i]) | (kBig2 & ~keep[i]);
  }
  // The first step's m: the carry's minimum over d (_recurrence), 0 for a
  // zero carry.
  int m = (cin != nullptr && live) ? __reduce_min_sync(kFull, cmin) : 0;
  const unsigned p1x2 = (unsigned)p1 * 0x10001u;
  const int xr0 = x - minD - dbase;        // xr of the lane's first disparity
  const bool in_frame = xr0 - (KP - 1) >= 0;  // every candidate reads the right image
  const int j0 = warp + 32 * KP - 1 - dbase;  // staged pair of xr0
  // Step s's barrier: the step's copies landed, its ring slot is read, the
  // copies of step s + kVStages - 1 are issued.
  auto enter = [&](int s) {
    cp_async_wait<kVStages - 2>();  // this thread's copies of step s landed
    __syncthreads();                // everyone's did; slot (s - 1) is free
    stage(s + kVStages - 1);
  };
  // Step s's recurrence: P <- the path values of the step's row.
  auto sweep = [&](int s) {
    if (!live) return;
    const int2* slot = ring[s % kVStages];
    const int2 a = slot[kRight + warp];
    unsigned C[NP];
    if (in_frame) {
#pragma unroll
      for (int i = 0; i < NP; ++i)
        C[i] = (unsigned)hamming(a, slot[skew8(j0 - 2 * i)]) |
               ((unsigned)hamming(a, slot[skew8(j0 - 2 * i - 1)]) << 16);
    } else {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int c0 = xr0 - 2 * i >= 0 ? hamming(a, slot[skew8(j0 - 2 * i)]) : kCostInvalid;
        const int c1 =
            xr0 - 2 * i - 1 >= 0 ? hamming(a, slot[skew8(j0 - 2 * i - 1)]) : kCostInvalid;
        C[i] = (unsigned)c0 | ((unsigned)c1 << 16);
      }
    }
    m = path_step2<NP>(P, C, keep, m, p1x2, p2, lane);
  };
  if constexpr (!kAcc) {
    for (int s = 0; s < H; ++s) {
      enter(s);
      sweep(s);
      if (out != nullptr) {
        store_pairs<T, NP>(out, P);
        out += out_step;
      }
    }
  } else {
    // The steps before H / 2 and after H / 2 + 1 read their cells from the
    // ring (vec) or load them after the barrier; the two between load them
    // after the barrier, and the middle row of an odd H is added top-down,
    // then, after a second barrier, bottom-up.  Separate loops: no per-step
    // test of where the step lies.
    int16_t* cell = reinterpret_cast<int16_t*>(out);
    auto add_store = [&]() {
      add_cells<NP>(cur, P);
      store_cells<NP>(cell, n, vec, cur);
    };
    auto far = [&](int s) {
      enter(s);
      if (out != nullptr) {
        if (vec) {
#pragma unroll
          for (int i = 0; i < NP; ++i) cur[i] = cells[s % kVStages][threadIdx.x][i];
        } else {
          load_cells<NP>(cell, n, vec, cur);
        }
      }
      sweep(s);
      if (out != nullptr) add_store();
      cell += out_step;
    };
    const int near = H / 2;
    int s = 0;
    for (; s < near; ++s) far(s);
    for (; s < min(H, near + 2); ++s, cell += out_step) {
      enter(s);
      const bool mid = (H & 1) && s == near;  // both directions at the middle row
      if (out != nullptr && (!mid || dir == 0)) load_cells<NP>(cell, n, vec, cur);
      sweep(s);
      if (mid) {
        if (dir == 0 && out != nullptr) add_store();
        __syncthreads();
        if (dir == 1 && out != nullptr) {
          load_cells<NP>(cell, n, vec, cur);
          add_store();
        }
      } else if (out != nullptr) {
        add_store();
      }
    }
    for (; s < H; ++s) far(s);
  }
  cp_async_wait<0>();
  if (kSettle && live) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int d = dbase + 2 * i;
      if (d < D) cout[(size_t)x * D + d] = (int)(P[i] & 0xffffu);
      if (d + 1 < D) cout[(size_t)x * D + d + 1] = (int)(P[i] >> 16);
    }
  }
}

// The column paths of K1 and K5's output pass: block (bx, dir) writes
// volume plane 2 + dir.
template <typename T, int NP>
__global__ void __launch_bounds__(kVCols * 32) sgm_vpaths_kernel(
    const int* __restrict__ l0, const int* __restrict__ l1, const int* __restrict__ r0,
    const int* __restrict__ r1, T* __restrict__ vol, const int* __restrict__ cin_tb,
    const int* __restrict__ cin_bt, int H, int W, int D, int minD, int p1, int p2) {
  vpaths_body<T, NP, false>(l0, l1, r0, r1, vol, cin_tb, cin_bt, nullptr, nullptr, H, W, D, minD,
                            p1, p2, (int)blockIdx.y);
}

// K6's column paths: block bx adds both vertical directions of its 6 columns
// into out [H, W, D].
template <int NP>
__global__ void __launch_bounds__(kAccCols * 64) sgm_vpaths_acc_kernel(
    const int* __restrict__ l0, const int* __restrict__ l1, const int* __restrict__ r0,
    const int* __restrict__ r1, int16_t* __restrict__ out, int H, int W, int D, int minD, int p1,
    int p2) {
  vpaths_body<int16_t, NP, false, true>(l0, l1, r0, r1, out, nullptr, nullptr, nullptr, nullptr,
                                        H, W, D, minD, p1, p2,
                                        (int)threadIdx.x / (kAccCols * 32));
}

// K5's settle sweeps: block (bx, y) sweeps direction dir0 + y and writes only
// its final carry.
template <int NP>
__global__ void __launch_bounds__(kVCols * 32) sgm_settle_kernel(
    const int* __restrict__ l0, const int* __restrict__ l1, const int* __restrict__ r0,
    const int* __restrict__ r1, const int* __restrict__ cin_tb, const int* __restrict__ cin_bt,
    int* __restrict__ cout_tb, int* __restrict__ cout_bt, int H, int W, int D, int minD, int p1,
    int p2, int dir0) {
  vpaths_body<uint8_t, NP, true>(l0, l1, r0, r1, nullptr, cin_tb, cin_bt, cout_tb, cout_bt, H, W,
                                 D, minD, p1, p2, dir0 + (int)blockIdx.y);
}

// What launch_paths launches.
enum : unsigned { kRowPaths = 1, kColPaths = 2, kSettleSweeps = 4 };

template <typename T, int KP, int NP>
int launch_paths_kp(const void* l0, const void* l1, const void* r0, const void* r1, void* vol,
                    const void* cin_tb, const void* cin_bt, void* cout_tb, void* cout_bt,
                    int H, int W, int D, int minD, int p1, int p2, unsigned what,
                    cudaStream_t stream) {
  constexpr bool kAcc = sizeof(T) == 2;  // K6: the paths add into out [H, W, D]
  if (what & kRowPaths) {
    const size_t smem =
        kAcc ? (size_t)row_ring_offset(W) * sizeof(int2) +
                   (size_t)kRowRing * 64 * ((KP + 1) / 2) * sizeof(unsigned)
             : (size_t)(skew8(W - 1) + 1 + W) * sizeof(int2);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          sgm_hpaths_kernel<T, KP, kAcc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    sgm_hpaths_kernel<T, KP, kAcc><<<H, 64, smem, stream>>>(
        (const int*)l0, (const int*)l1, (const int*)r0, (const int*)r1, (T*)vol, H, W, D, minD,
        p1, p2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned vblocks = (W + kVCols - 1) / kVCols;
  if ((what & kColPaths) && kAcc) {  // after the row paths, on the same stream
    sgm_vpaths_acc_kernel<NP><<<(W + kAccCols - 1) / kAccCols, kAccCols * 64, 0, stream>>>(
        (const int*)l0, (const int*)l1, (const int*)r0, (const int*)r1, (int16_t*)vol, H, W, D,
        minD, p1, p2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else if (what & kColPaths) {
    sgm_vpaths_kernel<T, NP><<<dim3(vblocks, 2), kVCols * 32, 0, stream>>>(
        (const int*)l0, (const int*)l1, (const int*)r0, (const int*)r1, (T*)vol,
        (const int*)cin_tb, (const int*)cin_bt, H, W, D, minD, p1, p2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (what & kSettleSweeps) {  // the direction(s) with a carry-out pointer
    const int ndirs = (cout_tb != nullptr) + (cout_bt != nullptr);
    if (ndirs == 0) return (int)cudaErrorInvalidValue;
    sgm_settle_kernel<NP><<<dim3(vblocks, ndirs), kVCols * 32, 0, stream>>>(
        (const int*)l0, (const int*)l1, (const int*)r0, (const int*)r1, (const int*)cin_tb,
        (const int*)cin_bt, (int*)cout_tb, (int*)cout_bt, H, W, D, minD, p1, p2,
        cout_tb != nullptr ? 0 : 1);
  }
  return (int)cudaGetLastError();
}

// The path kernels named by `what`: the row paths with KP = the least of 1,
// 2, 4, 8 with 32 KP >= D, the column paths and the settle sweeps with
// NP = max(KP / 2, 1) pairs a lane.
template <typename T>
int launch_paths(const void* l0, const void* l1, const void* r0, const void* r1, void* vol,
                 const void* cin_tb, const void* cin_bt, void* cout_tb, void* cout_bt, int H,
                 int W, int D, int minD, int p1, int p2, unsigned what, void* stream) {
  if (D < 1 || D > 256 || minD < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 32)
    return launch_paths_kp<T, 1, 1>(l0, l1, r0, r1, vol, cin_tb, cin_bt, cout_tb, cout_bt, H,
                                    W, D, minD, p1, p2, what, s);
  if (D <= 64)
    return launch_paths_kp<T, 2, 1>(l0, l1, r0, r1, vol, cin_tb, cin_bt, cout_tb, cout_bt, H,
                                    W, D, minD, p1, p2, what, s);
  if (D <= 128)
    return launch_paths_kp<T, 4, 2>(l0, l1, r0, r1, vol, cin_tb, cin_bt, cout_tb, cout_bt, H,
                                    W, D, minD, p1, p2, what, s);
  return launch_paths_kp<T, 8, 4>(l0, l1, r0, r1, vol, cin_tb, cin_bt, cout_tb, cout_bt, H, W,
                                  D, minD, p1, p2, what, s);
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Min and sum over the 16 lanes of a half-warp.
__device__ __forceinline__ int half_min(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int half_sum(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One block per row y; half-warp h of warp w takes pixels x = 2 w + h + 16 i.
// vol: uint8 [4, H, W, Dp], Dp = D rounded up to 16.
__global__ void __launch_bounds__(kWtaThreads) sgm_wta_kernel(
    const uint8_t* __restrict__ vol, int16_t* __restrict__ out, int H, int W, int D, int minD,
    int uniqueness, int subpixel, int lr_check) {
  extern __shared__ int wsm[];
  int* rkey = wsm;                                              // [skew16(W - 1) + 1]
  int16_t* sbest = reinterpret_cast<int16_t*>(wsm + skew16(W - 1) + 1);  // [W]
  int16_t* sval = sbest + W;                                    // [W], before the LR test
  const int y = blockIdx.x;
  const size_t row = (size_t)y * W;
  const int Dp = padded_d(D);
  if (lr_check) {
    for (int xr = threadIdx.x; xr < W; xr += blockDim.x) {
      const int d0 = max(0, W - minD - xr);  // the least out-of-frame d
      rkey[skew16(xr)] = d0 < D ? kBig16 * D + d0 : INT_MAX;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane >> 4, dlo = 16 * (lane & 15);
  const size_t plane = (size_t)H * W * Dp;
  for (int x0 = 2 * warp; x0 < W; x0 += 2 * (kWtaThreads / 32)) {  // warp-uniform
    const int x = x0 + half;
    const bool on = x < W && dlo < D;  // this lane holds disparities of pixel x
    int S[16];
    if (on) {
      const uint8_t* p = vol + (row + x) * Dp + dlo;
      unsigned e0[4] = {0, 0, 0, 0}, e1[4] = {0, 0, 0, 0};  // bytes 0,2 and 1,3 of each word
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p + v * plane));
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          e0[j] += w[j] & 0x00ff00ffu;
          e1[j] += (w[j] >> 8) & 0x00ff00ffu;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        S[4 * j] = (int)(e0[j] & 0xffffu);
        S[4 * j + 1] = (int)(e1[j] & 0xffffu);
        S[4 * j + 2] = (int)(e0[j] >> 16);
        S[4 * j + 3] = (int)(e1[j] >> 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) S[k] = 0;
    }
    int key = INT_MAX;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (on && dlo + k < D) key = min(key, S[k] * D + dlo + k);
    key = half_min(key);
    const int best = key % D, min_s = key / D;
    int second = kBig16, pair = 0;  // pair: S(best - 1) + S(best + 1) << 16
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int d = dlo + k;
      if (on && d < D) {
        if (abs(d - best) > 1) second = min(second, S[k]);
        if (d == best - 1) pair += S[k];
        if (d == best + 1) pair += S[k] << 16;
      }
    }
    second = half_min(second);
    pair = half_sum(pair);
    if (lr_check && on) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int d = dlo + k, xr = x - minD - d;
        if (d < D && xr >= 0) atomicMin(&rkey[skew16(xr)], S[k] * D + d);
      }
    }
    if (x < W && (lane & 15) == 0) {
      bool ok = second * (100 - uniqueness) >= min_s * 100;
      int delta = 0;
      if (subpixel && best > 0 && best < D - 1) {
        const int sm = pair & 0xffff, sp = pair >> 16;
        const int denom2 = max(sm + sp - 2 * min_s, 1);
        delta = floor_div((sm - sp) * 16 + denom2, denom2 * 2);
      }
      ok = ok && x >= best + minD;
      sbest[x] = (int16_t)best;
      sval[x] = (int16_t)(ok ? (best + minD) * 16 + delta : -32768);
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    int v = sval[x];
    if (lr_check && v != -32768) {
      const int best = sbest[x], xr = x - best - minD;
      if (xr < 0 || abs(rkey[skew16(xr)] % D - best) > 1) v = -32768;
    }
    out[row + x] = (int16_t)v;
  }
}

}  // namespace

// K1's paths: vol uint8 [4, H, W, Dp] (Dp = D rounded up to 16).
extern "C" int sgm_paths(const void* l0, const void* l1, const void* r0, const void* r1,
                         void* vol, int H, int W, int D, int minD, int p1, int p2,
                         void* stream) {
  return launch_paths<uint8_t>(l0, l1, r0, r1, vol, nullptr, nullptr, nullptr, nullptr, H, W, D,
                               minD, p1, p2, kRowPaths | kColPaths, stream);
}

// K5's output pass, first part: the row paths of one row shard into planes
// 0-1 of vol (uint8 [4, H, W, Dp]).  They need no carry.
extern "C" int sgm_sharded_rows(const void* l0, const void* l1, const void* r0, const void* r1,
                                void* vol, int H, int W, int D, int minD, int p1, int p2,
                                void* stream) {
  return launch_paths<uint8_t>(l0, l1, r0, r1, vol, nullptr, nullptr, nullptr, nullptr, H, W, D,
                               minD, p1, p2, kRowPaths, stream);
}

// K5's output pass, second part: the column paths of one row shard into
// planes 2-3 of vol, seeded with the settled carries cin_tb / cin_bt (int32
// [W, D], or null for a zero carry).  sgm_wta follows.
extern "C" int sgm_sharded_cols(const void* l0, const void* l1, const void* r0, const void* r1,
                                void* vol, const void* cin_tb, const void* cin_bt, int H, int W,
                                int D, int minD, int p1, int p2, void* stream) {
  return launch_paths<uint8_t>(l0, l1, r0, r1, vol, cin_tb, cin_bt, nullptr, nullptr, H, W, D,
                               minD, p1, p2, kColPaths, stream);
}

// K5, one settle sweep: the vertical path(s) of one row shard whose carry-out
// pointer (cout_tb top-down, cout_bt bottom-up; int32 [W, D]) is non-null,
// from cin_tb / cin_bt (or zero), writing only those final carries.  One
// launch; a direction with a null carry-out is not swept.
extern "C" int sgm_vcarry(const void* l0, const void* l1, const void* r0, const void* r1,
                          const void* cin_tb, const void* cin_bt, void* cout_tb,
                          void* cout_bt, int H, int W, int D, int minD, int p1, int p2,
                          void* stream) {
  return launch_paths<uint8_t>(l0, l1, r0, r1, nullptr, cin_tb, cin_bt, cout_tb, cout_bt, H, W,
                               D, minD, p1, p2, kSettleSweeps, stream);
}

// K6: the 4-path sum into out, int16 [H, W, D] (every cell written).
extern "C" int sgm_aggregate(const void* l0, const void* l1, const void* r0, const void* r1,
                             void* out, int H, int W, int D, int minD, int p1, int p2,
                             void* stream) {
  return launch_paths<int16_t>(l0, l1, r0, r1, out, nullptr, nullptr, nullptr, nullptr, H, W, D,
                               minD, p1, p2, kRowPaths | kColPaths, stream);
}

// vol: uint8 [4, H, W, Dp] from sgm_paths, or sgm_sharded_rows + sgm_sharded_cols;
// out: int16 [H, W].
extern "C" int sgm_wta(const void* vol, void* out, int H, int W, int D, int minD,
                       int uniqueness, int subpixel, int lr_check, void* stream) {
  if (D < 1 || D > 256 || minD < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(skew16(W - 1) + 1) * sizeof(int) + 2 * (size_t)W * sizeof(int16_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sgm_wta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sgm_wta_kernel<<<H, kWtaThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)vol, (int16_t*)out, H, W, D, minD, uniqueness, subpixel, lr_check);
  return (int)cudaGetLastError();
}
