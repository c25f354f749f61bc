// Kernel K3: the contour-relaxation sub-steps of a relax() call from a fixed
// per-label table, fused.
//
// Replaces the Pallas relax_phase_pallas (cartslam_tpu/ops/pallas/relax.py:240,
// body _make_phase_kernel :39).  A launch runs `steps` sub-steps; sub-step k
// updates the pixels whose checkerboard parity
//   floor_mod(row0 + y + x, num_phases) == (phase + k) % num_phases
// (:134-137; row0 is the global row of row 0, negative for a shard whose
// halo starts above the frame).  'frame' stats mode runs all of a call's
// sweeps x phases sub-steps from the call's one table; 'phase' stats mode
// runs one sub-step a launch, each from the table re-tallied after the last.
// Its plain versions are in cartslam_tpu_torch/kernels/relax.py:
// relax_sweeps_plain (table_gather, then one relax_sweep_plain -- the port
// of phase_update, cartslam_tpu/ops/superpixels.py:335-417 -- per
// sub-step) and relax_phase_plain (one sub-step).
//
// Per pixel and sub-step: if it is a label-boundary pixel of the sub-step's
// parity, score the labels of
// its 3x3 neighbourhood in _OFFSETS order (x outer, y inner) as
//   clique(cand) + sum_f w_f * [c_f(old - pixel) + c_f(cand + pixel)
//                               - c_f(old) - c_f(cand)]     (0 if cand == old)
// with the Gaussian-NLL and compactness costs of the per-label moments, and
// keep the first strict-< minimum.  Out-of-bounds and -1 candidates are
// masked; -1 pixels (the spatial mode's halo fill) never change.
//
// A pixel's stat rows are its label's row of the launch's fixed table, so
// the kernel carries labels only: no per-pixel stat image is read
// or written (the one-sweep kernel before this one moved the 15-plane stat
// image in and out on every sweep).
//
// What bounds it on an H100: per table, the bytes are the labels in and out
// (2 x 1.9 MB at 376x1248), the 7 data planes (13 MB) and the table
// (200 KB), about 5 us at 3.35 TB/s, whatever the sub-step count (a
// 'phase'-mode call pays them once a sub-step); the work is each sub-step's
// active pixels x distinct candidates x channels of divisions and logf.  A
// launch per sub-step costs a pass over the labels and a launch gap each.
//
// Design:
//  * relax_label_rows, once per table (once a 'frame'-mode call, once a
//    sub-step in 'phase' mode): the label-major row table [L + 1, 32]
//    (the 1 + 2C stats of the label, then each feature's cost of the label,
//    the same feature_cost in the same order); row L is zeros, the row of a
//    label outside [0, L) (table_gather reads zeros there).  old_cost and
//    cand_cost become loads, and a candidate's stats one 128-byte line.
//  * relax_sweeps_kernel, temporal blocking: a block owns a 32x64 tile of
//    the output and keeps the tile plus a halo of `steps` rows and columns
//    of labels in shared memory (a sub-step moves label influence one cell).
//    Sub-step s recomputes the region s cells in from the buffer's edge from
//    the previous sub-step's buffer (ping-pong); after the last the block
//    writes only its tile.  Out-of-frame cells are -1, like the plain
//    version's OOB fill.
//  * Dense scoring: only boundary cells of the sub-step's parity (about a
//    third of the pixels at the flagship's superpixel size, half of that
//    with two phases) do the expensive work.  A sub-step first copies the
//    other cells' labels and appends those cells to a work list in shared
//    memory, then the block's threads score the list, one cell each.
//    The wrapper runs a 'frame'-mode call as launches of at most
//    kernels/relax.SWEEPS_PER_LAUNCH sweeps, chosen by measurement
//    (chip_smoke.py times 1, 2, 4, 8, 12 and 24 sweeps a launch on the
//    flagship's 8- and 24-sweep calls): the halo's recomputation grows with
//    the sweeps per launch, the launches and label passes shrink.  With
//    two phases a sweep is two sub-steps, and the halo doubles.
//  * The total of a candidate depends on its label only, so each distinct
//    label of the neighbourhood is scored once, at its first occurrence in
//    _OFFSETS order: a later duplicate ties exactly and cannot win a strict <.
//    Each lane walks a bit mask of its own first occurrences, so a warp
//    pays for its busiest pixel's distinct labels, not for the union of the
//    9 slots its lanes need.
//  * Registers, not local memory: the flagship's feature layout (gaussian 2,
//    gaussian 3, compactness 2; C = 7) is a compile-time instantiation, its
//    pixel values in registers and every feature offset a constant.  The
//    generic instantiation takes any layout of <= 4 features and <= 8
//    channels and reads its pixel values from the data planes as it goes.
//    Both read a label's row from the row table as they go (L1-resident).
//
// Rounding: the float operations follow the plain version's order exactly
// (costs summed over channels then divided by C, variance floor 1/12, logf,
// the pixel rows [1, x, x*x] built in float32), with IEEE division, and
// this file is compiled with -fmad=false so that a*b+c is not fused into an
// FMA: the plain version rounds after every operation.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxFeat = 4;
constexpr int kMaxChan = 8;
constexpr int kRowStride = 32;  // floats per label row: 1 + 2C stats, then the costs
constexpr int kTileH = 32, kTileW = 64, kThreads = 256;
constexpr float kVarFloor = (float)(1.0 / 12.0);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);

struct Features {
  int n;
  int kind[kMaxFeat];  // 0 = gaussian, 1 = compactness
  int off[kMaxFeat];   // first channel of the feature in the packed layout
  int ch[kMaxFeat];    // channels of the feature
  float weight[kMaxFeat];
};

// The flagship's layout: gaussian (2) | gaussian (3) | compactness (2).
constexpr int kFlagC = 7, kFlagNF = 3;
__host__ __device__ constexpr int flag_kind(int i) { return i == 2 ? 1 : 0; }
__host__ __device__ constexpr int flag_off(int i) { return i == 0 ? 0 : (i == 1 ? 2 : 5); }
__host__ __device__ constexpr int flag_ch(int i) { return i == 1 ? 3 : 2; }

// One feature's cost from the count n and the channel sums s(c), ss(c).
template <typename SF, typename SSF>
__device__ __forceinline__ float feature_cost(int kind, int ch, float n, SF s_of, SSF ss_of) {
  const float n_safe = n < 1.0f ? 1.0f : n;
  float acc = 0.0f;
  if (kind == 0) {
    const float half = n / 2.0f;
#pragma unroll
    for (int c = 0; c < kMaxChan; ++c) {
      if (c >= ch) break;
      const float q = s_of(c) / n_safe;
      float var = ss_of(c) / n_safe - q * q;
      if (var < kVarFloor) var = kVarFloor;
      const float t = half * logf(kTwoPi * var) + half;
      acc = c == 0 ? t : acc + t;
    }
    acc = acc / (float)ch;
  } else {
#pragma unroll
    for (int c = 0; c < kMaxChan; ++c) {
      if (c >= ch) break;
      const float s = s_of(c);
      const float t = ss_of(c) - (s * s) / n_safe;
      acc = c == 0 ? t : acc + t;
    }
  }
  return n > 0.0f ? acc : 0.0f;
}

// Row table [L + 1, kRowStride] from the table [1 + 2C, L].
__global__ void relax_label_rows_kernel(const float* __restrict__ table, float* __restrict__ rows,
                                        int L, int c_total, Features f) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l > L) return;
  const int nstat = 1 + 2 * c_total;
  auto t = [&](int k) { return l < L ? table[(size_t)k * L + l] : 0.0f; };
  float* r = rows + (size_t)l * kRowStride;
  for (int k = 0; k < nstat; ++k) r[k] = t(k);
#pragma unroll
  for (int i = 0; i < kMaxFeat; ++i) {
    if (i < f.n) {
      const int off = f.off[i];
      r[nstat + i] = feature_cost(
          f.kind[i], f.ch[i], t(0), [&](int c) { return t(1 + off + c); },
          [&](int c) { return t(1 + c_total + off + c); });
    }
  }
}

// Whether the tile cell `cell` (label lab != -1) has a neighbour with
// another label (not -1): only such cells can change in a sweep.
__device__ __forceinline__ bool on_boundary(const int* __restrict__ t, int ew, int cell, int lab) {
  bool boundary = false;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int nb = t[cell + (j % 3 - 1) * ew + j / 3 - 1];
    if (j != 4) boundary |= nb != -1 && nb != lab;
  }
  return boundary;
}

// The new label of the boundary cell `cell` of the previous sweep's tile t
// (row stride ew), at frame pixel (gy, gx).
template <bool kFlag>
__device__ __forceinline__ int relax_score(const int* __restrict__ t, int ew, int cell, int gy,
                                           int gx, int H, int W, int L, int c_total,
                                           const Features& f, const float* __restrict__ data,
                                           const float* __restrict__ rows,
                                           const float* __restrict__ prog, float direct,
                                           float diagonal) {
  const int lab = t[cell];
  int nb[9];  // j = (dx + 1) * 3 + (dy + 1): the _OFFSETS order
#pragma unroll
  for (int j = 0; j < 9; ++j) nb[j] = t[cell + (j % 3 - 1) * ew + j / 3 - 1];
  const int C = kFlag ? kFlagC : c_total;
  const int nstat = 1 + 2 * C;
  const int nf = kFlag ? kFlagNF : f.n;
  const size_t hw = (size_t)H * W, p = (size_t)gy * W + gx;
  // The pixel's values stay in registers for the flagship; their squares
  // are recomputed where used (the same rounded product, as FMA contraction
  // is off).  With the label rows also read as they go, ptxas keeps this
  // instantiation free of spills (with both held in registers it spilled).
  float xv[kFlag ? kFlagC : 1];
  if constexpr (kFlag) {
#pragma unroll
    for (int k = 0; k < kFlagC; ++k) xv[k] = __ldg(data + k * hw + p);
  }
  auto xval = [&](int k) -> float {
    if constexpr (kFlag) return xv[k];
    else return __ldg(data + k * hw + p);
  };
  auto xsq = [&](int k) -> float {
    const float v = xval(k);
    return v * v;
  };
  // A label's row (L1/L2-resident), read as it goes.
  auto row_of = [&](int l) {
    const float* r = rows + (size_t)((unsigned)l < (unsigned)L ? l : L) * kRowStride;
    return [r](int k) { return __ldg(r + k); };
  };

  const auto orow = row_of(lab);
  float old_cost[kMaxFeat], old_minus[kMaxFeat];
#pragma unroll
  for (int i = 0; i < kMaxFeat; ++i) {
    if (i < nf) {
      const int kind = kFlag ? flag_kind(i) : f.kind[i];
      const int off = kFlag ? flag_off(i) : f.off[i];
      const int ch = kFlag ? flag_ch(i) : f.ch[i];
      old_cost[i] = orow(nstat + i);
      old_minus[i] = feature_cost(
          kind, ch, orow(0) - 1.0f, [&](int k) { return orow(1 + off + k) - xval(off + k); },
          [&](int k) { return orow(1 + C + off + k) - xsq(off + k); });
    }
  }
  const float pf = prog != nullptr ? prog[gy] : 1.0f;

  // Bit j: nb[j] is a label (not -1) that does not occur earlier in
  // _OFFSETS order.  A later duplicate ties its total exactly and cannot
  // win a strict <, so each lane scores only these, in order: the warp runs
  // as many rounds as its busiest lane has distinct labels.
  unsigned firsts = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    bool seen = nb[j] == -1;
#pragma unroll
    for (int j2 = 0; j2 < j; ++j2) seen |= nb[j2] == nb[j];
    firsts |= seen ? 0u : 1u << j;
  }
  float best = INFINITY;
  int best_label = lab;
  while (firsts != 0) {
    const int j = __ffs(firsts) - 1;
    firsts &= firsts - 1;
    int cand = nb[0];
#pragma unroll
    for (int j2 = 1; j2 < 9; ++j2)
      if (j2 == j) cand = nb[j2];
    float clique = 0.0f;
#pragma unroll
    for (int j2 = 0; j2 < 9; ++j2) {
      if (j2 == 4) continue;
      const float cc = (j2 / 3 == 1 || j2 % 3 == 1) ? direct : diagonal;
      clique = clique + ((nb[j2] != -1 && nb[j2] != cand) ? cc : 0.0f);
    }
    float total = clique;
    if (cand != lab) {  // the old label's feature delta is exactly 0
      const auto crow = row_of(cand);
#pragma unroll
      for (int i = 0; i < kMaxFeat; ++i) {
        if (i < nf) {
          const int kind = kFlag ? flag_kind(i) : f.kind[i];
          const int off = kFlag ? flag_off(i) : f.off[i];
          const int ch = kFlag ? flag_ch(i) : f.ch[i];
          const float cand_cost = crow(nstat + i);
          const float cand_plus = feature_cost(
              kind, ch, crow(0) + 1.0f, [&](int k) { return crow(1 + off + k) + xval(off + k); },
              [&](int k) { return crow(1 + C + off + k) + xsq(off + k); });
          float delta = old_minus[i] + cand_plus - old_cost[i] - cand_cost;
          if (kind == 1 && prog != nullptr) delta = delta * pf;
          total = total + f.weight[i] * delta;
        }
      }
    }
    if (total < best) {
      best = total;
      best_label = cand;
    }
  }
  return best_label;
}

// Whether frame pixel (gy, gx) takes part in the sub-step of parity ph:
// floor_mod(row0 + gy + gx, num_phases) == ph, non-negative for a negative
// row0 as torch.remainder and jnp's % are.
__device__ __forceinline__ bool in_phase(int gy, int gx, int row0, int num_phases, int ph) {
  int q = (row0 + gy + gx) % num_phases;
  if (q < 0) q += num_phases;
  return q == ph;
}

// `steps` sub-steps from labels into out (int32 [H, W], distinct buffers);
// sub-step k (0-based) has parity (phase + k) % num_phases.
template <bool kFlag>
__global__ void __launch_bounds__(kThreads) relax_sweeps_kernel(
    const int* __restrict__ labels, const float* __restrict__ data,
    const float* __restrict__ rows, int* __restrict__ out, int H, int W, int L, int c_total,
    Features f, const float* __restrict__ prog, float direct, float diagonal, int steps,
    int phase, int num_phases, int row0) {
  extern __shared__ int tile[];
  __shared__ int nwork;
  const int ew = kTileW + 2 * steps, eh = kTileH + 2 * steps;
  int* cur = tile;
  int* nxt = tile + eh * ew;
  int* work = tile + 2 * eh * ew;  // a sub-step's boundary cells, [(eh - 2) * (ew - 2)]
  const int lane = threadIdx.x & 31;
  const int gy0 = blockIdx.y * kTileH - steps, gx0 = blockIdx.x * kTileW - steps;
  for (int i = threadIdx.x; i < eh * ew; i += kThreads) {
    const int gy = gy0 + i / ew, gx = gx0 + i % ew;
    cur[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? labels[(size_t)gy * W + gx] : -1;
  }
  for (int s = 1; s <= steps; ++s) {
    if (threadIdx.x == 0) nwork = 0;
    __syncthreads();
    // Pass 1: cells off the boundary or off the sub-step's parity keep
    // their label; the others go to the work list (one shared atomic per
    // warp).
    const int ph = (phase + s - 1) % num_phases;
    const int rh = eh - 2 * s, rw = ew - 2 * s, n = rh * rw;
    for (int base = threadIdx.x - lane; base < n; base += kThreads) {  // warp-uniform
      const int i = base + lane;
      bool listed = false;
      int cell = 0;
      if (i < n) {
        cell = (s + i / rw) * ew + s + i % rw;
        const int lab = cur[cell];
        listed = lab != -1 &&
                 (num_phases == 1 ||
                  in_phase(gy0 + cell / ew, gx0 + cell % ew, row0, num_phases, ph)) &&
                 on_boundary(cur, ew, cell, lab);
        if (!listed) nxt[cell] = lab;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, listed);
      int first = 0;
      if (lane == 0 && mask != 0) first = atomicAdd(&nwork, __popc(mask));
      first = __shfl_sync(0xffffffffu, first, 0);
      if (listed) work[first + __popc(mask & ((1u << lane) - 1u))] = cell;
    }
    __syncthreads();
    // Pass 2: the block's threads score the boundary cells densely.
    const int count = nwork;
    for (int w = threadIdx.x; w < count; w += kThreads) {
      const int cell = work[w];
      nxt[cell] = relax_score<kFlag>(cur, ew, cell, gy0 + cell / ew, gx0 + cell % ew, H, W, L,
                                     c_total, f, data, rows, prog, direct, diagonal);
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int gy = blockIdx.y * kTileH + r, gx = blockIdx.x * kTileW + c;
    if (gy < H && gx < W) out[(size_t)gy * W + gx] = cur[(r + steps) * ew + c + steps];
  }
}

bool make_features(int c_total, int nfeat, const int* kinds, const int* offs, const int* chans,
                   const float* weights, Features* f) {
  if (nfeat < 1 || nfeat > kMaxFeat || c_total < 1 || c_total > kMaxChan ||
      1 + 2 * c_total + nfeat > kRowStride)
    return false;
  f->n = nfeat;
  for (int i = 0; i < kMaxFeat; ++i) {
    const bool on = i < nfeat;
    f->kind[i] = on ? kinds[i] : 0;
    f->off[i] = on ? offs[i] : 0;
    f->ch[i] = on ? chans[i] : 0;
    f->weight[i] = on ? weights[i] : 0.0f;
    if (on && (f->ch[i] < 1 || f->off[i] < 0 || f->off[i] + f->ch[i] > c_total)) return false;
  }
  return true;
}

bool is_flagship(int c_total, const Features& f) {
  if (c_total != kFlagC || f.n != kFlagNF) return false;
  for (int i = 0; i < kFlagNF; ++i)
    if (f.kind[i] != flag_kind(i) || f.off[i] != flag_off(i) || f.ch[i] != flag_ch(i))
      return false;
  return true;
}

}  // namespace

// rows: float32 [L + 1, 32] scratch, from table float32 [1 + 2C, L].
// kinds/offs/chans/weights: host arrays of nfeat entries.
extern "C" int relax_label_rows(const void* table, void* rows, int L, int c_total, int nfeat,
                                const int* kinds, const int* offs, const int* chans,
                                const float* weights, void* stream) {
  Features f;
  if (!make_features(c_total, nfeat, kinds, offs, chans, weights, &f))
    return (int)cudaErrorInvalidValue;
  relax_label_rows_kernel<<<(L + 1 + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)table, (float*)rows, L, c_total, f);
  return (int)cudaGetLastError();
}

// Which instantiation of relax_sweeps_kernel a layout takes: 1 for the
// flagship's (kFlag = true), 0 for the generic one, -1 for a layout the
// kernel refuses.
extern "C" int relax_instantiation(int c_total, int nfeat, const int* kinds, const int* offs,
                                   const int* chans, const float* weights) {
  Features f;
  if (!make_features(c_total, nfeat, kinds, offs, chans, weights, &f)) return -1;
  return is_flagship(c_total, f) ? 1 : 0;
}

// `steps` sub-steps: labels -> out (int32 [H, W], distinct buffers); data
// float32 [C, H, W]; rows from relax_label_rows; prog: device float32 [H]
// progressive-compactness row factor, or null.  Sub-step k updates the
// pixels with floor_mod(row0 + y + x, num_phases) == (phase + k) %
// num_phases; row0 is the global row of row 0 (it may be negative).
extern "C" int relax_sweeps(const void* labels, const void* data, const void* rows, void* out,
                            int H, int W, int L, int c_total, int nfeat, const int* kinds,
                            const int* offs, const int* chans, const float* weights,
                            const void* prog, float direct, float diagonal, int steps,
                            int phase, int num_phases, int row0, void* stream) {
  Features f;
  if (steps < 1 || num_phases < 1 || phase < 0 || phase >= num_phases ||
      !make_features(c_total, nfeat, kinds, offs, chans, weights, &f))
    return (int)cudaErrorInvalidValue;
  const size_t eh = kTileH + 2 * steps, ew = kTileW + 2 * steps;
  const size_t smem = (2 * eh * ew + (eh - 2) * (ew - 2)) * sizeof(int);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  const bool flag = is_flagship(c_total, f);
  const void* fn = flag ? (const void*)relax_sweeps_kernel<true>
                        : (const void*)relax_sweeps_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (flag)
    relax_sweeps_kernel<true><<<grid, kThreads, smem, s>>>(
        (const int*)labels, (const float*)data, (const float*)rows, (int*)out, H, W, L, c_total,
        f, (const float*)prog, direct, diagonal, steps, phase, num_phases, row0);
  else
    relax_sweeps_kernel<false><<<grid, kThreads, smem, s>>>(
        (const int*)labels, (const float*)data, (const float*)rows, (int*)out, H, W, L, c_total,
        f, (const float*)prog, direct, diagonal, steps, phase, num_phases, row0);
  return (int)cudaGetLastError();
}
