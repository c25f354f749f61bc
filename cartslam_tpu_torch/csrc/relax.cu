// Kernel K3: one synchronous contour-relaxation sweep, fixed ('frame') stats.
//
// Replaces the Pallas relax_phase_pallas (cartslam_tpu/ops/pallas/relax.py:240,
// body _make_phase_kernel :39) in its one-phase form.  Its plain version is
// relax_sweep_plain in cartslam_tpu_torch/kernels/relax.py, the port of
// phase_update (cartslam_tpu/ops/superpixels.py:335-417).
//
// Per pixel: if it is a label-boundary pixel, score the 9 labels of its 3x3
// neighbourhood in _OFFSETS order (x outer, y inner) as
//   clique(cand) + sum_f w_f * [c_f(old - pixel) + c_f(cand + pixel)
//                               - c_f(old) - c_f(cand)]     (0 if cand == old)
// with the Gaussian-NLL and compactness costs of the per-label moments,
// keep the first strict-< minimum, and write the winner's label and stat
// rows.  Out-of-bounds candidates are masked.  The sweep reads only the old
// labels and stat image, so every pixel is an independent thread and the
// caller ping-pongs two buffers.
//
// What bounds it on an H100: nothing heavy -- each boundary pixel reads 9
// stat vectors (15 floats at the flagship geometry) and evaluates ~50 logf;
// a full-frame sweep moves ~60 MB (stat image in and out), so it is
// memory-bound and short.
//
// Rounding: the float operations follow the plain version's order exactly
// (costs summed over channels then divided by C, variance floor 1/12, logf),
// and this file is compiled with -fmad=false so that a*b+c is not fused into
// an FMA: the plain version rounds after every operation.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxFeat = 4;
constexpr int kMaxStat = 17;  // 1 + 2 * 8 channels
constexpr float kVarFloor = (float)(1.0 / 12.0);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);

struct Features {
  int n;
  int kind[kMaxFeat];  // 0 = gaussian, 1 = compactness
  int off[kMaxFeat];   // first channel of the feature in the packed layout
  int ch[kMaxFeat];    // channels of the feature
  float weight[kMaxFeat];
};

__device__ float feature_cost(const float* r, int c_total, int kind, int off, int ch) {
  const float n = r[0];
  const float n_safe = n < 1.0f ? 1.0f : n;
  float acc = 0.0f;
  if (kind == 0) {
    const float half = n / 2.0f;
    for (int c = 0; c < ch; ++c) {
      const float s = r[1 + off + c];
      const float ss = r[1 + c_total + off + c];
      const float q = s / n_safe;
      float var = ss / n_safe - q * q;
      if (var < kVarFloor) var = kVarFloor;
      const float t = half * logf(kTwoPi * var) + half;
      acc = c == 0 ? t : acc + t;
    }
    acc = acc / (float)ch;
  } else {
    for (int c = 0; c < ch; ++c) {
      const float s = r[1 + off + c];
      const float ss = r[1 + c_total + off + c];
      const float t = ss - (s * s) / n_safe;
      acc = c == 0 ? t : acc + t;
    }
  }
  return n > 0.0f ? acc : 0.0f;
}

__global__ void relax_sweep_kernel(const int* __restrict__ labels,
                                   const float* __restrict__ stat,
                                   const float* __restrict__ pix,
                                   int* __restrict__ out_labels,
                                   float* __restrict__ out_stat, int H, int W,
                                   int c_total, Features f,
                                   const float* __restrict__ prog, float direct,
                                   float diagonal) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t hw = (size_t)H * W;
  const int p = y * W + x;
  const int nstat = 1 + 2 * c_total;
  const int lab = labels[p];

  int nb[9];  // j = (dx + 1) * 3 + (dy + 1): the _OFFSETS order
  bool boundary = false;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int dx = j / 3 - 1, dy = j % 3 - 1;
    const int yy = y + dy, xx = x + dx;
    nb[j] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? labels[yy * W + xx] : -1;
    if (j != 4) boundary |= nb[j] != -1 && nb[j] != lab;
  }
  if (!boundary || lab == -1) {
    out_labels[p] = lab;
    for (int k = 0; k < nstat; ++k) out_stat[k * hw + p] = stat[k * hw + p];
    return;
  }

  float center[kMaxStat], pixr[kMaxStat], tmp[kMaxStat];
#pragma unroll
  for (int k = 0; k < kMaxStat; ++k) {
    if (k < nstat) {
      center[k] = stat[k * hw + p];
      pixr[k] = pix[k * hw + p];
      tmp[k] = center[k] - pixr[k];
    }
  }
  float old_cost[kMaxFeat], old_minus[kMaxFeat];
  for (int i = 0; i < f.n; ++i) {
    old_cost[i] = feature_cost(center, c_total, f.kind[i], f.off[i], f.ch[i]);
    old_minus[i] = feature_cost(tmp, c_total, f.kind[i], f.off[i], f.ch[i]);
  }
  const float pf = prog != nullptr ? prog[y] : 1.0f;

  float best = INFINITY;
  int best_label = lab;
  int best_p = p;
  for (int j = 0; j < 9; ++j) {
    const int cand = nb[j];
    if (cand == -1) continue;  // total = inf: never taken
    float clique = 0.0f;
#pragma unroll
    for (int j2 = 0; j2 < 9; ++j2) {
      if (j2 == 4) continue;
      const int dx2 = j2 / 3 - 1, dy2 = j2 % 3 - 1;
      const float cc = (dx2 == 0 || dy2 == 0) ? direct : diagonal;
      clique = clique + ((nb[j2] != -1 && nb[j2] != cand) ? cc : 0.0f);
    }
    float total = clique;
    const int cp = (y + j % 3 - 1) * W + (x + j / 3 - 1);
    if (cand != lab) {  // the old label's feature delta is exactly 0
      float rows[kMaxStat];
#pragma unroll
      for (int k = 0; k < kMaxStat; ++k) {
        if (k < nstat) {
          rows[k] = stat[k * hw + cp];
          tmp[k] = rows[k] + pixr[k];
        }
      }
      for (int i = 0; i < f.n; ++i) {
        const float cand_cost = feature_cost(rows, c_total, f.kind[i], f.off[i], f.ch[i]);
        const float cand_plus = feature_cost(tmp, c_total, f.kind[i], f.off[i], f.ch[i]);
        float delta = old_minus[i] + cand_plus - old_cost[i] - cand_cost;
        if (f.kind[i] == 1 && prog != nullptr) delta = delta * pf;
        total = total + f.weight[i] * delta;
      }
    }
    if (total < best) {
      best = total;
      best_label = cand;
      best_p = cp;
    }
  }
  out_labels[p] = best_label;
  for (int k = 0; k < nstat; ++k) out_stat[k * hw + p] = stat[k * hw + best_p];
}

}  // namespace

// labels int32 [H, W]; stat, pix float32 [1 + 2C, H, W]; outputs alike.
// kinds/offs/chans/weights: host arrays of nfeat entries; prog: device
// float32 [H] progressive-compactness row factor, or null.
extern "C" int relax_sweep(const void* labels, const void* stat, const void* pix,
                           void* out_labels, void* out_stat, int H, int W, int c_total,
                           int nfeat, const int* kinds, const int* offs, const int* chans,
                           const float* weights, const void* prog, float direct,
                           float diagonal, void* stream) {
  if (nfeat > kMaxFeat || 1 + 2 * c_total > kMaxStat) return (int)cudaErrorInvalidValue;
  Features f;
  f.n = nfeat;
  for (int i = 0; i < nfeat; ++i) {
    f.kind[i] = kinds[i];
    f.off[i] = offs[i];
    f.ch[i] = chans[i];
    f.weight[i] = weights[i];
  }
  const dim3 block(128);
  const dim3 grid((W + 127) / 128, H);
  relax_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)labels, (const float*)stat, (const float*)pix, (int*)out_labels,
      (float*)out_stat, H, W, c_total, f, (const float*)prog, direct, diagonal);
  return (int)cudaGetLastError();
}
