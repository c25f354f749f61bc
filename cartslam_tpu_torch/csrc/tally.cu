// Kernels K2 (moment tally), K4 (vote tally) and K7 (label tally): per-label
// integer sums.
//
// K2 replaces the Pallas moment_tally_pallas (cartslam_tpu/ops/pallas/
// tally.py:231, body :178): the per-label table [1 + 2C, L] of pixel count,
// per-channel sums and per-channel sums of squares, negative labels dropped.
// K4 replaces vote_tally_pallas (ops/pallas/tally.py:102, body :61): per-label
// counts [L, P] of the plane classes.
// K7 replaces label_tally_pallas (ops/pallas/tally.py:318): per-label column
// sums [L, C] of an integer matrix [B, C] of any width; init_stats sends its
// rows [1, d, d^2] here when it has more than 8 channels.
//
// On the TPU all three are one-hot matmuls over bf16 byte planes (K7 with a
// Khatri-Rao decomposition of the label), exact while a table entry stays
// below 2^24.  Here they are integer scatter-adds.
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
// What bounds them on an H100: atomic throughput on the few labels a warp
// touches (superpixel labels are spatially coherent, so the 32 pixels of a
// warp hold 1-3 labels).  K2 therefore aggregates within the warp first
// (__match_any_sync groups lanes of equal label, the group leader sums the
// group's rows and issues one atomic per table row); K4 is the plain
// one-atomic-per-pixel histogram.  K7 aggregates the same way, one column at
// a time through a per-warp shared buffer: a per-block copy of the table does
// not fit (L = 3329 labels x 19 columns x 8 bytes = 506 KB against 227 KB of
// shared memory), so the atomics go to device memory, one per label group
// and column.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;
constexpr int kThreads = 256;

__global__ void moment_tally_kernel(const int* __restrict__ labels,
                                    const int* __restrict__ data, int N, int C, int L,
                                    unsigned long long* __restrict__ acc) {
  __shared__ int vals[kThreads * kMaxC];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int lab = i < N ? labels[i] : -1;
  const bool keep = lab >= 0 && lab < L;
  const unsigned active = __ballot_sync(0xffffffffu, keep);
  if (!keep) return;
  for (int c = 0; c < C; ++c) vals[threadIdx.x * kMaxC + c] = data[(size_t)c * N + i];
  const unsigned peers = __match_any_sync(active, lab);
  __syncwarp(active);
  if (lane != __ffs(peers) - 1) return;
  const int base = threadIdx.x - lane;
  atomicAdd(&acc[lab], (unsigned long long)__popc(peers));
  for (int c = 0; c < C; ++c) {
    long long s = 0, ss = 0;
    for (unsigned m = peers; m; m &= m - 1) {
      const long long v = vals[(base + __ffs(m) - 1) * kMaxC + c];
      s += v;
      ss += v * v;
    }
    atomicAdd(&acc[(size_t)(1 + c) * L + lab], (unsigned long long)s);
    atomicAdd(&acc[(size_t)(1 + C + c) * L + lab], (unsigned long long)ss);
  }
}

__global__ void label_tally_kernel(const int* __restrict__ labels,
                                   const int* __restrict__ values, int B, int C, int L,
                                   unsigned long long* __restrict__ acc) {
  __shared__ int buf[kThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int lab = i < B ? labels[i] : -1;
  const bool keep = lab >= 0 && lab < L;
  // Every lane takes part (no early exit): dropped lanes group under -1.
  const unsigned peers = __match_any_sync(0xffffffffu, keep ? lab : -1);
  const bool leader = keep && lane == __ffs(peers) - 1;
  const int base = threadIdx.x - lane;
  for (int c = 0; c < C; ++c) {
    buf[threadIdx.x] = keep ? values[(size_t)i * C + c] : 0;
    __syncwarp();
    if (leader) {
      long long s = 0;
      for (unsigned m = peers; m; m &= m - 1) s += buf[base + __ffs(m) - 1];
      atomicAdd(&acc[(size_t)lab * C + c], (unsigned long long)s);
    }
    __syncwarp();
  }
}

__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ll2float_rn((long long)acc[i]);
}

__global__ void vote_tally_kernel(const int* __restrict__ labels,
                                  const uint8_t* __restrict__ votes, int N, int L, int P,
                                  int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int lab = labels[i];
  const int v = votes[i];
  if (lab >= 0 && lab < L && v < P) atomicAdd(&out[lab * P + v], 1);
}

}  // namespace

// labels int32 [N], data int32 [C, N] (C <= 8), acc int64 scratch [1 + 2C, L],
// out float32 [1 + 2C, L], or null to leave the exact int64 sums in acc.
extern "C" int moment_tally(const void* labels, const void* data, int N, int C, int L,
                            void* acc, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = (1 + 2 * C) * L;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)n * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  if (N > 0)
    moment_tally_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const int*)labels, (const int*)data, N, C, L, (unsigned long long*)acc);
  if (out != nullptr)
    to_float_kernel<<<(n + 255) / 256, 256, 0, s>>>((const unsigned long long*)acc,
                                                    (float*)out, n);
  return (int)cudaGetLastError();
}

// labels int32 [N], votes uint8 [N], out int32 [L, P].
extern "C" int vote_tally(const void* labels, const void* votes, int N, int L, int P,
                          void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)L * P * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (N > 0)
    vote_tally_kernel<<<(N + 255) / 256, 256, 0, s>>>(
        (const int*)labels, (const uint8_t*)votes, N, L, P, (int*)out);
  return (int)cudaGetLastError();
}

// K7. labels int32 [B], values int32 [B, C], acc int64 scratch [L, C],
// out float32 [L, C], or null to leave the exact int64 sums in acc.
extern "C" int label_tally(const void* labels, const void* values, int B, int C, int L,
                           void* acc, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n = L * C;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)n * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  if (B > 0 && C > 0)
    label_tally_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        (const int*)labels, (const int*)values, B, C, L, (unsigned long long*)acc);
  if (n > 0 && out != nullptr)
    to_float_kernel<<<(n + 255) / 256, 256, 0, s>>>((const unsigned long long*)acc,
                                                    (float*)out, n);
  return (int)cudaGetLastError();
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
