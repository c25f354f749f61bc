// Device time stamps: the card's %globaltimer (nanoseconds) written into
// one slot of an int64 row, in stream order.
//
// Replaces no TPU kernel.  A traced System places one launch before a
// frame's copies in, one at the start of the captured step, one after each
// module and one after the step's copies out, so that each module's device
// time can be read from inside the one CUDA graph replay of a frame, where
// no host range can see (runtime/timing.py turns the row into rows on the
// host clock).  A launch is one thread writing 8 bytes: what bounds it is
// the launch itself, a few microseconds of device time.  %globaltimer is
// read after the launch's stream dependencies are met, so a stamp marks the
// end of the work enqueued before it on the same stream.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* row, int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  row[k] = (long long)t;
}

}  // namespace

// row: int64 [n] on the card; k: the slot, 0 <= k < n (the wrapper checks).
extern "C" int stamp(void* row, int k, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)row, k);
  return (int)cudaGetLastError();
}
