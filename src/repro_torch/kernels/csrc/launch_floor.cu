// An empty kernel: one block of one thread that does nothing.  Its device
// time per call, queued back to back as chip_smoke.py times every kernel,
// is the floor under any kernel's time on this card (launch and scheduling,
// no work), printed beside each kernel's bound.  No path launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
