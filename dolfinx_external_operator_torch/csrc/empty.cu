// A kernel that does nothing.  Its time inside a CUDA graph is the floor
// under any launch on this card, against which a kernel's own time is read
// (chip_smoke.py, phase 3, beside the von Mises kernel's).
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
