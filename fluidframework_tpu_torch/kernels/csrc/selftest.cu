// Build-and-launch self test: o = 2 * x on int32.
//
// Replaces: fluidframework_tpu/mergetree/pallas_ops.py,
//   _pallas_available.probe_kernel (the `o = x * 2` lowering probe on an
//   int32 [8, 128] block that guards the Pallas dispatch there).
// Here it is not a probe with a fallback behind it: it is the first launch
// of the kernel library, and a failure raises.
//
// Bound on the H100: bytes. It reads 4 B and writes 4 B per element
// (8 KB at [8, 128]), so the time is one launch; the design is one thread
// per element.

#include <cuda_runtime.h>

namespace {

__global__ void selftest_kernel(const int* __restrict__ x,
                                int* __restrict__ o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * 2;
}

}  // namespace

extern "C" const char* fluid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int fluid_selftest(const void* x, void* o, int n, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (n > 0) {
    selftest_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(o), n);
  }
  return static_cast<int>(cudaGetLastError());
}
