// A probe of the launch floor: an empty kernel, timed by chip_smoke.py the
// way it times every kernel of the port (a CUDA graph of 100 launches), so
// that a kernel's gap to its bound can be split into what a launch of the
// same grid costs with no work in it and the rest.  It is not part of the
// port's library; chip_smoke.py builds it on its own, as
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
//       -I src/repro_torch/kernels/csrc -shared -o liblaunch_floor.so probes/launch_floor.cu
#include <cuda_runtime.h>

#include "occupancy.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// One launch of the empty kernel over `blocks` blocks of `threads` threads, in
// clusters of `cluster` blocks where cluster > 1 (blocks a multiple of it),
// on `stream`; returns the launch's error.
int empty_launch(int blocks, int threads, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster <= 1) {
    empty_kernel<<<blocks, threads, 0, s>>>();
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(blocks), threads, cluster, s, &attr);
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(empty_kernel), nullptr);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
