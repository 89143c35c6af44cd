// A probe of the 1-bit tensor-core MMA (`mma_b1`, bmma.cuh) that B2 and B7
// run on: no rate for the 1-bit form is published, so chip_smoke.py measures
// it here and prices B2's and B7's bound with it.  It is not part of the
// port's library; chip_smoke.py builds it on its own, as
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
//       -I src/repro_torch/kernels/csrc -shared -o libbmma_rate.so probes/bmma_rate.cu
#include <cstdint>

#include <cuda_runtime.h>

#include "bmma.cuh"

namespace {

// The issue rate of the 1-bit MMA alone: each warp runs `iters` rounds of 8
// independent MMAs on registers, and each block reports the SM clocks it
// took.  The sink keeps the MMAs from being dropped.
__global__ void bmma_rate_kernel(int iters, long long* cycles, int* sink) {
  int acc[8][4] = {};
  const uint32_t a = threadIdx.x * 2654435761u, b = a ^ 0x9e3779b9u;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_b1(acc[j], a, a + j, a ^ j, ~a, b, b + j);
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 0x7fffffff) *sink = s;
}

}  // namespace

extern "C" {

// Times the 1-bit MMA's issue: `blocks` blocks of `threads` threads, `iters`
// rounds of 8 MMAs a warp; cycles[b] gets block b's SM clocks.
int bmma_issue_rate(int blocks, int threads, int iters, void* cycles, void* sink,
                    void* stream) {
  bmma_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<long long*>(cycles), static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
