// Launch sizing shared by B1 (support.cu) and B5 (delta_support.cu): how many
// blocks, or clusters of blocks, of a kernel the current device holds at once.
// The CUDA occupancy queries behind it are asked once per device, kernel and
// launch shape; later launches read the answer from a cache.  grid_facts
// describes a launch of B2 or B7 (mxu_support.cu, pair_support.cu) from the
// same queries.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// With cluster == 0: blocks of `kernel` (threads a block, dynamic shared
// bytes smem) resident on one SM.  With cluster >= 1: clusters of that many
// blocks resident on the whole device.  A kernel that needs more than the
// default 48 KB of dynamic shared memory is first allowed the device's
// opt-in maximum.
inline cudaError_t resident(const void* kernel, int threads, size_t smem, int cluster, int* n) {
  using Key = std::tuple<int, const void*, int, size_t, int>;
  static std::mutex lock;
  static std::map<Key, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const Key key{dev, kernel, threads, smem, cluster};
  std::lock_guard<std::mutex> hold(lock);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *n = hit->second;
    return cudaSuccess;
  }
  if (smem > 48 * 1024) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
  }
  if (cluster == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, threads, smem);
  } else {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  }
  if (err == cudaSuccess) known.emplace(key, *n);
  return err;
}

// What a launch of `kernel` over `grid` blocks of `threads` threads, with
// `smem` dynamic shared bytes and chunks of `chunk` words, looks like on a
// card of `sms` SMs, into facts[10]: grid x, y, z, threads a block, chunk
// words, shared bytes a block (static and dynamic), resident blocks an SM,
// waves, registers a thread, local (spilled) bytes a thread.  Nothing is
// launched.
inline cudaError_t grid_facts(const void* kernel, dim3 grid, int threads, int chunk, size_t smem,
                              int sms, int* facts) {
  int per_sm = 0;
  cudaError_t err = resident(kernel, threads, smem, 0, &per_sm);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(grid.x) * grid.y * grid.z;
  const long long wave = static_cast<long long>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int values[10] = {static_cast<int>(grid.x), static_cast<int>(grid.y),
                          static_cast<int>(grid.z), threads, chunk,
                          static_cast<int>(fa.sharedSizeBytes + smem), per_sm,
                          static_cast<int>(ceil_div(blocks, wave)), fa.numRegs,
                          static_cast<int>(fa.localSizeBytes)};
  for (int j = 0; j < 10; ++j) facts[j] = values[j];
  return cudaSuccess;
}
