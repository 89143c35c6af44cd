// Launch sizing shared by B1 (support.cu) and B5 (delta_support.cu): how many
// blocks, or clusters of blocks, of a kernel the current device holds at once.
// The CUDA occupancy queries behind it are asked once per device, kernel and
// launch shape; later launches read the answer from a cache.
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
