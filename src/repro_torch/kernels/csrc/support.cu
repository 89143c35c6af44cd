// Support sweeps of the frontier-batched Eclat for Hopper (sm_90a).
//
//   B1  multi_extension_supports:  S[k, i] = sum_w popc(items[i, w] & tids[k, w])
//   B3  extension_supports:        S[i]    = sum_w popc(items[i, w] & tid[w])
//
// Words are the port's packed bitmaps (bit t % 32 of word t / 32), read as
// uint32.  Outputs are exact int32 counts.  Each entry point has a plain C
// interface for ctypes: it launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so a refused launch is reported at once.
//
// The TPU kernels walk W as the sequential minor grid axis with the sum held
// in the output block.  Here W is a loop inside the block.  In B1 the blocks
// of one output run in parallel over W chunks, adding their partial counts
// with integer atomics (exact and order-free); in B3 a block owns a row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// B1 register tile: each thread keeps kPrefixTile x kItemTile counters, so a
// word of an item row is loaded once for kPrefixTile prefixes and a word of a
// prefix tidlist once for kItemTile items.
constexpr int kItemTile = 4;
constexpr int kPrefixTile = 8;
// B1 grid shaping: a W chunk is at least kMinChunk words (4 per thread), and
// the chunks are cut small enough to give about two blocks per SM.
constexpr int kMinChunk = 4 * kThreads;
constexpr int kBlocksPerSm = 2;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// grid = (W chunks, prefix tiles, item tiles); block = kThreads threads that
// stride over the chunk with coalesced 32-bit loads.
__global__ void __launch_bounds__(kThreads)
multi_support_kernel(const uint32_t* __restrict__ items,
                     const uint32_t* __restrict__ tids,
                     int32_t* __restrict__ out, int K, int I, int W, int chunk) {
  const int i0 = blockIdx.z * kItemTile;
  const int k0 = blockIdx.y * kPrefixTile;
  const int w_begin = blockIdx.x * chunk;
  const int w_end = min(W, w_begin + chunk);

  // Ragged edges: rows past K or I read as zero words and are never stored.
  const uint32_t* item_row[kItemTile];
  bool item_ok[kItemTile];
#pragma unroll
  for (int ii = 0; ii < kItemTile; ++ii) {
    item_ok[ii] = i0 + ii < I;
    item_row[ii] = items + static_cast<size_t>(item_ok[ii] ? i0 + ii : 0) * W;
  }
  const uint32_t* tid_row[kPrefixTile];
  bool tid_ok[kPrefixTile];
#pragma unroll
  for (int kk = 0; kk < kPrefixTile; ++kk) {
    tid_ok[kk] = k0 + kk < K;
    tid_row[kk] = tids + static_cast<size_t>(tid_ok[kk] ? k0 + kk : 0) * W;
  }

  int acc[kPrefixTile][kItemTile];
#pragma unroll
  for (int kk = 0; kk < kPrefixTile; ++kk)
#pragma unroll
    for (int ii = 0; ii < kItemTile; ++ii) acc[kk][ii] = 0;

  for (int w = w_begin + threadIdx.x; w < w_end; w += kThreads) {
    uint32_t a[kItemTile];
#pragma unroll
    for (int ii = 0; ii < kItemTile; ++ii) a[ii] = item_ok[ii] ? __ldg(item_row[ii] + w) : 0u;
#pragma unroll
    for (int kk = 0; kk < kPrefixTile; ++kk) {
      const uint32_t t = tid_ok[kk] ? __ldg(tid_row[kk] + w) : 0u;
#pragma unroll
      for (int ii = 0; ii < kItemTile; ++ii) acc[kk][ii] += __popc(a[ii] & t);
    }
  }

  // Block reduction: warp shuffles, one partial per warp in shared memory,
  // then one atomic add per output and block.
  __shared__ int partial[kWarps][kPrefixTile * kItemTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < kPrefixTile; ++kk)
#pragma unroll
    for (int ii = 0; ii < kItemTile; ++ii) {
      const int v = warp_sum(acc[kk][ii]);
      if (lane == 0) partial[warp][kk * kItemTile + ii] = v;
    }
  __syncthreads();
  if (threadIdx.x < kPrefixTile * kItemTile) {
    const int k = k0 + threadIdx.x / kItemTile;
    const int i = i0 + threadIdx.x % kItemTile;
    if (k < K && i < I) {
      int s = 0;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) s += partial[wp][threadIdx.x];
      atomicAdd(out + static_cast<size_t>(k) * I + i, s);
    }
  }
}

// B3, a GEMV shape: one block per item row.  Its threads stride the row with
// coalesced 32-bit loads; warp shuffles and shared memory reduce it to one
// store, so no atomics and no zeroing launch.  With I = 100 rows, a block per
// row is what puts enough loads in flight on the card's 132 SMs once rows
// are long.
__global__ void __launch_bounds__(kThreads)
single_support_kernel(const uint32_t* __restrict__ items,
                      const uint32_t* __restrict__ tid,
                      int32_t* __restrict__ out, int W) {
  const uint32_t* row = items + static_cast<size_t>(blockIdx.x) * W;
  int acc = 0;
  for (int w = threadIdx.x; w < W; w += kThreads) acc += __popc(__ldg(row + w) & __ldg(tid + w));
  acc = warp_sum(acc);
  __shared__ int partial[kWarps];
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += partial[wp];
    out[blockIdx.x] = sum;
  }
}

}  // namespace

extern "C" {

// items uint32[I, W], tids uint32[K, W] -> out int32[K, I] (row-major, contiguous).
// `sms` is the card's SM count, which the caller looks up once, so a launch
// makes no device query.
int multi_extension_supports(const void* items, const void* tids, void* out,
                             int K, int I, int W, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed =
      cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(K) * I, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (K > 0 && I > 0 && W > 0) {
    const int k_tiles = (K + kPrefixTile - 1) / kPrefixTile;
    const int i_tiles = (I + kItemTile - 1) / kItemTile;
    const int tiles = k_tiles * i_tiles;
    const int want = (kBlocksPerSm * max(sms, 1) + tiles - 1) / tiles;
    const int most = (W + kMinChunk - 1) / kMinChunk;
    const int splits = max(1, min(want, most));
    const int chunk = (W + splits - 1) / splits;
    const dim3 grid(splits, k_tiles, i_tiles);
    multi_support_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(items), static_cast<const uint32_t*>(tids),
        static_cast<int32_t*>(out), K, I, W, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// items uint32[I, W], tid uint32[W] -> out int32[I].
int extension_supports(const void* items, const void* tid, void* out, int I, int W,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (I > 0) {
    single_support_kernel<<<I, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(items), static_cast<const uint32_t*>(tid),
        static_cast<int32_t*>(out), W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
