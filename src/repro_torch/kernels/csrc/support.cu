// Support sweeps of the frontier-batched Eclat for Hopper (sm_90a).
//
//   B1  multi_extension_supports:  S[k, i] = sum_w popc(items[i, w] & tids[k, w])
//   B3  extension_supports:        S[i]    = sum_w popc(items[i, w] & tid[w])
//
// They replace the TPU kernels repro/kernels/multi_support.py::
// multi_extension_supports_pallas and repro/kernels/bitmap_support.py::
// extension_supports_pallas.
// Words are the port's packed bitmaps (bit t % 32 of word t / 32), read as
// uint32.  Outputs are exact int32 counts.  Each entry point has a plain C
// interface for ctypes: it launches on the caller's stream, allocates nothing,
// and returns the launch's error, so a refused launch is reported at once.
//
// The TPU kernels walk W as the sequential minor grid axis with the sum held
// in the output block.  Here W is a loop inside the block.  In B1 an output
// tile's W is cut into chunks, one block each, and the blocks of one tile
// form a thread-block cluster: they add their partial counts through
// distributed shared memory, and the cluster's first block stores each count
// once, so B1 needs neither a zeroed output nor atomics.  In B3 a block owns
// a row.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "occupancy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // B3
constexpr int kWarps = kThreads / 32;
// B1 register tile: each thread keeps kPrefixTile x kItemTile counters, so a
// word of an item row is loaded once for kPrefixTile prefixes and a word of a
// prefix tidlist once for kItemTile items.  32 counters: one per lane once a
// warp has reduced them.
constexpr int kItemTile = 4;
constexpr int kPrefixTile = 8;
constexpr int kPairs = kPrefixTile * kItemTile;
static_assert(kPairs == 32, "a warp reduces its 32 counters to one a lane");
// B1 blocks, both at most 128 registers a thread: wide ones of 512 threads,
// one an SM (so a cluster cannot stack two of its blocks on one SM, and each
// SM has 16 warps to hide the loads), where W gives each thread 4 words or
// more; narrow ones of 128 threads, four an SM, for short rows, where a wide
// block would leave most of its threads idle.
constexpr int kWide = 512;
constexpr int kNarrow = 128;
// B1 clusters: at most 8 blocks (the portable cluster size), each with a chunk
// of at least 4 words a thread.
constexpr int kMaxCluster = 8;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums v[0..31] over the warp and leaves, on lane l, the sum of v[l] in v[0]:
// at each step S (16, 8, 4, 2, 1) a lane keeps the half of its counters that
// bit S of its lane index selects and sends the other half to its partner,
// 31 shuffles in all (32 separate warp sums would take 160).  The steps are
// a template recursion so that every index is a constant and v stays in
// registers.
template <int S>
__device__ __forceinline__ void warp_transpose_sum(int (&v)[kPairs], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int send = upper ? v[j] : v[j + S];
    const int keep = upper ? v[j + S] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
  if constexpr (S > 1) warp_transpose_sum<S / 2>(v, lane);
}

// grid = (cluster, prefix tiles, item tiles), clusters of (cluster, 1, 1):
// block `rank` of a cluster sweeps words [rank * chunk, (rank + 1) * chunk)
// of its tile.
template <int kT>
__global__ void __launch_bounds__(kT, kWide / kT)
multi_support_kernel(const uint32_t* __restrict__ items,
                     const uint32_t* __restrict__ tids,
                     int32_t* __restrict__ out, int K, int I, int W, int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int k0 = blockIdx.y * kPrefixTile;
  const int i0 = blockIdx.z * kItemTile;
  const int w_begin = static_cast<int>(rank) * chunk;
  const int w_end = min(W, w_begin + chunk);

  // Ragged edges: rows past K or I read the last row again; their counts
  // are never stored.
  const uint32_t* item_row[kItemTile];
#pragma unroll
  for (int ii = 0; ii < kItemTile; ++ii)
    item_row[ii] = items + static_cast<size_t>(min(i0 + ii, I - 1)) * W;
  const uint32_t* tid_row[kPrefixTile];
#pragma unroll
  for (int kk = 0; kk < kPrefixTile; ++kk)
    tid_row[kk] = tids + static_cast<size_t>(min(k0 + kk, K - 1)) * W;

  int acc[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) acc[p] = 0;

  for (int w = w_begin + threadIdx.x; w < w_end; w += kT) {
    uint32_t a[kItemTile];
#pragma unroll
    for (int ii = 0; ii < kItemTile; ++ii) a[ii] = __ldg(item_row[ii] + w);
#pragma unroll
    for (int kk = 0; kk < kPrefixTile; ++kk) {
      const uint32_t t = __ldg(tid_row[kk] + w);
#pragma unroll
      for (int ii = 0; ii < kItemTile; ++ii) acc[kk * kItemTile + ii] += __popc(a[ii] & t);
    }
  }

  // Warp, then block: lane l of each warp holds counter l, the warps' sums
  // meet in shared memory, and block_sum[p] is the block's count of pair p.
  __shared__ int warp_sums[kT / 32][kPairs];
  __shared__ int block_sum[kPairs];
  const int lane = threadIdx.x & 31;
  warp_transpose_sum<16>(acc, lane);
  warp_sums[threadIdx.x >> 5][lane] = acc[0];
  __syncthreads();
  int s = 0;
  if (threadIdx.x < kPairs) {
#pragma unroll
    for (int wp = 0; wp < kT / 32; ++wp) s += warp_sums[wp][threadIdx.x];
    block_sum[threadIdx.x] = s;
  }
  const int k = k0 + threadIdx.x / kItemTile;
  const int i = i0 + threadIdx.x % kItemTile;
  const bool store = threadIdx.x < kPairs && k < K && i < I;
  if (cluster.num_blocks() == 1) {  // the block holds the whole count
    if (store) out[static_cast<size_t>(k) * I + i] = s;
    return;
  }
  // Cluster: the first block adds every block's counts from its shared
  // memory and stores each output once.  The second barrier keeps every block
  // (and its shared memory) alive until those reads are done.
  cluster.sync();
  if (rank == 0 && store) {
    s = 0;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
      s += *cluster.map_shared_rank(&block_sum[threadIdx.x], r);
    out[static_cast<size_t>(k) * I + i] = s;
  }
  cluster.sync();
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

// How B1 is launched for one call.
struct MultiPlan {
  int threads, k_tiles, i_tiles, cluster, chunk;
};

const void* multi_kernel(int threads) {
  return threads == kWide ? reinterpret_cast<const void*>(multi_support_kernel<kWide>)
                          : reinterpret_cast<const void*>(multi_support_kernel<kNarrow>);
}

cudaLaunchConfig_t multi_config(const MultiPlan& p, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.k_tiles, p.i_tiles);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Wide blocks where W gives each thread 4 words, else narrow ones.  One
// cluster per output tile, sized so
// that every cluster is resident at once (one wave): the kernel lasts as
// long as the SM with most blocks, ceil(tiles * C / sms) blocks of 1/C of a
// tile's work each, so among the cluster sizes C that fit in one wave take
// the one that makes this least, the smaller on a tie (a smaller
// reduction); where not even single blocks fit in one wave, C = 1.
cudaError_t plan_multi(int K, int I, int W, int sms, MultiPlan* p) {
  p->k_tiles = static_cast<int>(ceil_div(K, kPrefixTile));
  p->i_tiles = static_cast<int>(ceil_div(I, kItemTile));
  const long long tiles = static_cast<long long>(p->k_tiles) * p->i_tiles;
  const long long n_sm = sms > 0 ? sms : 1;
  p->threads = W >= 4 * kWide ? kWide : kNarrow;
  const int most = max(1, min(kMaxCluster, W / (4 * p->threads)));
  int best = 1;
  for (int c = 2; c <= most; ++c) {
    int fit = 0;
    const cudaError_t err = resident(multi_kernel(p->threads), p->threads, 0, c, &fit);
    if (err != cudaSuccess) return err;
    if (tiles > fit) break;
    if (ceil_div(tiles * c, n_sm) * best < ceil_div(tiles * best, n_sm) * c) best = c;
  }
  p->cluster = best;
  p->chunk = static_cast<int>(ceil_div(W, best));
  return cudaSuccess;
}

template <int kT>
cudaError_t launch_multi(const cudaLaunchConfig_t& cfg, const void* items, const void* tids,
                         void* out, int K, int I, int W, int chunk) {
  return cudaLaunchKernelEx(&cfg, multi_support_kernel<kT>,
                            static_cast<const uint32_t*>(items),
                            static_cast<const uint32_t*>(tids), static_cast<int32_t*>(out), K,
                            I, W, chunk);
}

}  // namespace

extern "C" {

// items uint32[I, W], tids uint32[K, W] -> out int32[K, I] (row-major, contiguous).
// `sms` is the card's SM count, which the caller looks up once.
int multi_extension_supports(const void* items, const void* tids, void* out,
                             int K, int I, int W, int sms, void* stream) {
  if (K <= 0 || I <= 0) return static_cast<int>(cudaSuccess);
  MultiPlan p;
  cudaError_t err = plan_multi(K, I, W, sms, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = multi_config(p, static_cast<cudaStream_t>(stream), &attr);
  err = p.threads == kWide ? launch_multi<kWide>(cfg, items, tids, out, K, I, W, p.chunk)
                           : launch_multi<kNarrow>(cfg, items, tids, out, K, I, W, p.chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What multi_extension_supports launches for these shapes, into facts[11]:
// grid x, y, z, threads a block, cluster size, chunk words, resident blocks
// an SM, clusters resident at once, waves, registers a thread, local
// (spilled) bytes a thread.
int multi_extension_supports_facts(int K, int I, int W, int sms, int* facts) {
  MultiPlan p;
  cudaError_t err = plan_multi(K, I, W, sms, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernel = multi_kernel(p.threads);
  int per_sm = 0, fit = 0;
  err = resident(kernel, p.threads, 0, 0, &per_sm);
  if (err == cudaSuccess) err = resident(kernel, p.threads, 0, p.cluster, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(p.k_tiles) * p.i_tiles;
  const int values[11] = {p.cluster, p.k_tiles, p.i_tiles, p.threads, p.cluster, p.chunk,
                          per_sm, fit, static_cast<int>(ceil_div(tiles, max(fit, 1))),
                          fa.numRegs, static_cast<int>(fa.localSizeBytes)};
  for (int j = 0; j < 11; ++j) facts[j] = values[j];
  return static_cast<int>(cudaSuccess);
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
