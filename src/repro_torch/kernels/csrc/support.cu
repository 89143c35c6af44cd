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
// once, so B1 needs neither a zeroed output nor atomics.  B3 does the same
// with two rows in place of a tile once rows are long; on shorter rows a
// block owns one row, or four short ones.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "occupancy.cuh"
#include "warp_sum.cuh"

namespace cg = cooperative_groups;

namespace {

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
// Clusters (B1 and B3): at most 8 blocks (the portable cluster size), each
// with a chunk of at least 4 words a thread.
constexpr int kMaxCluster = 8;
// B3 launch shapes, by the row length W: short rows (W <= 64, the main path's
// sample) take blocks of 64 threads over 4 rows, a word a thread; middle rows
// blocks of 256 threads over one row; long rows (W >= kClusterWords) blocks of
// 256 threads over 2 rows, the rows' W split over a cluster of up to 8
// blocks (4 words a thread or more).  A cluster costs its barriers, which
// pay only once a block would otherwise take many steps.  A thread of a
// middle or long row has kUnroll words of each row and of the tidlist in
// flight at once.
constexpr int kRowThreads = 256;
constexpr int kShortThreads = 64;
constexpr int kShortRows = 4;
constexpr int kLongRows = 2;
constexpr int kUnroll = 4;
constexpr int kShortUnroll = 1;
constexpr int kClusterWords = 8192;
static_assert(kClusterWords >= kMaxCluster * 4 * kRowThreads,
              "a block of a B3 cluster has at least 4 words a thread");

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

// B3, a GEMV shape: grid = (row groups x cluster), block `rank` of a group's
// cluster sweeps words [rank * chunk, (rank + 1) * chunk) of the group's kRows
// rows with coalesced 32-bit loads: a tidlist word is loaded once for kRows
// rows, and each thread issues kSteps words of every row and of the tidlist
// before it counts any, so no load waits on another.  Warp shuffles and
// shared memory reduce the block to one count a row; in a cluster, each block
// then writes its counts into the first block's shared memory, and after one
// cluster barrier the first block adds them (a block may write another's
// shared memory only once that block has started, hence the arrive at the
// top).  Rows past I read row I - 1 again and are never stored.  One store a
// row, no atomics, no zeroing launch.
template <int kT, int kRows, int kSteps>
__global__ void __launch_bounds__(kT)
single_support_kernel(const uint32_t* __restrict__ items,
                      const uint32_t* __restrict__ tid,
                      int32_t* __restrict__ out, int I, int W, int chunk, int cluster_size) {
  if (cluster_size > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int group = cluster_size == 1 ? static_cast<int>(blockIdx.x)
                                      : static_cast<int>(blockIdx.x) / cluster_size;
  const int rank = static_cast<int>(blockIdx.x) - group * cluster_size;
  const int i0 = group * kRows;
  const int w_begin = rank * chunk;
  const int w_end = min(W, w_begin + chunk);
  const uint32_t* row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) row[r] = items + static_cast<size_t>(min(i0 + r, I - 1)) * W;
  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;
  // Full steps (chunks are whole steps but for the row's last), then one
  // last step whose words past the chunk are skipped.
  int w = w_begin + threadIdx.x;
  for (; w + (kSteps - 1) * kT < w_end; w += kSteps * kT) {
    uint32_t a[kSteps][kRows], t[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      t[u] = __ldg(tid + w + u * kT);
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[u][r] = __ldg(row[r] + w + u * kT);
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += __popc(a[u][r] & t[u]);
  }
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int x = w + u * kT;
    if (x < w_end) {
      const uint32_t t = __ldg(tid + x);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += __popc(__ldg(row[r] + x) & t);
    }
  }

  __shared__ int partial[kT / 32][kRows];
  __shared__ int parts[kMaxCluster][kRows];  // the first block's: every block's counts
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int v = warp_sum(acc[r]);
    if (lane == 0) partial[threadIdx.x >> 5][r] = v;
  }
  __syncthreads();
  int sum = 0;
  if (threadIdx.x < kRows) {
#pragma unroll
    for (int wp = 0; wp < kT / 32; ++wp) sum += partial[wp][threadIdx.x];
  }
  const bool store = threadIdx.x < kRows && i0 + static_cast<int>(threadIdx.x) < I;
  if (cluster_size == 1) {  // the block holds the whole count
    if (store) out[i0 + threadIdx.x] = sum;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x < kRows) *cluster.map_shared_rank(&parts[rank][threadIdx.x], 0) = sum;
  cluster.sync();  // the writes are visible to the first block
  if (rank == 0 && store) {
    sum = 0;
    for (int r = 0; r < cluster_size; ++r) sum += parts[r][threadIdx.x];
    out[i0 + threadIdx.x] = sum;
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

dim3 multi_grid(const MultiPlan& p) { return dim3(p.cluster, p.k_tiles, p.i_tiles); }

// Wide blocks where W gives each thread 4 words, else narrow ones.  One
// cluster per output tile, sized by pick_cluster (occupancy.cuh): one wave,
// the least work on the busiest SM.
cudaError_t plan_multi(int K, int I, int W, int sms, MultiPlan* p) {
  p->k_tiles = static_cast<int>(ceil_div(K, kPrefixTile));
  p->i_tiles = static_cast<int>(ceil_div(I, kItemTile));
  const long long tiles = static_cast<long long>(p->k_tiles) * p->i_tiles;
  p->threads = W >= 4 * kWide ? kWide : kNarrow;
  const int most = max(1, min(kMaxCluster, W / (4 * p->threads)));
  const cudaError_t err = pick_cluster(multi_kernel(p->threads), p->threads, tiles, most, sms,
                                       &p->cluster);
  p->chunk = static_cast<int>(ceil_div(W, p->cluster));
  return err;
}

// How B3 is launched for one call: `groups` clusters of `cluster` blocks of
// `threads` threads over `rows` rows each.
struct SinglePlan {
  int threads, rows, groups, cluster, chunk;
};

const void* single_kernel(int rows) {
  return rows == 1
             ? reinterpret_cast<const void*>(single_support_kernel<kRowThreads, 1, kUnroll>)
         : rows == kLongRows
             ? reinterpret_cast<const void*>(
                   single_support_kernel<kRowThreads, kLongRows, kUnroll>)
             : reinterpret_cast<const void*>(
                   single_support_kernel<kShortThreads, kShortRows, kShortUnroll>);
}

// B3 is bound by bytes, so long rows' W is split over the largest cluster
// with which every cluster is resident at once: the most loads in flight
// that one wave holds.  Chunks are whole steps of the block's threads, so
// only a row's last chunk ends in part of a step (the cluster shrinks if
// that leaves one empty).
cudaError_t plan_single(int I, int W, SinglePlan* p) {
  const bool is_short = W <= kShortThreads;
  p->threads = is_short ? kShortThreads : kRowThreads;
  p->rows = is_short ? kShortRows : W < kClusterWords ? 1 : kLongRows;
  p->groups = static_cast<int>(ceil_div(I, p->rows));
  const int most = W < kClusterWords ? 1 : kMaxCluster;
  p->cluster = 1;
  for (int c = most; c > 1; --c) {
    int fit = 0;
    const cudaError_t err = resident(single_kernel(p->rows), p->threads, 0, c, &fit);
    if (err != cudaSuccess) return err;
    if (p->groups <= fit) {
      p->cluster = c;
      break;
    }
  }
  const int step = (is_short ? kShortUnroll : kUnroll) * p->threads;
  p->chunk = static_cast<int>(ceil_div(ceil_div(W, p->cluster), step) * step);
  if (W > 0) p->cluster = static_cast<int>(ceil_div(W, p->chunk));
  return cudaSuccess;
}

dim3 single_grid(const SinglePlan& p) { return dim3(static_cast<unsigned>(p.groups) * p.cluster); }

template <int kT, int kRows, int kSteps>
cudaError_t launch_single(const SinglePlan& p, const void* items, const void* tid, void* out,
                          int I, int W, cudaStream_t s) {
  const uint32_t* a = static_cast<const uint32_t*>(items);
  const uint32_t* t = static_cast<const uint32_t*>(tid);
  int32_t* o = static_cast<int32_t*>(out);
  if (p.cluster == 1) {
    single_support_kernel<kT, kRows, kSteps>
        <<<single_grid(p), kT, 0, s>>>(a, t, o, I, W, p.chunk, 1);
    return cudaSuccess;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(single_grid(p), kT, p.cluster, s, &attr);
  return cudaLaunchKernelEx(&cfg, single_support_kernel<kT, kRows, kSteps>, a, t, o, I, W,
                            p.chunk, p.cluster);
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
  const cudaLaunchConfig_t cfg =
      cluster_config(multi_grid(p), p.threads, p.cluster, static_cast<cudaStream_t>(stream), &attr);
  err = p.threads == kWide ? launch_multi<kWide>(cfg, items, tids, out, K, I, W, p.chunk)
                           : launch_multi<kNarrow>(cfg, items, tids, out, K, I, W, p.chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What multi_extension_supports launches for these shapes, into facts[11]
// (cluster_facts in occupancy.cuh).
int multi_extension_supports_facts(int K, int I, int W, int sms, int* facts) {
  MultiPlan p;
  cudaError_t err = plan_multi(K, I, W, sms, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cluster_facts(multi_kernel(p.threads), multi_grid(p), p.threads,
                                        p.cluster, p.chunk, facts));
}

// items uint32[I, W], tid uint32[W] -> out int32[I].
int extension_supports(const void* items, const void* tid, void* out, int I, int W,
                       void* stream) {
  if (I <= 0) return static_cast<int>(cudaSuccess);
  SinglePlan p;
  cudaError_t err = plan_single(I, W, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.rows == 1)
    err = launch_single<kRowThreads, 1, kUnroll>(p, items, tid, out, I, W, s);
  else if (p.rows == kLongRows)
    err = launch_single<kRowThreads, kLongRows, kUnroll>(p, items, tid, out, I, W, s);
  else
    err = launch_single<kShortThreads, kShortRows, kShortUnroll>(p, items, tid, out, I, W, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What extension_supports launches for these shapes (I positive), into
// facts[11] (cluster_facts in occupancy.cuh), without launching.
int extension_supports_facts(int I, int W, int* facts) {
  if (I <= 0) return static_cast<int>(cudaErrorInvalidValue);
  SinglePlan p;
  cudaError_t err = plan_single(I, W, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cluster_facts(single_kernel(p.rows), single_grid(p), p.threads,
                                        p.cluster, p.chunk, facts));
}

}  // extern "C"
