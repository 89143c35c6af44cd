// All-pairs support sweeps for Hopper (sm_90a): B6 and B7.
//
//   S[i, j] = sum_w popc(b[i, w] & b[j, w]),   b = items & valid   int32[I, I]
//
// B6 (pair_support_kernel) replaces the TPU kernel repro/kernels/
// pair_support.py::pair_supports_pallas (_vpu_kernel, pl.pallas_call at line
// 74); B7 (pair_support_mxu_kernel) replaces pair_supports_mxu_pallas
// (_mxu_kernel, pl.pallas_call at line 133), which unpacks the words to 0/1
// bf16 and takes their dot product on the MXU with f32 accumulation, exact
// below 2^24.  B7 takes the same dot product on the tensor cores' 1-bit MMA
// (bmma.cuh) with int32 accumulation, on the packed words: exact at any size
// the int32 output holds.
//
// Words are the port's packed bitmaps (bit t % 32 of word t / 32), read as
// uint32.  Each entry point has a plain C interface for ctypes: it launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// S is symmetric, so both kernels launch only the tile pairs (ti, tj) with
// ti <= tj, and a block of an off-diagonal pair writes each count to S[i, j]
// and to S[j, i].  A diagonal pair computes its whole square tile and writes
// each count once.  valid_tid masks the words before they are counted.
//
// B6 stores every output once, with no zeroing launch and no atomics: a tile
// pair's W is cut into chunks, one block each, and the blocks of one pair form
// a thread-block cluster (as B1's tiles do, support.cu) whose first block adds
// their counts through distributed shared memory; rows past I read row I - 1
// again and are never stored.  B7 splits W over the grid's y axis and adds the
// chunks' partial counts with integer atomics into the zeroed output, exact in
// any order; rows past I and words past W read as zero and are never stored.
//
// The bound on an H100 SXM at the profiled demo's I=100, W=15625, counting
// the I(I+1)/2 distinct pairs: B6 needs 78.9 M POPC, at 16 per clock per SM
// on 132 SMs at 1.98 GHz 18.9 us, against 6.35 MB of bytes (1.9 us at 3.35
// TB/s); B7 5050 * 15625 / 1024 MMAs (m16n8k256), 0.61 us at the 1-bit
// MMA's issue rate that chip_smoke.py measures (the data sheet gives none),
// so the bytes set B7's bound.  B6's 13 x 13 tiles of 8 rows do 5824 pairs'
// POPC a word for the 5050 it needs (rows past I, both halves of a diagonal
// tile), 21.8 us at that rate.
#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "bmma.cuh"
#include "occupancy.cuh"
#include "warp_sum.cuh"

namespace cg = cooperative_groups;

namespace {

// Tile pair number p of the upper triangle, counted column by column:
// p = tj (tj + 1) / 2 + ti with 0 <= ti <= tj.
__device__ __forceinline__ void tile_pair(long long p, int& ti, int& tj) {
  int j = static_cast<int>((sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0) * 0.5);
  while (static_cast<long long>(j) * (j + 1) / 2 > p) --j;
  while (static_cast<long long>(j + 1) * (j + 2) / 2 <= p) ++j;
  tj = j;
  ti = static_cast<int>(p - static_cast<long long>(j) * (j + 1) / 2);
}

// --- B6: integer pipes --------------------------------------------------
// B1's register tiling (support.cu) with both operands the masked items: each
// thread keeps kTile x kTile counters, so a loaded word of one row serves
// kTile popcounts.  The valid mask is ANDed into the row-i words only:
// popc((a & v) & (b & v)) = popc((a & v) & b).  The 64 counters are two sets
// of 32 for the warp's transposing sum.  Blocks are wide (128 threads) where W
// gives each thread 4 words, else narrow (64 threads; W = 64 on the repl_min
// path); both at most 128 registers a thread, so an SM holds 4 wide or 8
// narrow ones (three words a step, or 256-thread blocks, spilled or ran
// slower on the H100).  A pair's cluster has at most 8 blocks (the portable
// cluster size), each with a chunk of at least 4 words a thread.
constexpr int kTile = 8;
constexpr int kCounts = kTile * kTile;
constexpr int kPairWide = 128;
constexpr int kPairNarrow = 64;
constexpr int kPairMaxCluster = 8;
constexpr int kSteps = 2;

// grid = (tile pairs x cluster), clusters of (cluster, 1, 1): block `rank` of
// pair p's cluster sweeps words [rank * chunk, (rank + 1) * chunk) with
// coalesced 32-bit loads.
template <int kT>
__global__ void __launch_bounds__(kT, 4 * kPairWide / kT)
pair_support_kernel(const uint32_t* __restrict__ items,
                    const uint32_t* __restrict__ valid,
                    int32_t* __restrict__ out, int I, int W, int chunk, int cluster_size) {
  const long long pair = blockIdx.x / cluster_size;
  const int rank = static_cast<int>(blockIdx.x - pair * cluster_size);
  int ti, tj;
  tile_pair(pair, ti, tj);
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int w_begin = rank * chunk;
  const int w_end = min(W, w_begin + chunk);

  // Rows of a tile as word offsets from its first row (at most 7 W, which an
  // int holds): fewer registers than a pointer a row.
  const uint32_t* a_base = items + static_cast<size_t>(i0) * W;
  const uint32_t* b_base = items + static_cast<size_t>(j0) * W;
  int a_off[kTile], b_off[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    a_off[r] = min(r, I - 1 - i0) * W;
    b_off[r] = min(r, I - 1 - j0) * W;
  }

  // counter (ii, jj) is acc[ii / 4][(ii % 4) * kTile + jj]
  int acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[h][c] = 0;

  // kSteps words a thread per step: their 17 loads each are all in flight
  // at once, and a counter takes their popcounts in one three-input add.
  int w = w_begin + threadIdx.x;
  for (; w + (kSteps - 1) * kT < w_end; w += kSteps * kT) {
    uint32_t a[kSteps][kTile];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const uint32_t v = __ldg(valid + w + u * kT);
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) a[u][ii] = __ldg(a_base + (a_off[ii] + w + u * kT)) & v;
    }
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      uint32_t b[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) b[u] = __ldg(b_base + (b_off[jj] + w + u * kT));
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) {
        int sum = 0;
#pragma unroll
        for (int u = 0; u < kSteps; ++u) sum += __popc(a[u][ii] & b[u]);
        acc[ii / 4][(ii % 4) * kTile + jj] += sum;
      }
    }
  }
#pragma unroll 1
  for (; w < w_end; w += kT) {
    const uint32_t v = __ldg(valid + w);
    uint32_t a[kTile];
#pragma unroll
    for (int ii = 0; ii < kTile; ++ii) a[ii] = __ldg(a_base + (a_off[ii] + w)) & v;
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const uint32_t b = __ldg(b_base + (b_off[jj] + w));
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) acc[ii / 4][(ii % 4) * kTile + jj] += __popc(a[ii] & b);
    }
  }

  // Warp, then block: lane l of each warp holds counters l and 32 + l, the
  // warps' sums meet in shared memory, and block_sum[c] is the block's count
  // of counter c.
  __shared__ int warp_sums[kT / 32][kCounts];
  __shared__ int block_sum[kCounts];
  const int lane = threadIdx.x & 31;
  warp_transpose_sum<16>(acc[0], lane);
  warp_transpose_sum<16>(acc[1], lane);
  warp_sums[threadIdx.x >> 5][lane] = acc[0][0];
  warp_sums[threadIdx.x >> 5][32 + lane] = acc[1][0];
  __syncthreads();
  int s = 0;
  if (threadIdx.x < kCounts) {
#pragma unroll
    for (int wp = 0; wp < kT / 32; ++wp) s += warp_sums[wp][threadIdx.x];
    block_sum[threadIdx.x] = s;
  }
  const int i = i0 + threadIdx.x / kTile;
  const int j = j0 + threadIdx.x % kTile;
  const bool store = threadIdx.x < kCounts && i < I && j < I;
  if (cluster_size == 1) {  // the block holds the whole count
    if (store) {
      out[static_cast<size_t>(i) * I + j] = s;
      if (ti != tj) out[static_cast<size_t>(j) * I + i] = s;
    }
    return;
  }
  // Cluster: the first block adds every block's counts from its shared
  // memory and stores each output once.  The second barrier keeps every block
  // (and its shared memory) alive until those reads are done.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0 && store) {
    s = 0;
    for (int r = 0; r < cluster_size; ++r)
      s += *cluster.map_shared_rank(&block_sum[threadIdx.x], r);
    out[static_cast<size_t>(i) * I + j] = s;
    if (ti != tj) out[static_cast<size_t>(j) * I + i] = s;
  }
  cluster.sync();
}

// How B6 is launched for one call: `pairs` clusters of `cluster` blocks.
struct PairPlan {
  long long pairs;
  int threads, cluster, chunk;
};

const void* pair_kernel(int threads) {
  return threads == kPairWide ? reinterpret_cast<const void*>(pair_support_kernel<kPairWide>)
                              : reinterpret_cast<const void*>(pair_support_kernel<kPairNarrow>);
}

dim3 pair_grid(const PairPlan& p) { return dim3(static_cast<unsigned>(p.pairs * p.cluster)); }

// Wide blocks where W gives each thread 4 words, else narrow ones; a cluster
// a tile pair, sized by pick_cluster (occupancy.cuh): one wave, the least work
// on the busiest SM.  With W = 0 every block stores zeros.
cudaError_t plan_pair(int I, int W, int sms, PairPlan* p) {
  const long long tiles = ceil_div(I, kTile);
  p->pairs = tiles * (tiles + 1) / 2;
  p->threads = W >= 4 * kPairWide ? kPairWide : kPairNarrow;
  const int most = max(1, min(kPairMaxCluster, W / (4 * p->threads)));
  const cudaError_t err =
      pick_cluster(pair_kernel(p->threads), p->threads, p->pairs, most, sms, &p->cluster);
  p->chunk = static_cast<int>(ceil_div(W, p->cluster));
  return err;
}

template <int kT>
cudaError_t launch_pair(const PairPlan& p, const void* items, const void* valid, void* out,
                        int I, int W, cudaStream_t s) {
  const uint32_t* a = static_cast<const uint32_t*>(items);
  const uint32_t* v = static_cast<const uint32_t*>(valid);
  int32_t* o = static_cast<int32_t*>(out);
  if (p.cluster == 1) {
    pair_support_kernel<kT><<<pair_grid(p), kT, 0, s>>>(a, v, o, I, W, p.chunk, 1);
    return cudaSuccess;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(pair_grid(p), kT, p.cluster, s, &attr);
  return cudaLaunchKernelEx(&cfg, pair_support_kernel<kT>, a, v, o, I, W, p.chunk, p.cluster);
}

// --- B7: tensor cores ---------------------------------------------------
// B2's staging (mxu_support.cu) with both operands the masked items: a block
// owns a 32 x 32 tile pair, stages its 64 rows x 32 words in shared memory
// (valid ANDed in as the stage is stored), and each of its four warps takes
// one 8-word (256-bit) step of the 32, with two 16-row A fragments against
// four 8-column B fragments: eight MMAs a step.  Each thread loads its share of
// the next stage into registers while the warps compute on this one.  With
// so little arithmetic a stage, the time is the loads' latency: they must
// not wait on one another, and enough blocks must be resident to cover it.
constexpr int kMxuThreads = 128;          // four warps
constexpr int kMxuWarps = kMxuThreads / 32;
constexpr int kSide = 32;                 // items per side of a tile pair
constexpr int kMTiles = kSide / 16;       // A fragments of 16 rows
constexpr int kNTiles = kSide / 8;        // B fragments of 8 columns
constexpr int kStageWords = 32;           // words staged per row and step
constexpr int kWordsPerWarp = kStageWords / kMxuWarps;  // one k=256 step
constexpr int kStride = kStageWords + 4;  // padded row: no bank conflicts
// Rows a thread stages per step: lane x of warp v loads word x of rows
// v, v + 4, v + 8, ... (the 32 rows of i first, then the 32 of j), coalesced.
constexpr int kRowsPerThread = 2 * kSide / kMxuWarps;
constexpr int kMxuMinChunk = 4 * kStageWords;
constexpr int kMxuBlocksPerSm = 4;

// grid = (tile pairs, W chunks of whole stages); block = 4 warps, and
// kMxuBlocksPerSm of them resident on an SM (registers capped at 128 a thread).
__global__ void __launch_bounds__(kMxuThreads, kMxuBlocksPerSm)
pair_support_mxu_kernel(const uint32_t* __restrict__ items,
                        const uint32_t* __restrict__ valid,
                        int32_t* __restrict__ out, int I, int W, int chunk) {
  __shared__ uint32_t s_a[kSide][kStride];
  __shared__ uint32_t s_b[kSide][kStride];
  __shared__ int s_sum[kSide][kSide];

  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int i0 = ti * kSide;
  const int j0 = tj * kSide;
  const int w_begin = blockIdx.y * chunk;
  const int w_end = min(W, w_begin + chunk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;         // the fragment's groupID
  const int t = lane & 3;          // and threadID_in_group

  for (int e = threadIdx.x; e < kSide * kSide; e += kMxuThreads) (&s_sum[0][0])[e] = 0;

  // The row loads do not wait for the valid word: all 17 are in flight at
  // once, and the mask is applied when the stage is stored.
  uint32_t next[kRowsPerThread];
  uint32_t next_valid;
  auto load = [&](int w0) {
    const int w = w0 + lane;
    const bool in_chunk = w < w_end;
    next_valid = in_chunk ? __ldg(valid + w) : 0u;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = warp + kMxuWarps * j;
      const int row = r < kSide ? i0 + r : j0 + r - kSide;
      next[j] = (in_chunk && row < I) ? __ldg(items + static_cast<size_t>(row) * W + w) : 0u;
    }
  };

  int acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0;

  load(w_begin);
  for (int w0 = w_begin; w0 < w_end; w0 += kStageWords) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = warp + kMxuWarps * j;
      if (r < kSide) s_a[r][lane] = next[j] & next_valid;
      else s_b[r - kSide][lane] = next[j] & next_valid;
    }
    __syncthreads();
    if (w0 + kStageWords < w_end) load(w0 + kStageWords);  // in flight meanwhile

    const int c = warp * kWordsPerWarp + t;   // word t of the warp's step
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
      const int r = 16 * m + g;
      const uint32_t a0 = s_a[r][c], a1 = s_a[r + 8][c];
      const uint32_t a2 = s_a[r][c + 4], a3 = s_a[r + 8][c + 4];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
        mma_b1(acc[m][n], a0, a1, a2, a3, s_b[8 * n + g][c], s_b[8 * n + g][c + 4]);
    }
    __syncthreads();
  }

  // The four warps' counts meet in shared memory, then one atomic per output
  // (two off the diagonal) and block adds the chunk's count.
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      const int row = 16 * m + g;
      const int col = 8 * n + 2 * t;
      atomicAdd(&s_sum[row][col], acc[m][n][0]);
      atomicAdd(&s_sum[row][col + 1], acc[m][n][1]);
      atomicAdd(&s_sum[row + 8][col], acc[m][n][2]);
      atomicAdd(&s_sum[row + 8][col + 1], acc[m][n][3]);
    }
  __syncthreads();
  for (int e = threadIdx.x; e < kSide * kSide; e += kMxuThreads) {
    const int i = i0 + e / kSide;
    const int j = j0 + e % kSide;
    if (i < I && j < I) {
      const int s = (&s_sum[0][0])[e];
      atomicAdd(out + static_cast<size_t>(i) * I + j, s);
      if (ti != tj) atomicAdd(out + static_cast<size_t>(j) * I + i, s);
    }
  }
}

// How B7 is launched for these shapes (I and W positive): grid (tile pairs,
// W chunks of whole stages) and the chunk's words.  W is split into about
// kMxuBlocksPerSm blocks an SM over the tile pairs.
struct MxuGrid {
  dim3 grid;
  int chunk;
};

MxuGrid mxu_grid(int I, int W, int sms) {
  const long long tiles = (I + kSide - 1) / kSide;
  const long long pairs = tiles * (tiles + 1) / 2;
  const int want = static_cast<int>((kMxuBlocksPerSm * max(sms, 1) + pairs - 1) / pairs);
  const int most = (W + kMxuMinChunk - 1) / kMxuMinChunk;
  const int splits = max(1, min(want, most));
  // whole stages per chunk; every chunk then holds at least one word
  const int stages = ((W + splits - 1) / splits + kStageWords - 1) / kStageWords;
  const int chunk = stages * kStageWords;
  return {dim3(static_cast<unsigned>(pairs), (W + chunk - 1) / chunk), chunk};
}

}  // namespace

extern "C" {

// items uint32[I, W], valid uint32[W] -> out int32[I, I] (row-major,
// contiguous).  `sms` is the card's SM count, which the caller looks up once.
// One launch, which stores every output once.
int pair_supports(const void* items, const void* valid, void* out, int I, int W, int sms,
                  void* stream) {
  if (I <= 0) return static_cast<int>(cudaSuccess);
  PairPlan p;
  cudaError_t err = plan_pair(I, W, sms, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = p.threads == kPairWide ? launch_pair<kPairWide>(p, items, valid, out, I, W, s)
                               : launch_pair<kPairNarrow>(p, items, valid, out, I, W, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What pair_supports launches for these shapes (I positive), into facts[11]
// (cluster_facts in occupancy.cuh), without launching.
int pair_supports_facts(int I, int W, int sms, int* facts) {
  if (I <= 0) return static_cast<int>(cudaErrorInvalidValue);
  PairPlan p;
  cudaError_t err = plan_pair(I, W, sms, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cluster_facts(pair_kernel(p.threads), pair_grid(p), p.threads,
                                        p.cluster, p.chunk, facts));
}

// The same on the tensor cores (B7).
int pair_supports_mxu(const void* items, const void* valid, void* out, int I, int W, int sms,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed =
      cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(I) * I, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (I > 0 && W > 0) {
    const MxuGrid g = mxu_grid(I, W, sms);
    pair_support_mxu_kernel<<<g.grid, kMxuThreads, 0, s>>>(
        static_cast<const uint32_t*>(items), static_cast<const uint32_t*>(valid),
        static_cast<int32_t*>(out), I, W, g.chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// What pair_supports_mxu launches for these shapes (I and W positive), into
// facts[10] (grid_facts in occupancy.cuh), without launching.
int pair_supports_mxu_facts(int I, int W, int sms, int* facts) {
  if (I <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const MxuGrid g = mxu_grid(I, W, sms);
  return static_cast<int>(grid_facts(reinterpret_cast<const void*>(pair_support_mxu_kernel),
                                     g.grid, kMxuThreads, g.chunk, 0, sms, facts));
}

}  // extern "C"
