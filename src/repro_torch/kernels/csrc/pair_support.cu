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
// ti <= tj, one per blockIdx.x, and a block of an off-diagonal pair adds each
// count to S[i, j] and to S[j, i].  A diagonal pair computes its whole square
// tile and stores each count once.  W is split over blockIdx.y to fill the
// SMs, and the chunks' partial counts are added with integer atomics into the
// zeroed output, exact in any order.  valid_tid masks the words before they
// are counted; rows past I and words past W read as zero and are never stored.
//
// The bound on an H100 SXM at the profiled demo's I=100, W=15625, counting
// the I(I+1)/2 distinct pairs: B6 needs 78.9 M POPC, at 16 per clock per SM
// on 132 SMs at 1.98 GHz 18.9 us, against 6.35 MB of bytes (1.9 us at 3.35
// TB/s); B7 5050 * 15625 / 1024 MMAs (m16n8k256), 0.61 us at the 1-bit
// MMA's issue rate that chip_smoke.py measures (the data sheet gives none),
// so the bytes set B7's bound.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "bmma.cuh"
#include "occupancy.cuh"

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

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// --- B6: integer pipes --------------------------------------------------
// B1's register tiling (support.cu) with both operands the masked items: each
// thread keeps kTile x kTile counters, so a loaded word of one row serves
// kTile popcounts.  The valid mask is ANDed into the row-i words only:
// popc((a & v) & (b & v)) = popc((a & v) & b).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;
constexpr int kMinChunk = 4 * kThreads;
constexpr int kBlocksPerSm = 2;

// grid = (tile pairs, W chunks); block = kThreads threads striding the chunk
// with coalesced 32-bit loads.
__global__ void __launch_bounds__(kThreads)
pair_support_kernel(const uint32_t* __restrict__ items,
                    const uint32_t* __restrict__ valid,
                    int32_t* __restrict__ out, int I, int W, int chunk) {
  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int w_begin = blockIdx.y * chunk;
  const int w_end = min(W, w_begin + chunk);

  const uint32_t* a_row[kTile];
  const uint32_t* b_row[kTile];
  bool a_ok[kTile], b_ok[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    a_ok[r] = i0 + r < I;
    b_ok[r] = j0 + r < I;
    a_row[r] = items + static_cast<size_t>(a_ok[r] ? i0 + r : 0) * W;
    b_row[r] = items + static_cast<size_t>(b_ok[r] ? j0 + r : 0) * W;
  }

  int acc[kTile][kTile];
#pragma unroll
  for (int ii = 0; ii < kTile; ++ii)
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) acc[ii][jj] = 0;

  for (int w = w_begin + threadIdx.x; w < w_end; w += kThreads) {
    const uint32_t v = __ldg(valid + w);
    uint32_t a[kTile];
#pragma unroll
    for (int ii = 0; ii < kTile; ++ii) a[ii] = a_ok[ii] ? __ldg(a_row[ii] + w) & v : 0u;
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const uint32_t b = b_ok[jj] ? __ldg(b_row[jj] + w) : 0u;
#pragma unroll
      for (int ii = 0; ii < kTile; ++ii) acc[ii][jj] += __popc(a[ii] & b);
    }
  }

  // Block reduction: warp shuffles, one partial per warp in shared memory,
  // then one atomic add per output (two off the diagonal) and block.
  __shared__ int partial[kWarps][kTile * kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int ii = 0; ii < kTile; ++ii)
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const int v = warp_sum(acc[ii][jj]);
      if (lane == 0) partial[warp][ii * kTile + jj] = v;
    }
  __syncthreads();
  if (threadIdx.x < kTile * kTile) {
    const int i = i0 + threadIdx.x / kTile;
    const int j = j0 + threadIdx.x % kTile;
    if (i < I && j < I) {
      int s = 0;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) s += partial[wp][threadIdx.x];
      atomicAdd(out + static_cast<size_t>(i) * I + j, s);
      if (ti != tj) atomicAdd(out + static_cast<size_t>(j) * I + i, s);
    }
  }
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
int pair_supports(const void* items, const void* valid, void* out, int I, int W, int sms,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed =
      cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(I) * I, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (I > 0 && W > 0) {
    const long long tiles = (I + kTile - 1) / kTile;
    const long long pairs = tiles * (tiles + 1) / 2;
    const int want = static_cast<int>((kBlocksPerSm * max(sms, 1) + pairs - 1) / pairs);
    const int most = (W + kMinChunk - 1) / kMinChunk;
    const int splits = max(1, min(want, most));
    const int chunk = (W + splits - 1) / splits;
    const dim3 grid(static_cast<unsigned>(pairs), (W + chunk - 1) / chunk);
    pair_support_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(items), static_cast<const uint32_t*>(valid),
        static_cast<int32_t*>(out), I, W, chunk);
  }
  return static_cast<int>(cudaGetLastError());
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
