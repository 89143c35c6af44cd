// Block containment sweep of the streaming miner for Hopper (sm_90a).
//
//   B5  block_itemset_supports:
//       counts[s, f] = sum_t [ sum_w popc(fi[f, w] & ~tx[s, t, w]) == 0 ]
//
// how many of the T rows of each of S transaction blocks contain each of F
// itemsets.  Words are the port's packed masks (bit i % 32 of word i / 32),
// read as uint32.  Outputs are exact int32 counts.  The entry point has a
// plain C interface for ctypes: it launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so a refused launch is reported.
//
// f is contained in a row t iff no word of f has a bit the row lacks, so the
// zero test needs no population count: OR the words (f & ~t) over all IW
// words, one LOP3 each, and test the OR against zero once the row's words are
// all in.  A thread keeps kSetsPerThread itemsets' first kRegWords words in
// registers (the words past them, for masks over more than 256 items, are read
// from the L1-cached itemset rows).  The block stages kRowTile rows at a time
// in shared memory, each row padded with zero words to a multiple of four so
// it is read as 16-byte vectors; every thread reads the same row at once (a
// broadcast), and one loaded row serves kSetsPerThread itemsets.  The TPU
// kernel walks T as its sequential minor grid axis; here T is split into
// chunks over blocks to fill the SMs, and each block adds its per-itemset
// counts with one integer atomic per itemset, exact in any order.  Rows are
// bounded by T, so the empty itemset counts every real row and no sentinel
// word is needed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSetsPerThread = 4;
constexpr int kRegWords = 8;  // a multiple of 4
constexpr int kMaxRowTile = 64;
constexpr int kStageWords = 8192;  // at most 32 KB of staged rows per block
constexpr int kBlocksPerSm = 4;

__global__ void __launch_bounds__(kThreads)
block_support_kernel(const uint32_t* __restrict__ tx, const uint32_t* __restrict__ fi,
                     int32_t* __restrict__ out, int T, int F, int IW, int IWp,
                     int row_tile, int chunk) {
  extern __shared__ uint4 s_rows[];  // [row_tile][IWp / 4]
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_rows);
  const int s = blockIdx.z;
  const int t_begin = blockIdx.y * chunk;
  const int t_end = min(T, t_begin + chunk);
  const uint32_t* block = tx + static_cast<size_t>(s) * T * IW;
  const int vecs = IWp / 4;

  uint32_t words[kSetsPerThread][kRegWords];
  const uint32_t* set_row[kSetsPerThread];
  int f_of[kSetsPerThread];
#pragma unroll
  for (int j = 0; j < kSetsPerThread; ++j) {
    f_of[j] = (blockIdx.x * kSetsPerThread + j) * kThreads + threadIdx.x;
    set_row[j] = fi + static_cast<size_t>(f_of[j] < F ? f_of[j] : 0) * IW;
#pragma unroll
    for (int w = 0; w < kRegWords; ++w)
      words[j][w] = (f_of[j] < F && w < IW) ? __ldg(set_row[j] + w) : 0u;
  }

  int count[kSetsPerThread];
#pragma unroll
  for (int j = 0; j < kSetsPerThread; ++j) count[j] = 0;

  for (int t0 = t_begin; t0 < t_end; t0 += row_tile) {
    const int rows = min(row_tile, t_end - t0);
    // Zero pad words read as ~0 = all ones, and the itemset's words there are
    // zero, so the padding adds no bit to the OR.
    for (int i = threadIdx.x; i < rows * IWp; i += kThreads) {
      const int r = i / IWp;
      const int w = i % IWp;
      s_words[i] = w < IW ? __ldg(block + static_cast<size_t>(t0 + r) * IW + w) : 0u;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      uint32_t acc[kSetsPerThread];
#pragma unroll
      for (int j = 0; j < kSetsPerThread; ++j) acc[j] = 0u;
#pragma unroll
      for (int v = 0; v < kRegWords / 4; ++v) {
        if (v < vecs) {
          const uint4 x = s_rows[r * vecs + v];
#pragma unroll
          for (int j = 0; j < kSetsPerThread; ++j)
            acc[j] |= (words[j][4 * v] & ~x.x) | (words[j][4 * v + 1] & ~x.y) |
                      (words[j][4 * v + 2] & ~x.z) | (words[j][4 * v + 3] & ~x.w);
        }
      }
      for (int w = kRegWords; w < IW; ++w) {
        const uint32_t x = s_words[r * IWp + w];
#pragma unroll
        for (int j = 0; j < kSetsPerThread; ++j) acc[j] |= __ldg(set_row[j] + w) & ~x;
      }
#pragma unroll
      for (int j = 0; j < kSetsPerThread; ++j) count[j] += acc[j] == 0u;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kSetsPerThread; ++j)
    if (f_of[j] < F && count[j] > 0) atomicAdd(out + static_cast<size_t>(s) * F + f_of[j], count[j]);
}

}  // namespace

extern "C" {

// tx uint32[S, T, IW], fi uint32[F, IW] -> out int32[S, F] (row-major,
// contiguous).  `sms` is the card's SM count, which the caller looks up once,
// so a launch makes no device query.  The caller bounds IW by kStageWords so
// that one staged row fits.
int block_itemset_supports(const void* tx, const void* fi, void* out, int S, int T, int F,
                           int IW, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed =
      cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(S) * F, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (S > 0 && T > 0 && F > 0) {
    const int IWp = (IW + 3) / 4 * 4;
    const int row_tile = max(1, min(kMaxRowTile, kStageWords / max(IWp, 1)));
    const int f_tiles = (F + kThreads * kSetsPerThread - 1) / (kThreads * kSetsPerThread);
    const int want = (kBlocksPerSm * max(sms, 1) + f_tiles * S - 1) / (f_tiles * S);
    const int most = min((T + row_tile - 1) / row_tile, 65535);
    const int splits = max(1, min(want, most));
    const int chunk = (T + splits - 1) / splits;
    const dim3 grid(f_tiles, splits, S);
    const size_t smem = sizeof(uint32_t) * static_cast<size_t>(row_tile) * max(IWp, 4);
    block_support_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const uint32_t*>(tx), static_cast<const uint32_t*>(fi),
        static_cast<int32_t*>(out), T, F, IW, IWp, row_tile, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
