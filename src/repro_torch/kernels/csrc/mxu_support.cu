// Multi-prefix support sweep on the tensor cores for Hopper (sm_90a): B2.
//
//   S[k, i] = sum_w popc(items[i, w] & tids[k, w])    int32[K, I]
//
// Replaces the TPU kernel repro/kernels/multi_support.py::
// multi_extension_supports_mxu_pallas (_mxu_kernel, pl.pallas_call at line
// 146), which unpacks both operands to 0/1 bf16 and takes their dot product
// on the MXU with f32 accumulation, exact below 2^24.  Here the product is
// the tensor cores' 1-bit MMA with int32 accumulation (bmma.cuh): the dot
// product of two 0/1 vectors is the population count of their AND, which the
// MMA takes on the packed bits themselves, with no unpack.  Exact at any size
// the int32 output holds.
//
//   A (16 x 256 bits, row-major)  16 prefixes, 8 packed words each;
//   B (256 x 8 bits, col-major)   8 items, the same 8 words: column n of B
//                                 is simply the row-major items[i0 + n, w];
//   C (16 x 8, int32)             the counts, in registers across the W loop.
//
// A and B see the words' bits in the same order, so the count does not
// depend on it.
//
// The int8 MMA m16n8k32 on bytes of 0/1 is exact too, but its unpack in
// registers (about 12 integer instructions a thread for each MMA) held it
// at 2.8 times this form's time at K=64 (PERF.md); this form needs none.
//
// The bound on an H100 SXM: the larger of the packed bytes, (I + K) * W * 4
// read and K * I * 4 written, over 3.35 TB/s, and the K * I * W / 1024 MMAs
// (m16n8k256) at the 1-bit MMA's issue rate, which the data sheet does not
// give and chip_smoke.py measures (probes/bmma_rate.cu: 0.57 an SM a clock,
// 1.27e11 a second).  At the cluster path's K=64, I=100, W=15625 that is
// 3.07 us of bytes against 0.77 us of MMAs; at K=16, 2.17 us of bytes
// against 0.19 us.  The design keeps the packed words as the only
// traffic to memory: a block stages a 16-prefix x 32-word and a 32-item x
// 32-word tile in shared memory, each of its four warps takes one 8-word
// step of the 32 and reuses one A fragment for four item tiles.  Each thread
// loads its share of the next stage into registers while the warps compute
// on this one.  W is split over blocks to fill the SMs, and partial counts
// are added with integer atomics, exact in any order (as B1 does in
// support.cu).  K pads to 16, I to 32 and W to the 8-word step as zeros in
// shared memory, never stored.
#include <cstdint>
#include <cuda_runtime.h>

#include "bmma.cuh"
#include "occupancy.cuh"

namespace {

constexpr int kThreads = 128;             // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 16;                // prefixes per block: one MMA's M
constexpr int kNTiles = 4;                // item tiles of 8 per block
constexpr int kTileI = 8 * kNTiles;       // items per block
constexpr int kStageWords = 32;           // words staged per row and step
constexpr int kWordsPerWarp = kStageWords / kWarps;  // one k=256 step
constexpr int kStride = kStageWords + 4;  // padded row: no bank conflicts
// Rows a thread stages per step: lane x of warp v loads word x of rows
// v, v + 4, v + 8, ... (prefixes first, then items), coalesced.
constexpr int kRowsPerThread = (kTileK + kTileI) / kWarps;
constexpr int kMinChunk = 4 * kStageWords;
constexpr int kBlocksPerSm = 4;

// grid = (W chunks of whole stages, prefix tiles of 16, item tiles of 32);
// block = 4 warps.
__global__ void __launch_bounds__(kThreads)
mxu_support_kernel(const uint32_t* __restrict__ items,
                   const uint32_t* __restrict__ tids,
                   int32_t* __restrict__ out, int K, int I, int W, int chunk) {
  __shared__ uint32_t s_tid[kTileK][kStride];
  __shared__ uint32_t s_item[kTileI][kStride];
  __shared__ int s_sum[kTileK][kTileI];

  const int k0 = blockIdx.y * kTileK;
  const int i0 = blockIdx.z * kTileI;
  const int w_begin = blockIdx.x * chunk;
  const int w_end = min(W, w_begin + chunk);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;         // the fragment's groupID
  const int t = lane & 3;          // and threadID_in_group

  for (int e = threadIdx.x; e < kTileK * kTileI; e += kThreads) (&s_sum[0][0])[e] = 0;

  // Ragged edges: rows past K or I and words past the chunk stage as zero.
  uint32_t next[kRowsPerThread];
  auto load = [&](int w0) {
    const int w = w0 + lane;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = warp + kWarps * j;
      uint32_t v = 0u;
      if (w < w_end) {
        if (r < kTileK) {
          if (k0 + r < K) v = __ldg(tids + static_cast<size_t>(k0 + r) * W + w);
        } else if (i0 + r - kTileK < I) {
          v = __ldg(items + static_cast<size_t>(i0 + r - kTileK) * W + w);
        }
      }
      next[j] = v;
    }
  };

  int acc[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0;

  load(w_begin);
  for (int w0 = w_begin; w0 < w_end; w0 += kStageWords) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = warp + kWarps * j;
      if (r < kTileK) s_tid[r][lane] = next[j];
      else s_item[r - kTileK][lane] = next[j];
    }
    __syncthreads();
    if (w0 + kStageWords < w_end) load(w0 + kStageWords);  // in flight meanwhile

    const int c = warp * kWordsPerWarp + t;   // word t of the warp's step
    const uint32_t a0 = s_tid[g][c], a1 = s_tid[g + 8][c];
    const uint32_t a2 = s_tid[g][c + 4], a3 = s_tid[g + 8][c + 4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      mma_b1(acc[j], a0, a1, a2, a3, s_item[8 * j + g][c], s_item[8 * j + g][c + 4]);
    __syncthreads();
  }

  // C: c0 (row g, col 2t), c1 (row g, col 2t+1), c2 and c3 the same at row
  // g+8.  The four warps' counts meet in shared memory, then one atomic per
  // output and block adds the chunk's count.
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int col = 8 * j + 2 * t;
    atomicAdd(&s_sum[g][col], acc[j][0]);
    atomicAdd(&s_sum[g][col + 1], acc[j][1]);
    atomicAdd(&s_sum[g + 8][col], acc[j][2]);
    atomicAdd(&s_sum[g + 8][col + 1], acc[j][3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTileK * kTileI; e += kThreads) {
    const int k = k0 + e / kTileI;
    const int i = i0 + e % kTileI;
    if (k < K && i < I) atomicAdd(out + static_cast<size_t>(k) * I + i, (&s_sum[0][0])[e]);
  }
}

// How B2 is launched for these shapes (K, I and W positive): grid (W chunks
// of whole stages, prefix tiles of 16, item tiles of 32) and the chunk's
// words.  W is split into about kBlocksPerSm blocks an SM over the tiles.
struct MxuGrid {
  dim3 grid;
  int chunk;
};

MxuGrid mxu_grid(int K, int I, int W, int sms) {
  const int k_tiles = (K + kTileK - 1) / kTileK;
  const int i_tiles = (I + kTileI - 1) / kTileI;
  const int tiles = k_tiles * i_tiles;
  const int want = (kBlocksPerSm * max(sms, 1) + tiles - 1) / tiles;
  const int most = (W + kMinChunk - 1) / kMinChunk;
  const int splits = max(1, min(want, most));
  // whole stages per chunk; every chunk then holds at least one word
  const int stages = ((W + splits - 1) / splits + kStageWords - 1) / kStageWords;
  const int chunk = stages * kStageWords;
  return {dim3((W + chunk - 1) / chunk, k_tiles, i_tiles), chunk};
}

}  // namespace

extern "C" {

// items uint32[I, W], tids uint32[K, W] -> out int32[K, I] (row-major,
// contiguous), launched on `stream`; returns cudaGetLastError().  `sms` is the
// card's SM count, which the caller looks up once.
int multi_extension_supports_mxu(const void* items, const void* tids, void* out,
                                 int K, int I, int W, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed =
      cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(K) * I, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  if (K > 0 && I > 0 && W > 0) {
    const MxuGrid g = mxu_grid(K, I, W, sms);
    mxu_support_kernel<<<g.grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(items), static_cast<const uint32_t*>(tids),
        static_cast<int32_t*>(out), K, I, W, g.chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// What multi_extension_supports_mxu launches for these shapes (K, I and W
// positive), into facts[10] (grid_facts in occupancy.cuh), without launching.
int multi_extension_supports_mxu_facts(int K, int I, int W, int sms, int* facts) {
  if (K <= 0 || I <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const MxuGrid g = mxu_grid(K, I, W, sms);
  return static_cast<int>(grid_facts(reinterpret_cast<const void*>(mxu_support_kernel), g.grid,
                                     kThreads, g.chunk, 0, sms, facts));
}

}  // extern "C"
