// Block containment sweep of the streaming miner for Hopper (sm_90a).
//
//   B5  block_itemset_supports:
//       counts[s, f] = sum_t [ sum_w popc(fi[f, w] & ~tx[s, t, w]) == 0 ]
//
// how many of the T rows of each of S transaction blocks contain each of F
// itemsets; it replaces the TPU kernel
// repro/kernels/delta_support.py::block_itemset_supports_pallas.  Words are the port's packed masks (bit i % 32 of word i / 32),
// read as uint32.  Outputs are exact int32 counts.  The entry point has a
// plain C interface for ctypes: it launches on the caller's stream, allocates
// nothing, and returns the launch's error so a refused launch is reported.
//
// f is contained in a row t iff no word of f has a bit the row lacks, so the
// zero test needs no population count: OR the words (f & ~t) over the IW
// words, one LOP3 each, and test the OR against zero once the row's words are
// all in.  The kernel is bound by that logic, so everything else is cut to
// what the LOP3s need:
//
// - The word count is a template parameter: rows of at most 4 words (every
//   mask over at most 128 items, the thesis database's 100 among them) are
//   compared in straight-line code, with no test of the width; wider masks
//   take a general loop.
// - A thread holds 32 itemset words in registers: 8 itemsets of up to 4
//   words.  One row read from shared memory (a 16-byte broadcast, the same
//   address for every thread) serves all of them, and the zero test folds
//   into the last LOP3 with a predicated add.  The general form takes 4
//   itemsets' words 8 at a time, reloaded for each tile of 32 rows, and
//   keeps one bit per row and itemset for a row that lacks a word.
// - Rows are staged with cp.async into two shared buffers: the next tile of
//   rows lands while the current one is compared.
// - The grid is whole waves: as many blocks as fit on the card at once (the
//   occupancy query times the SM count), each with the same number of rows
//   of the flattened (itemset tile, block, row) range, so no SM waits on a
//   partial second wave.  A block adds its count of each itemset with one
//   integer atomic at the end of each (itemset tile, block) segment it
//   covers, exact in any order.
//
// The TPU kernel walks T as its sequential minor grid axis.  Rows here are
// bounded by T, so the empty itemset counts every real row and no sentinel
// word is needed.
#include <cstdint>
#include <cuda_runtime.h>

#include "occupancy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRegWords = 32;      // itemset words a thread keeps in registers
constexpr int kMaxRowTile = 256;   // rows of one staged tile
constexpr int kStageWords = 4096;  // words of one of the two row buffers (16 KB)
constexpr int kMinRows = 64;       // rows a block takes at least
constexpr int kMaskRows = 32;      // rows of a tile in the general form: one mask bit each

// NW = 4: every row is read as 4 words (the words past IW are zero in shared
// memory, and zero in the itemset, so they add no bit to the OR).  NW = 0:
// any IW, rows padded to a multiple of 4 words.
template <int NW>
struct Form {
  static constexpr int kWords = NW ? NW : 8;          // itemset words in registers
  static constexpr int kSets = kRegWords / kWords;    // itemsets a thread
  static constexpr int kTile = kSets * kThreads;      // itemsets a block
};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// count += (miss == 0) as one predicated add: the test folds into the LOP3
// that forms `miss`, where C++'s form costs an add, a select and a move.
__device__ __forceinline__ void count_if_zero(int& count, uint32_t miss) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %1, 0;\n\t@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(count)
      : "r"(miss));
}

// Starts the copy of `rows` rows of IW words from `src` into `dst`, as rows
// of IWp words whose pad words are zero-filled.  vec16: IW == IWp and `src`
// is 16-byte aligned, so the tile is one run of 16-byte vectors.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src, int rows, int IW,
                                      int IWp, bool vec16) {
  if (vec16) {
    const int vecs = rows * IWp / 4;
    for (int v = threadIdx.x; v < vecs; v += kThreads) cp_async16(dst + 4 * v, src + 4 * v);
  } else {
    const int slots = rows * IWp;
    for (int i = threadIdx.x; i < slots; i += kThreads) {
      const int r = i / IWp;
      const int w = i - r * IWp;
      const bool real = w < IW;
      cp_async4(dst + i, src + (real ? r * IW + w : 0), real ? 4 : 0);
    }
  }
  cp_async_commit();
}

// Adds to count[j] the rows of `tile` (n rows of IWp words) that contain
// itemset j of this thread.
template <int NW>
__device__ __forceinline__ void compare(const uint32_t* tile, int n, int IW, int IWp,
                                        uint32_t (&words)[Form<NW>::kSets][Form<NW>::kWords],
                                        const uint32_t* (&set_row)[Form<NW>::kSets],
                                        int (&count)[Form<NW>::kSets]) {
  constexpr int J = Form<NW>::kSets;
  const uint4* rows = reinterpret_cast<const uint4*>(tile);
  if constexpr (NW == 4) {
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const uint4 x = rows[r];
#pragma unroll
      for (int j = 0; j < J; ++j)
        count_if_zero(count[j], (words[j][0] & ~x.x) | (words[j][1] & ~x.y) |
                                    (words[j][2] & ~x.z) | (words[j][3] & ~x.w));
    }
  } else {
    // Any width, words in chunks of 8: the chunk's words of the J itemsets
    // are loaded into registers once per tile and chunk, and bit r of
    // miss[j] records that row r (n <= 32) lacks a word of itemset j.
    uint32_t miss[J];
#pragma unroll
    for (int j = 0; j < J; ++j) miss[j] = 0u;
    for (int c = 0; c < IWp; c += 8) {
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int w = 0; w < 8; ++w) words[j][w] = c + w < IW ? __ldg(set_row[j] + c + w) : 0u;
      const uint4* chunk = rows + c / 4;
      if (c + 4 < IWp) {
        for (int r = 0; r < n; ++r) {
          const uint4 x = chunk[r * (IWp / 4)];
          const uint4 y = chunk[r * (IWp / 4) + 1];
#pragma unroll
          for (int j = 0; j < J; ++j)
            if ((words[j][0] & ~x.x) | (words[j][1] & ~x.y) | (words[j][2] & ~x.z) |
                (words[j][3] & ~x.w) | (words[j][4] & ~y.x) | (words[j][5] & ~y.y) |
                (words[j][6] & ~y.z) | (words[j][7] & ~y.w))
              miss[j] |= 1u << r;
        }
      } else {  // the last 4 words
        for (int r = 0; r < n; ++r) {
          const uint4 x = chunk[r * (IWp / 4)];
#pragma unroll
          for (int j = 0; j < J; ++j)
            if ((words[j][0] & ~x.x) | (words[j][1] & ~x.y) | (words[j][2] & ~x.z) |
                (words[j][3] & ~x.w))
              miss[j] |= 1u << r;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) count[j] += n - __popc(miss[j]);
  }
}

// grid = whole waves of blocks over the flattened (itemset tile, block s,
// row t) range, `per_block` rows each; dynamic shared memory holds two row
// buffers of row_tile rows of IWp words.
template <int NW>
__global__ void __launch_bounds__(kThreads)
block_support_kernel(const uint32_t* __restrict__ tx, const uint32_t* __restrict__ fi,
                     int32_t* __restrict__ out, int S, int T, int F, int IW, int IWp,
                     int row_tile, long long per_block, bool vec16) {
  using Fm = Form<NW>;
  constexpr int J = Fm::kSets;
  extern __shared__ uint4 s_rows[];
  uint32_t* const buf = reinterpret_cast<uint32_t*>(s_rows);  // two tiles of row_tile rows
  const int buf_words = row_tile * IWp;
  const long long f_tiles = (F + Fm::kTile - 1) / Fm::kTile;
  const long long total = f_tiles * S * T;
  long long idx = blockIdx.x * per_block;
  const long long end = min(total, idx + per_block);

  uint32_t words[J][Fm::kWords];
  const uint32_t* set_row[J];
  int count[J];
  long long loaded = -1;
  while (idx < end) {
    const long long seg = idx / T;  // (itemset tile, block) of row idx
    const int t0 = static_cast<int>(idx - seg * T);
    const int n_rows = static_cast<int>(min(static_cast<long long>(T - t0), end - idx));
    const int f_tile = static_cast<int>(seg / S);
    const int s = static_cast<int>(seg - static_cast<long long>(f_tile) * S);
    if (f_tile != loaded) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int f = f_tile * Fm::kTile + j * kThreads + threadIdx.x;
        set_row[j] = fi + static_cast<size_t>(f < F ? f : 0) * IW;
        if constexpr (NW != 0) {
#pragma unroll
          for (int w = 0; w < NW; ++w)
            words[j][w] = (f < F && w < IW) ? __ldg(set_row[j] + w) : 0u;
        }
      }
      loaded = f_tile;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) count[j] = 0;

    const uint32_t* rows = tx + (static_cast<size_t>(s) * T + t0) * IW;
    const int tiles = (n_rows + row_tile - 1) / row_tile;
    stage(buf, rows, min(row_tile, n_rows), IW, IWp, vec16);
    for (int k = 0; k < tiles; ++k) {
      const int n = min(row_tile, n_rows - k * row_tile);
      if (k + 1 < tiles) {
        const int next = (k + 1) * row_tile;
        stage(buf + ((k + 1) & 1) * buf_words, rows + static_cast<size_t>(next) * IW,
              min(row_tile, n_rows - next), IW, IWp, vec16);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      compare<NW>(buf + (k & 1) * buf_words, n, IW, IWp, words, set_row, count);
      __syncthreads();  // the buffer is free for the tile after next
    }

#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = f_tile * Fm::kTile + j * kThreads + threadIdx.x;
      if (f < F && count[j] > 0) atomicAdd(out + static_cast<size_t>(s) * F + f, count[j]);
    }
    idx += n_rows;
  }
}

// How B5 is launched for one call.
struct BlockPlan {
  int form;  // NW: 4 or 0
  int IWp, row_tile, blocks_per_sm, blocks;
  long long per_block;
  size_t smem;
  bool vec16;
  const void* kernel;
};

// The form for IW words, its staging, and whole waves of blocks over the
// flattened row range.
cudaError_t plan_block(const void* tx, int S, int T, int F, int IW, int sms, BlockPlan* p) {
  int tile;
  if (IW <= 4) {
    p->form = 4;
    p->kernel = reinterpret_cast<const void*>(block_support_kernel<4>);
    tile = Form<4>::kTile;
  } else {
    p->form = 0;
    p->kernel = reinterpret_cast<const void*>(block_support_kernel<0>);
    tile = Form<0>::kTile;
  }
  p->IWp = p->form ? p->form : (IW + 3) / 4 * 4;
  p->row_tile = max(1, min(p->form ? kMaxRowTile : kMaskRows, kStageWords / p->IWp));
  p->smem = 2 * sizeof(uint32_t) * static_cast<size_t>(p->row_tile) * p->IWp;
  p->vec16 = IW == p->IWp && reinterpret_cast<uintptr_t>(tx) % 16 == 0;
  const cudaError_t err = resident(p->kernel, kThreads, p->smem, 0, &p->blocks_per_sm);
  if (err != cudaSuccess) return err;
  const long long total = ceil_div(F, tile) * S * T;
  const long long wave = static_cast<long long>(max(sms, 1)) * max(p->blocks_per_sm, 1);
  p->blocks = static_cast<int>(max(1LL, min(wave, ceil_div(total, kMinRows))));
  p->per_block = ceil_div(total, p->blocks);
  return cudaSuccess;
}

template <int NW>
cudaError_t launch_block(const BlockPlan& p, const void* tx, const void* fi, void* out, int S,
                         int T, int F, int IW, cudaStream_t s) {
  block_support_kernel<NW><<<p.blocks, kThreads, p.smem, s>>>(
      static_cast<const uint32_t*>(tx), static_cast<const uint32_t*>(fi),
      static_cast<int32_t*>(out), S, T, F, IW, p.IWp, p.row_tile, p.per_block, p.vec16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tx uint32[S, T, IW], fi uint32[F, IW] -> out int32[S, F] (row-major,
// contiguous).  `sms` is the card's SM count, which the caller looks up
// once.  The caller bounds IW by 8192 words, so that one staged row fits.
int block_itemset_supports(const void* tx, const void* fi, void* out, int S, int T, int F,
                           int IW, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(S) * F, s);
  if (err != cudaSuccess || S <= 0 || T <= 0 || F <= 0) return static_cast<int>(err);
  BlockPlan p;
  err = plan_block(tx, S, T, F, IW, sms, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.form == 4) return static_cast<int>(launch_block<4>(p, tx, fi, out, S, T, F, IW, s));
  return static_cast<int>(launch_block<0>(p, tx, fi, out, S, T, F, IW, s));
}

// What block_itemset_supports launches for these operands, into facts[11]:
// blocks (grid x), threads a block, word form (4, or 0 for any width),
// itemsets a thread, rows a block, rows a staged tile, dynamic shared bytes,
// 16-byte staging (0 or 1), resident blocks an SM, registers a thread, local
// (spilled) bytes a thread.  The grid is one wave by construction.
int block_itemset_supports_facts(const void* tx, int S, int T, int F, int IW, int sms,
                                 int* facts) {
  BlockPlan p;
  cudaError_t err = plan_block(tx, S, T, F, IW, sms, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, p.kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sets = p.form == 4 ? Form<4>::kSets : Form<0>::kSets;
  const int values[11] = {p.blocks, kThreads, p.form, sets,
                          static_cast<int>(p.per_block), p.row_tile, static_cast<int>(p.smem),
                          p.vec16, p.blocks_per_sm, fa.numRegs,
                          static_cast<int>(fa.localSizeBytes)};
  for (int j = 0; j < 11; ++j) facts[j] = values[j];
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
