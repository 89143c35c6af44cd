// The main loop shared by the tensor-core sweeps B2 (mxu_support.cu) and B7
// (pair_support.cu) on Hopper (sm_90a): a block computes one output tile of
//
//   C[a, b] = sum_w popc(A[a, w] & B[b, w])    (A masked by a row of valid words in B7)
//
// over one chunk of the W words, on the 1-bit MMA of bmma.cuh, and adds its
// counts into the zeroed output with integer atomics (exact in any order).
//
// Both kernels move few bytes for their time: what costs is reaching the
// words, and adding up the chunks of an output.  The design:
//
// - A block of 4 warps owns an MT x NT tile of 16 x 8 fragments for its whole
//   chunk.  Warp w takes k-step w (words 8w..8w+7) of every 32-word slot and
//   holds all the tile's fragments, so each staged word is read from shared
//   memory by one warp only.
// - The chunk is staged with 16-byte cp.async into a ring of kStages slots,
//   all of them in flight while the oldest is computed, so the copies stay in
//   flight behind the MMAs (a chunk is at least kMinChunk words: several
//   slots).  At odd W the rows start only 4-byte aligned, so a row lands as
//   the 16-byte units that hold its 32 words, up to 3 words early (its
//   shift), and its words are read one by one at the shift (which costs no
//   more shared-memory wavefronts than 16-byte reads and needs no pass to
//   realign).  Words past the chunk are zero-filled by the copy itself; rows
//   past the operands are not copied and only make counts that are never
//   stored.
// - W is cut into about one chunk per SM over all tiles, and no finer: every
//   chunk of a tile adds each of its counts with one atomic, and the atomics
//   on one address queue behind each other, so a tile's chunks are kept to
//   about SMs / tiles.  The tiles are as tall as the registers allow, so that
//   there are few of them and each word is read by few of them.
// - The warps' counts meet in shared memory (four partial tiles, summed by
//   the thread that adds the output), neighbouring threads on neighbouring
//   outputs.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "bmma.cuh"
#include "occupancy.cuh"

namespace bmma_pipe {

constexpr int kWarps = 4;                   // one k-step of a slot each
constexpr int kThreads = 32 * kWarps;
constexpr int kSlotWords = 8 * kWarps;      // words of a row in one ring slot
constexpr int kUnits = kSlotWords / 4 + 1;  // 16-byte units of a staged row: 32 words at any shift
constexpr int kRowStride = 4 * kUnits;      // words of a staged row
constexpr int kStages = 4;                  // ring slots, all in flight
constexpr int kMinChunk = 4 * kSlotWords;   // words a block takes at least
constexpr int kMaxRows = 128;               // staged rows a block takes at most

// The rows a block stages, in order: p0 rows of segment 0 (the first n0 real,
// from src0), p1 rows of segment 1 (the first n1 real, from src1), then the
// mask row if there is one.  Rows are W words apart; each operand's storage
// starts 16-byte aligned and ends on a 16-byte boundary, as PyTorch's
// allocator gives.
struct Rows {
  const uint32_t* src0;
  int n0, p0;
  const uint32_t* src1;
  int n1, p1;
  const uint32_t* mask;
  int W;
  __device__ int count() const { return p0 + p1 + (mask != nullptr); }
  // Row r's first word, or nullptr for a row past the operands.
  __device__ const uint32_t* src(int r) const {
    if (r < p0) return r < n0 ? src0 + static_cast<size_t>(r) * W : nullptr;
    if (r < p0 + p1) return r - p0 < n1 ? src1 + static_cast<size_t>(r - p0) * W : nullptr;
    return mask;
  }
};

// Which fragments a block computes: m-tiles [0, mt) of the rows from a_row,
// n-tiles [0, nt) of the rows from b_row.
struct Frags {
  int a_row, b_row, mt, nt;
};

// Where row r's words come from: the 16-byte unit that holds the chunk's
// first word (nullptr for a row past the operands) and how many words into
// it that word lies.  A block keeps a table of them ahead of its ring.
struct RowSource {
  const uint32_t* unit;
  int shift;
};
constexpr size_t kHeadBytes = sizeof(RowSource) * kMaxRows;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Waits until at most n (0 to kStages - 1) of this thread's commit groups
// are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  static_assert(kStages == 4, "one wait_group a depth");
  if (n >= 3) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of words [w0, w0 + 32) of every real staged row into
// `slot`: row r's 16-byte units from the one that holds word w0 land at
// slot[r * kRowStride], so word w0 + x is at slot[r * kRowStride + shift + x].
// Words at or past w_end are zero-filled; a unit with none to copy is given
// its row's first unit as its (unread) source.  One commit group.
__device__ __forceinline__ void stage(uint32_t* slot, const RowSource* table, int R, int w_begin,
                                      int w0, int w_end) {
  for (int e = threadIdx.x; e < R * kUnits; e += kThreads) {
    const int r = e / kUnits;
    const int u = e - r * kUnits;
    const RowSource from = table[r];
    if (!from.unit) continue;
    const uint32_t* unit = from.unit + (w0 - w_begin);
    const int n = min(4, max(0, w_end - w0 - (4 * u - from.shift)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(slot + r * kRowStride + 4 * u)),
                 "l"(n ? unit + 4 * u : unit), "r"(4 * n)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Where a thread reads row r of a slot: word t of the row at its shift.
__device__ __forceinline__ int read_at(const RowSource* table, int r, int t) {
  return r * kRowStride + table[r].shift + t;
}

// The block's counts of its fragments over words [w_begin, w_end): warp w's
// share (k-step w of every slot) in acc (zeroed here).  `smem` holds
// kHeadBytes of row table, then a ring of kStages slots of R rows of
// kRowStride words.
template <int MT, int NT, bool kMask>
__device__ __forceinline__ void sweep(unsigned char* smem, const Rows& rows, const Frags& f,
                                      int w_begin, int w_end, int (&acc)[MT][NT][4]) {
  const int R = rows.count();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  RowSource* table = reinterpret_cast<RowSource*>(smem);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kHeadBytes);
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const uint32_t* src = rows.src(r);
    const int shift = src ? static_cast<int>((reinterpret_cast<uintptr_t>(src + w_begin) >> 2) & 3) : 0;
    table[r] = RowSource{src ? src + w_begin - shift : nullptr, shift};
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][n][k] = 0;
  __syncthreads();

  const int slots = w_end > w_begin ? (w_end - w_begin + kSlotWords - 1) / kSlotWords : 0;
  const int slot_words = R * kRowStride;
  int issued = 0;  // slots whose copies have started
  for (; issued < min(kStages - 1, slots); ++issued)
    stage(ring + issued * slot_words, table, R, w_begin, w_begin + issued * kSlotWords, w_end);

  // this warp's words of a slot: c and c + 4 of its k-step, at each row's shift
  const int c = 8 * warp;
  int a_lo[MT], a_hi[MT], b_at[NT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r = f.a_row + 16 * m + g;
    a_lo[m] = (r < R ? read_at(table, r, t) : 0) + c;
    a_hi[m] = (r + 8 < R ? read_at(table, r + 8, t) : 0) + c;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int r = f.b_row + 8 * n + g;
    b_at[n] = (r < R ? read_at(table, r, t) : 0) + c;
  }
  const int v_at = (kMask ? read_at(table, R - 1, t) : 0) + c;

  for (int s = 0; s < slots; ++s) {
    if (issued < slots) {  // the slot computed last round is free: refill it
      stage(ring + (issued % kStages) * slot_words, table, R, w_begin,
            w_begin + issued * kSlotWords, w_end);
      ++issued;
    }
    cp_async_wait(issued - s - 1);  // slot s has landed
    __syncthreads();
    const uint32_t* slot = ring + (s % kStages) * slot_words;
    const uint32_t v0 = kMask ? slot[v_at] : ~0u, v1 = kMask ? slot[v_at + 4] : ~0u;
    uint32_t b0[NT], b1[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      b0[n] = n < f.nt ? slot[b_at[n]] : 0u;
      b1[n] = n < f.nt ? slot[b_at[n] + 4] : 0u;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= f.mt) continue;
      const uint32_t a0 = slot[a_lo[m]] & v0, a1 = slot[a_hi[m]] & v0;
      const uint32_t a2 = slot[a_lo[m] + 4] & v1, a3 = slot[a_hi[m] + 4] & v1;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < f.nt) mma_b1(acc[m][n], a0, a1, a2, a3, b0[n], b1[n]);
    }
    __syncthreads();  // every warp is done with slot s before it is refilled
  }
}

// The partial tile's row stride: int2 stores of the fragments without bank
// conflicts.
template <int NT>
__host__ __device__ constexpr int tile_ld() {
  return 8 * NT + 8;
}

// Adds the block's counts into the output: each warp writes its fragments
// into a partial tile in shared memory (over the ring), and store(row, col,
// count) is called once for every nonzero count of the rows x cols entries,
// the sum of the four partials, consecutive threads on consecutive columns.
template <int MT, int NT, class Store>
__device__ __forceinline__ void reduce(int (&acc)[MT][NT][4], unsigned char* smem, int rows,
                                       int cols, Store store) {
  constexpr int kLd = tile_ld<NT>();
  constexpr int kTile = 16 * MT * kLd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  int* tiles = reinterpret_cast<int*>(smem + kHeadBytes);
  int* mine = tiles + warp * kTile;
  // c0, c1: row g, columns 2t and 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      int* top = mine + (16 * m + g) * kLd + 8 * n + 2 * t;
      *reinterpret_cast<int2*>(top) = make_int2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<int2*>(top + 8 * kLd) = make_int2(acc[m][n][2], acc[m][n][3]);
    }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int row = e / cols;
    const int col = e - row * cols;
    const int at = row * kLd + col;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += tiles[w * kTile + at];
    if (sum) store(row, col, sum);
  }
}

// Shared bytes for the row table and, over the same bytes, a ring of `rows`
// staged rows and the four partial MT x NT tiles.
template <int MT, int NT>
inline size_t smem_bytes(int rows) {
  const size_t ring = sizeof(uint32_t) * static_cast<size_t>(kStages) * rows * kRowStride;
  const size_t tiles = sizeof(int) * static_cast<size_t>(kWarps) * 16 * MT * tile_ld<NT>();
  return kHeadBytes + std::max(ring, tiles);
}

// How a sweep is launched: chunks of W a tile (grid x), the chunk's words,
// the dynamic shared bytes and resident blocks an SM.
struct Plan {
  int chunks, chunk, per_sm;
  size_t smem;
};

// About one chunk per SM over all tiles, never under kMinChunk words.
inline cudaError_t plan(const void* kernel, long long tiles, int W, int sms, size_t smem,
                        Plan* p) {
  p->smem = smem;
  const cudaError_t err = resident(kernel, kThreads, smem, 0, &p->per_sm);
  if (err != cudaSuccess) return err;
  const long long per_tile =
      ceil_div(static_cast<long long>(std::max(sms, 1)) * std::max(p->per_sm, 1), tiles);
  p->chunks = static_cast<int>(std::max(1LL, std::min(per_tile, ceil_div(W, kMinChunk))));
  p->chunk = static_cast<int>(ceil_div(W, p->chunks));
  return cudaSuccess;
}

// The status an entry point returns: the first error `err`, else the
// launch's, read (and cleared) from the runtime so that it does not come back
// on the next call.
inline int status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// What a launch of `kernel` under `p` over grid (chunks, y, z) with `tiles`
// output tiles looks like, into facts[10]: grid x, y, z, threads a block,
// chunk words, dynamic shared bytes, resident blocks an SM, waves, registers
// a thread, local (spilled) bytes a thread.
inline cudaError_t facts(const void* kernel, const Plan& p, unsigned y, unsigned z,
                         long long tiles, int sms, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const long long wave = static_cast<long long>(std::max(sms, 1)) * std::max(p.per_sm, 1);
  const int values[10] = {p.chunks, static_cast<int>(y), static_cast<int>(z), kThreads,
                          p.chunk, static_cast<int>(p.smem), p.per_sm,
                          static_cast<int>(ceil_div(tiles * p.chunks, wave)), fa.numRegs,
                          static_cast<int>(fa.localSizeBytes)};
  for (int j = 0; j < 10; ++j) out[j] = values[j];
  return cudaSuccess;
}

}  // namespace bmma_pipe
