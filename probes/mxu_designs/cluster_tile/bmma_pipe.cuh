// The main loop shared by the tensor-core sweeps B2 (mxu_support.cu) and B7
// (pair_support.cu) on Hopper (sm_90a): a block computes one output tile of
//
//   C[a, b] = sum_w popc(A[a, w] & B[b, w])    (A masked by a row of valid words in B7)
//
// over one chunk of the W words, on the 1-bit MMA of bmma.cuh, and the
// chunks of a tile add their counts into the output through their
// thread-block cluster.
//
// Both kernels move few bytes for their time, so the design cuts what
// reaching the words, and adding up the chunks, costs:
//
// - One block holds the whole tile that fits in registers: up to MT x 16
//   fragments of 16 x 8 (64 x 128 counts in B2, 128 x 128 in B7), so each word
//   crosses from memory to an SM once.  W is cut into one chunk per resident
//   block.
// - A chunk is staged with 16-byte cp.async into a ring of kStages slots of
//   32 words a row, every slot the ring holds in flight at once.  At odd W
//   the rows start only 4-byte aligned, so a row lands as the 16-byte units
//   that hold its 32 words, up to 3 words early (its shift); words past the
//   chunk are zero-filled by the copy itself.  Rows past the operands are
//   not copied: they hold whatever the ring held, and only make counts that
//   are never stored.
// - The fragments are read word by word at the row's shift (thread t of a
//   k-step reads words t and 4 + t of 8), which costs no more shared-memory
//   wavefronts than 16-byte reads and needs no pass to realign.
// - The 8 warps are 2 row sets x 4 column quads; each owns MT / 2 m-tiles
//   and 4 n-tiles (m_tile, n_tile) over every word of the chunk.  Pairing
//   the ends of both ranges gives every warp about the same share of a
//   triangle.
// - The chunks of a tile form a cluster of up to 8 blocks.  Every block owns
//   a slice of the tile and pushes the other slices of its counts into their
//   owners' shared memory with st.async, which their mbarriers count in; an
//   owner adds the cluster's counts of its slice and adds each into the
//   zeroed output with one integer atomic (exact in any order), neighbouring
//   threads on neighbouring outputs.  An output then takes one atomic per
//   cluster: adding all of a tile's chunks into one count directly would
//   queue every chunk's atomic on the same address.
#pragma once

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "bmma.cuh"
#include "occupancy.cuh"

namespace bmma_pipe {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;               // 8 warps: 2 row sets x 4 column quads
constexpr int kSlotWords = 32;              // words of a row in one ring slot: 4 k-steps
constexpr int kUnits = kSlotWords / 4 + 1;  // 16-byte units of a staged row: 32 words at any shift
constexpr int kRowStride = 4 * kUnits;      // words of a staged row
constexpr int kStages = 4;                  // ring slots, all in flight
constexpr int kCols = 128;                  // output columns of a tile: 16 n-tiles
constexpr int kTileLd = kCols + 8;          // tile row stride: fragment stores without conflicts
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr int kMinChunk = kSlotWords;       // words a block takes at least
constexpr int kMaxRows = 2 * kCols + 1;     // staged rows a block takes at most

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
// n-tiles [0, nt) of the rows from b_row; with `upper`, only those that
// reach the diagonal or above it (n >= 2m).
struct Frags {
  int a_row, b_row, mt, nt;
  bool upper;
};

// Where row r's words come from: the 16-byte unit that holds the chunk's
// first word (nullptr for a row past the operands) and how many words into
// it that word lies.  A block keeps a table of them and its cluster
// mbarrier in kHeadBytes ahead of the ring.
struct RowSource {
  const uint32_t* unit;
  int shift;
};
constexpr size_t kHeadBytes = sizeof(RowSource) * kMaxRows + 16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_wait_all_but(int n) {
  // n is 0..kStages - 1, known at the call
  if (n >= 3) asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tiles warp (mset, quad) owns: m-tiles 2i + (mset ^ (i & 1)) for i <
// MT / 2 ({0, 3, 4, 7} and {1, 2, 5, 6} at MT = 8) and n-tiles q, 7 - q,
// 8 + q, 15 - q.
__device__ __forceinline__ int m_tile(int mset, int i) { return 2 * i + (mset ^ (i & 1)); }

__device__ __forceinline__ int n_tile(int quad, int j) {
  return j == 0 ? quad : j == 1 ? 7 - quad : j == 2 ? 8 + quad : 15 - quad;
}

// Fragment (i, j) of warp (mset, quad).  Where the tile has at most MT / 2
// m-tiles (`wide`, as B2 at K <= 32), the row sets would leave half the
// warps idle, so instead every warp takes all m-tiles and the row sets split
// the quad's n-tiles: j < 2 of n_tile(quad, 2 mset + j).
__device__ __forceinline__ int frag_m(bool wide, int mset, int i) {
  return wide ? i : m_tile(mset, i);
}

__device__ __forceinline__ int frag_n(bool wide, int mset, int quad, int j) {
  return n_tile(quad, wide ? 2 * mset + j : j);
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

// The warp's MMAs on one staged slot (four k-steps of 256 bits).  a_lo[i],
// a_hi[i]: read_at of rows g and g + 8 of m-tile frag_m(i); b_at[j]: of row
// g of n-tile frag_n(j); v_at: of the mask row.
template <int MT, bool kMask>
__device__ __forceinline__ void mma_slot(const uint32_t* slot, const Frags& f, bool wide,
                                         int mset, int quad, const int (&a_lo)[MT / 2],
                                         const int (&a_hi)[MT / 2], const int (&b_at)[4],
                                         int v_at, int (&acc)[MT / 2][4][4]) {
#pragma unroll
  for (int c = 0; c < kSlotWords; c += 8) {  // one k-step: words c..c+7
    uint32_t b0[4], b1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool on = !(wide && j >= 2) && frag_n(wide, mset, quad, j) < f.nt;
      b0[j] = on ? slot[b_at[j] + c] : 0u;
      b1[j] = on ? slot[b_at[j] + c + 4] : 0u;
    }
    uint32_t v0 = ~0u, v1 = ~0u;
    if constexpr (kMask) {
      v0 = slot[v_at + c];
      v1 = slot[v_at + c + 4];
    }
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) {
      const int m = frag_m(wide, mset, i);
      bool any = false;  // a fragment of this m-tile for the warp to compute
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = frag_n(wide, mset, quad, j);
        any |= !(wide && j >= 2) && n < f.nt && !(f.upper && n < 2 * m);
      }
      if (m >= f.mt || !any) continue;
      const uint32_t a0 = slot[a_lo[i] + c] & v0, a1 = slot[a_hi[i] + c] & v0;
      const uint32_t a2 = slot[a_lo[i] + c + 4] & v1, a3 = slot[a_hi[i] + c + 4] & v1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = frag_n(wide, mset, quad, j);
        if ((wide && j >= 2) || n >= f.nt || (f.upper && n < 2 * m)) continue;
        mma_b1(acc[i][j], a0, a1, a2, a3, b0[j], b1[j]);
      }
    }
  }
}

// The block's counts of its fragments over words [w_begin, w_end), in the
// accumulators of its warps (zeroed here).  `smem` holds kHeadBytes of row
// table and mbarrier, then a ring of kStages slots of R rows of kRowStride
// words.
template <int MT, bool kMask>
__device__ __forceinline__ void sweep(unsigned char* smem, const Rows& rows, const Frags& f,
                                      int w_begin, int w_end, int (&acc)[MT / 2][4][4]) {
  const int R = rows.count();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int quad = warp & 3, mset = warp >> 2;
  RowSource* table = reinterpret_cast<RowSource*>(smem);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + kHeadBytes);
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const uint32_t* src = rows.src(r);
    const int shift = src ? static_cast<int>((reinterpret_cast<uintptr_t>(src + w_begin) >> 2) & 3) : 0;
    table[r] = RowSource{src ? src + w_begin - shift : nullptr, shift};
  }
#pragma unroll
  for (int i = 0; i < MT / 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;
  __syncthreads();

  const int slots = w_end > w_begin ? (w_end - w_begin + kSlotWords - 1) / kSlotWords : 0;
  const int slot_words = R * kRowStride;
  const int first = min(kStages, slots);
  for (int s = 0; s < first; ++s)
    stage(ring + s * slot_words, table, R, w_begin, w_begin + s * kSlotWords, w_end);

  const bool wide = f.mt <= MT / 2;
  int a_lo[MT / 2], a_hi[MT / 2], b_at[4];
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) {
    const int r = f.a_row + 16 * frag_m(wide, mset, i) + g;
    a_lo[i] = r < R ? read_at(table, r, t) : 0;
    a_hi[i] = r + 8 < R ? read_at(table, r + 8, t) : 0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = f.b_row + 8 * frag_n(wide, mset, quad, j) + g;
    b_at[j] = r < R ? read_at(table, r, t) : 0;
  }
  const int v_at = kMask ? read_at(table, R - 1, t) : 0;

  int issued = first;  // slots whose copies have started
  for (int s = 0; s < slots; ++s) {
    cp_async_wait_all_but(issued - s - 1);  // slot s has landed
    __syncthreads();
    uint32_t* slot = ring + (s % kStages) * slot_words;
    mma_slot<MT, kMask>(slot, f, wide, mset, quad, a_lo, a_hi, b_at, v_at, acc);
    if (issued < slots) {
      __syncthreads();  // every warp is done with this slot
      stage(slot, table, R, w_begin, w_begin + issued * kSlotWords, w_end);
      ++issued;
    }
  }
  __syncthreads();  // the ring is free for the epilogue
}

// The part of a tile that holds counts: 16 mt rows of 8 nt columns, taken
// as runs of 4 columns (16-byte units), `upr` a row.
struct Used {
  int units, upr;
  __device__ explicit Used(const Frags& f) : units(16 * f.mt * 2 * f.nt), upr(2 * f.nt) {}
  __device__ int at(int q) const { return (q / upr) * kTileLd + 4 * (q % upr); }  // int index
};

// Before the sweep: thread 0 initialises the block's mbarrier to expect its
// slice of the tile's counts from each other block of its cluster
// (reduce()).
__device__ __forceinline__ void prepare(unsigned char* smem, const Frags& f) {
  if (threadIdx.x != 0) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Used used(f);
  const int per = (used.units + ranks - 1) / ranks;
  const int bytes = 16 * (ranks - 1) * max(0, min(per, used.units - rank * per));
  const unsigned bar = smem_addr(smem + sizeof(RowSource) * kMaxRows);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Adds the block's counts into the output through its cluster.  The warps
// write their fragments into `tile` (16 MT rows of kTileLd ints over the
// ring); rank r of the cluster owns the r-th of `ranks` runs of the tile's
// used units, and every block pushes the other runs to their owners with
// st.async, counted in by the owners' mbarriers (prepare()); each owner
// adds up its run and calls store(row, col, count) once per nonzero count
// within rows x cols (with `upper`, only row <= col).
template <int MT, class Store>
__device__ __forceinline__ void reduce(int (&acc)[MT / 2][4][4], unsigned char* smem,
                                       const Frags& f, int rows, int cols, Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int quad = warp & 3, mset = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const bool wide = f.mt <= MT / 2;
  int* tile = reinterpret_cast<int*>(smem + kHeadBytes);
  // c0, c1: row g, columns 2t and 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int i = 0; i < MT / 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (wide && j >= 2) continue;
      int* top = tile + (16 * frag_m(wide, mset, i) + g) * kTileLd +
                 8 * frag_n(wide, mset, quad, j) + 2 * t;
      *reinterpret_cast<int2*>(top) = make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(top + 8 * kTileLd) = make_int2(acc[i][j][2], acc[i][j][3]);
    }

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Used used(f);
  const int per = (used.units + ranks - 1) / ranks;  // units of a run
  int4* inbox = reinterpret_cast<int4*>(tile + 16 * MT * kTileLd);  // [ranks][per]
  const unsigned bar = smem_addr(smem + sizeof(RowSource) * kMaxRows);
  // every block's ring is free and its tile written
  if (ranks > 1) cluster.sync();
  else __syncthreads();
  for (int r = 1; r < ranks; ++r) {
    const int to = (rank + r) % ranks;
    const int n = min(per, used.units - to * per);
    unsigned dst, remote_bar;
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst) : "r"(smem_addr(inbox + rank * per)), "r"(to));
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote_bar) : "r"(bar), "r"(to));
    for (int q = threadIdx.x; q < n; q += kThreads) {
      const int4 v = *reinterpret_cast<const int4*>(tile + used.at(to * per + q));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], {%1, %2, %3, %4}, [%5];"
          ::"r"(dst + 16 * q), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
          : "memory");
    }
  }
  if (ranks > 1) {
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(bar)
          : "memory");
  }
  const int n = min(per, used.units - rank * per);
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int at = used.at(rank * per + q);
    int4 sum = *reinterpret_cast<const int4*>(tile + at);
    for (int r = 0; r < ranks; ++r) {
      if (r == rank) continue;
      const int4 v = inbox[r * per + q];
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    const int row = at / kTileLd;
    const int col = at - row * kTileLd;
    const int c[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (row < rows && col + k < cols && !(f.upper && row > col + k) && c[k])
        store(row, col + k, c[k]);
  }
}

// How a sweep is launched: chunks of W a tile (clusters of `cluster` blocks
// along grid x), the chunk's words, the dynamic shared bytes, resident
// blocks an SM and clusters on the card.
struct Plan {
  int chunks, cluster, chunk, per_sm, fit;
  size_t smem;
};

// Shared bytes for the head and, over the same bytes, a ring of `rows` staged
// rows and an MT-row tile with its inbox of the cluster's slices.
inline size_t smem_bytes(int rows, int mt) {
  const size_t ring = sizeof(uint32_t) * static_cast<size_t>(kStages) * rows * kRowStride;
  const size_t tile = sizeof(int) * static_cast<size_t>(16 * mt) * kTileLd;
  const size_t inbox = kMaxCluster * (tile / 16 / kMaxCluster + 1) * 16;
  return kHeadBytes + std::max(ring, tile + inbox);
}

// One wave where the tiles allow it: as many chunks a tile as fill the SMs
// (never under kMinChunk words), in clusters of up to 8 blocks, as many
// clusters a tile as are resident at once.
inline cudaError_t plan(const void* kernel, long long tiles, int W, int sms, size_t smem,
                        Plan* p) {
  p->smem = smem;
  cudaError_t err = resident(kernel, kThreads, smem, 0, &p->per_sm);
  if (err != cudaSuccess) return err;
  const long long wave = static_cast<long long>(std::max(sms, 1)) * std::max(p->per_sm, 1);
  const long long want = std::max(1LL, std::min(wave / tiles, ceil_div(W, kMinChunk)));
  p->cluster = static_cast<int>(std::min<long long>(kMaxCluster, want));
  err = resident(kernel, kThreads, smem, p->cluster, &p->fit);
  if (err != cudaSuccess) return err;
  const long long per_tile = std::max(1LL, std::min(want / p->cluster, p->fit / tiles));
  p->chunks = static_cast<int>(per_tile * p->cluster);
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

// The launch configuration of `p` over grid (chunks, y, z).
inline cudaLaunchConfig_t config(const Plan& p, unsigned y, unsigned z, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.chunks, y, z);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// What a launch of `kernel` under `p` over grid (chunks, y, z) with `tiles`
// output tiles looks like, into facts[12]: grid x, y, z, threads a block,
// cluster size, chunk words, dynamic shared bytes, resident blocks an SM,
// clusters resident at once, waves, registers a thread, local (spilled)
// bytes a thread.
inline cudaError_t facts(const void* kernel, const Plan& p, unsigned y, unsigned z,
                         long long tiles, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const long long clusters = tiles * (p.chunks / p.cluster);
  const int values[12] = {p.chunks, static_cast<int>(y), static_cast<int>(z), kThreads,
                          p.cluster, p.chunk, static_cast<int>(p.smem), p.per_sm, p.fit,
                          static_cast<int>(ceil_div(clusters, std::max(p.fit, 1))), fa.numRegs,
                          static_cast<int>(fa.localSizeBytes)};
  for (int j = 0; j < 12; ++j) out[j] = values[j];
  return cudaSuccess;
}

}  // namespace bmma_pipe
