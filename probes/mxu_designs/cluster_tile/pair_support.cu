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
// S is symmetric, so both kernels compute only the tile pairs (ti, tj) with
// ti <= tj and add each off-diagonal count to S[i, j] and to S[j, i].  B6
// launches one block per pair along blockIdx.x and splits W over blockIdx.y;
// B7 runs bmma_pipe.cuh's main loop (its note is below).  The chunks'
// partial counts are added with integer atomics into the zeroed output,
// exact in any order.  valid_tid masks the words before they are counted;
// rows past I and words past W read as zero and are never stored.
//
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "bmma_pipe.cuh"

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
// bmma_pipe.cuh's main loop with both operands the item rows: a block owns
// a pair of 128-row tiles (ti <= tj) and one chunk of W.  A diagonal pair
// stages its rows once, as both A and B, and computes only the fragments
// that reach the upper triangle; an off-diagonal pair stages both tiles.
// The valid words are one more staged row, ANDed into the A fragments in
// registers: popc((a & v) & b) = popc((a & v) & (b & v)).  Each count is
// added at [i, j] and, off the diagonal, at [j, i].  With I <= 128 (the
// profiled demo's 100 items) there is one tile pair and no pair index to
// decode; beyond, grid y and z are ti and tj and the blocks below the
// diagonal (ti > tj) leave at once.
constexpr int kSideTiles = 8;             // m-tiles of 16 rows: a side of 128
constexpr int kSide = 16 * kSideTiles;
static_assert(kSide == bmma_pipe::kCols, "a tile pair is square");

// grid = (chunks of W, ti, tj), clusters of (cluster, 1, 1).
__global__ void __launch_bounds__(bmma_pipe::kThreads, 1)
pair_support_mxu_kernel(const uint32_t* __restrict__ items,
                        const uint32_t* __restrict__ valid,
                        int32_t* __restrict__ out, int I, int W, int chunk) {
  using namespace bmma_pipe;
  const int ti = blockIdx.y, tj = blockIdx.z;
  if (ti > tj) return;  // the whole cluster: its blocks share ti and tj
  extern __shared__ uint4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int i0 = ti * kSide, j0 = tj * kSide;
  const int ni = min(kSide, I - i0), nj = min(kSide, I - j0);
  const bool diag = ti == tj;
  const int mt = (ni + 15) / 16;
  const int nt = (nj + 7) / 8;
  const uint32_t* a = items + static_cast<size_t>(i0) * W;
  const uint32_t* b = items + static_cast<size_t>(j0) * W;
  const Rows rows = diag ? Rows{a, ni, 16 * mt, nullptr, 0, 0, valid, W}
                         : Rows{a, ni, 16 * mt, b, nj, 8 * nt, valid, W};
  const Frags frags{0, diag ? 0 : 16 * mt, mt, nt, diag};
  const int w_begin = min(W, static_cast<int>(blockIdx.x) * chunk);
  const int w_end = min(W, w_begin + chunk);

  int acc[kSideTiles / 2][4][4];
  prepare(base, frags);
  sweep<kSideTiles, true>(base, rows, frags, w_begin, w_end, acc);
  // each count is added at (i, j) and, off the diagonal, at (j, i); a
  // diagonal pair's counts below its diagonal were not computed
  reduce<kSideTiles>(acc, base, frags, ni, nj, [&](int row, int col, int s) {
    const int i = i0 + row, j = j0 + col;
    atomicAdd(out + static_cast<size_t>(i) * I + j, s);
    if (i != j) atomicAdd(out + static_cast<size_t>(j) * I + i, s);
  });
}

// Tiles of a side, the shared bytes of a launch (the ring for the widest
// pair: one tile and the mask row where there is one tile, else two), and
// the kernel.
long long side_tiles(int I) { return ceil_div(I, kSide); }

size_t pair_mxu_smem(int I) {
  const int rows = side_tiles(I) == 1 ? 16 * static_cast<int>(ceil_div(I, 16)) + 1
                                      : 2 * kSide + 1;
  return bmma_pipe::smem_bytes(rows, kSideTiles);
}

const void* pair_mxu_kernel() { return reinterpret_cast<const void*>(pair_support_mxu_kernel); }

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
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(I) * I, s);
  if (err != cudaSuccess || I <= 0 || W <= 0) return bmma_pipe::status(err);
  const long long t = side_tiles(I);
  bmma_pipe::Plan p;
  err = bmma_pipe::plan(pair_mxu_kernel(), t * (t + 1) / 2, W, sms, pair_mxu_smem(I), &p);
  if (err != cudaSuccess) return bmma_pipe::status(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = bmma_pipe::config(p, t, t, s, &attr);
  return bmma_pipe::status(cudaLaunchKernelEx(&cfg, pair_support_mxu_kernel,
                                              static_cast<const uint32_t*>(items),
                                              static_cast<const uint32_t*>(valid),
                                              static_cast<int32_t*>(out), I, W, p.chunk));
}

// What pair_supports_mxu launches for these shapes, into facts[12]
// (bmma_pipe::facts: grid y and z are the tiles of a side), without
// launching.
int pair_supports_mxu_facts(int I, int W, int sms, int* facts) {
  const long long t = side_tiles(I);
  bmma_pipe::Plan p;
  cudaError_t err = bmma_pipe::plan(pair_mxu_kernel(), t * (t + 1) / 2, W, sms,
                                    pair_mxu_smem(I), &p);
  if (err == cudaSuccess)
    err = bmma_pipe::facts(pair_mxu_kernel(), p, t, t, t * (t + 1) / 2, facts);
  return bmma_pipe::status(err);
}

}  // extern "C"
