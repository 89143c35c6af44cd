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
// the int32 output holds.  A is the prefixes' tidlists, B the item rows: the
// item rows are already the column-major B the MMA takes.
//
// The bound: as in the port's own source of the same name.
//
// The design is bmma_pipe.cuh's: a block owns a tile of 64 prefixes x 32
// items (K pads to 16 and I to 8 in shared memory) and one chunk of W, with
// all four warps on all of its fragments, each on its own k-step.  At the
// path's K=64, I=100 the 4 tiles read each tidlist 4 times and each item row
// once (22 MB, where 16 x 32 tiles read 49 MB), and each count takes 33
// atomics, one per chunk.
#include <cstdint>
#include <cuda_runtime.h>

#include "bmma_pipe.cuh"

namespace {

using namespace bmma_pipe;

constexpr int kMTiles = 1;  // m-tiles of 16 prefixes a block
constexpr int kNTiles = 4;  // n-tiles of 8 items a block
constexpr int kTileK = 16 * kMTiles;
constexpr int kTileI = 8 * kNTiles;

// grid = (chunks of W, prefix tiles of 64, item tiles of 32): block x of a
// tile sweeps words [x * chunk, (x + 1) * chunk).
__global__ void __launch_bounds__(kThreads)
mxu_support_kernel(const uint32_t* __restrict__ items,
                   const uint32_t* __restrict__ tids,
                   int32_t* __restrict__ out, int K, int I, int W, int chunk) {
  extern __shared__ uint4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  const int k0 = blockIdx.y * kTileK;
  const int i0 = blockIdx.z * kTileI;
  const int kr = min(kTileK, K - k0);
  const int ir = min(kTileI, I - i0);
  const int mt = (kr + 15) / 16;
  const int nt = (ir + 7) / 8;
  const Rows rows{tids + static_cast<size_t>(k0) * W, kr, 16 * mt,
                  items + static_cast<size_t>(i0) * W, ir, 8 * nt, nullptr, W};
  const Frags frags{0, 16 * mt, mt, nt};
  const int w_begin = min(W, static_cast<int>(blockIdx.x) * chunk);
  const int w_end = min(W, w_begin + chunk);

  int acc[kMTiles][kNTiles][4];
  sweep<kMTiles, kNTiles, false>(base, rows, frags, w_begin, w_end, acc);
  reduce<kMTiles, kNTiles>(acc, base, kr, ir, [&](int row, int col, int s) {
    atomicAdd(out + static_cast<size_t>(k0 + row) * I + i0 + col, s);
  });
}

// The shared bytes of a launch at these shapes: the ring for the widest tile.
size_t mxu_smem(int K, int I) {
  const int rows = 16 * static_cast<int>(ceil_div(std::min(K, kTileK), 16)) +
                   8 * static_cast<int>(ceil_div(std::min(I, kTileI), 8));
  return smem_bytes<kMTiles, kNTiles>(rows);
}

const void* mxu_kernel() { return reinterpret_cast<const void*>(mxu_support_kernel); }

}  // namespace

extern "C" {

// items uint32[I, W], tids uint32[K, W] -> out int32[K, I] (row-major,
// contiguous), launched on `stream`; returns the first error.  `sms` is
// the card's SM count, which the caller looks up once.
int multi_extension_supports_mxu(const void* items, const void* tids, void* out,
                                 int K, int I, int W, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(K) * I, s);
  if (err != cudaSuccess || K <= 0 || I <= 0 || W <= 0) return status(err);
  const unsigned k_tiles = static_cast<unsigned>(ceil_div(K, kTileK));
  const unsigned i_tiles = static_cast<unsigned>(ceil_div(I, kTileI));
  Plan p;
  err = plan(mxu_kernel(), static_cast<long long>(k_tiles) * i_tiles, W, sms, mxu_smem(K, I), &p);
  if (err != cudaSuccess) return status(err);
  mxu_support_kernel<<<dim3(p.chunks, k_tiles, i_tiles), kThreads, p.smem, s>>>(
      static_cast<const uint32_t*>(items), static_cast<const uint32_t*>(tids),
      static_cast<int32_t*>(out), K, I, W, p.chunk);
  return status(cudaSuccess);
}

// What multi_extension_supports_mxu launches for these shapes, into
// facts[10] (bmma_pipe::facts), without launching.
int multi_extension_supports_mxu_facts(int K, int I, int W, int sms, int* facts) {
  const unsigned k_tiles = static_cast<unsigned>(ceil_div(K, kTileK));
  const unsigned i_tiles = static_cast<unsigned>(ceil_div(I, kTileI));
  const long long tiles = static_cast<long long>(k_tiles) * i_tiles;
  Plan p;
  cudaError_t err = plan(mxu_kernel(), tiles, W, sms, mxu_smem(K, I), &p);
  if (err == cudaSuccess)
    err = bmma_pipe::facts(mxu_kernel(), p, k_tiles, i_tiles, tiles, sms, facts);
  return status(err);
}

}  // extern "C"
