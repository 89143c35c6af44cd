// Subset/superset query sweep of the serving engine for Hopper (sm_90a).
//
//   B4  subset_superset_counts:
//       miss[q, f]  = sum_w popc(fi[f, w] & ~query[q, w])     (|f \ q|)
//       extra[q, f] = sum_w popc(query[q, w] & ~fi[f, w])     (|q \ f|)
//
// Words are the port's packed itemset masks (bit i % 32 of word i / 32), read
// as uint32.  Outputs are exact int32 counts.  The entry point has a plain C
// interface for ctypes: it launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so a refused launch is reported at once.
//
// The TPU kernel walks the item words as the sequential minor grid axis with
// both sums held in the output blocks.  Here the item words (IW, a few) are a
// loop inside the block, and Q x F carries the parallelism: a block owns a
// tile of kQueryTile queries and kThreads itemsets, one itemset per thread,
// each thread keeping 2 x kQueryTile counters in registers.  Each pass stages
// kWordChunk words of the query tile (read by every thread at one address, a
// broadcast) and of the itemset tile (transposed, so thread f reads column f
// without bank conflicts) in shared memory.  The output is 8 bytes a pair and
// dominates the traffic; each store is coalesced along F.  Ragged Q and F are
// bounded, never padded: rows past the edge stage zero words and are never
// stored.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // itemsets per block, one per thread
constexpr int kQueryTile = 16;  // queries per block
constexpr int kWordChunk = 8;   // item words staged per pass

__global__ void __launch_bounds__(kThreads)
subset_query_kernel(const uint32_t* __restrict__ query, const uint32_t* __restrict__ fi,
                    int32_t* __restrict__ miss, int32_t* __restrict__ extra,
                    int Q, int F, int IW) {
  __shared__ uint32_t s_query[kQueryTile][kWordChunk];
  __shared__ uint32_t s_fi[kWordChunk][kThreads];
  const int f0 = blockIdx.x * kThreads;
  const int q0 = blockIdx.y * kQueryTile;
  const int f_rows = min(kThreads, F - f0);

  int m[kQueryTile], e[kQueryTile];
#pragma unroll
  for (int qq = 0; qq < kQueryTile; ++qq) m[qq] = e[qq] = 0;

  for (int w0 = 0; w0 < IW; w0 += kWordChunk) {
    const int nw = min(kWordChunk, IW - w0);
    if (threadIdx.x < kQueryTile * kWordChunk) {
      const int qq = threadIdx.x / kWordChunk;
      const int ww = threadIdx.x % kWordChunk;
      const int q = q0 + qq;
      s_query[qq][ww] = (q < Q && ww < nw) ? __ldg(query + static_cast<size_t>(q) * IW + w0 + ww)
                                           : 0u;
    }
    // The tile's itemset words in row order, so consecutive threads read
    // consecutive addresses whenever the chunk spans the whole row.
    for (int i = threadIdx.x; i < kThreads * nw; i += kThreads) {
      const int r = i / nw;
      const int ww = i % nw;
      s_fi[ww][r] = r < f_rows ? __ldg(fi + static_cast<size_t>(f0 + r) * IW + w0 + ww) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int ww = 0; ww < kWordChunk; ++ww) {
      if (ww < nw) {
        const uint32_t fw = s_fi[ww][threadIdx.x];
#pragma unroll
        for (int qq = 0; qq < kQueryTile; ++qq) {
          const uint32_t qw = s_query[qq][ww];
          m[qq] += __popc(fw & ~qw);
          e[qq] += __popc(qw & ~fw);
        }
      }
    }
    __syncthreads();
  }

  const int f = f0 + threadIdx.x;
  if (f < F) {
#pragma unroll
    for (int qq = 0; qq < kQueryTile; ++qq) {
      const int q = q0 + qq;
      if (q < Q) {
        const size_t at = static_cast<size_t>(q) * F + f;
        miss[at] = m[qq];
        extra[at] = e[qq];
      }
    }
  }
}

}  // namespace

extern "C" {

// query uint32[Q, IW], fi uint32[F, IW] -> miss, extra int32[Q, F] (row-major,
// contiguous).  Every output element is written, so nothing is zeroed first.
int subset_superset_counts(const void* query, const void* fi, void* miss, void* extra,
                           int Q, int F, int IW, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q > 0 && F > 0) {
    const dim3 grid((F + kThreads - 1) / kThreads, (Q + kQueryTile - 1) / kQueryTile);
    subset_query_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(query), static_cast<const uint32_t*>(fi),
        static_cast<int32_t*>(miss), static_cast<int32_t*>(extra), Q, F, IW);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
