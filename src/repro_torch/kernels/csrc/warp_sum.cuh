// Warp sums shared by the POPC sweeps (support.cu: B1, B3; pair_support.cu:
// B6).
#pragma once

// The sum of v over the warp, on lane 0.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums v[0..31] over the warp and leaves, on lane l, the sum of v[l] in v[0]:
// at each step S (16, 8, 4, 2, 1) a lane keeps the half of its counters that
// bit S of its lane index selects and sends the other half to its partner,
// 31 shuffles in all (32 separate warp sums would take 160).  The steps are
// a template recursion so that every index is a constant and v stays in
// registers.
template <int S>
__device__ __forceinline__ void warp_transpose_sum(int (&v)[32], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int send = upper ? v[j] : v[j + S];
    const int keep = upper ? v[j + S] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
  if constexpr (S > 1) warp_transpose_sum<S / 2>(v, lane);
}
