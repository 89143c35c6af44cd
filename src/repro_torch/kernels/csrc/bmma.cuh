// The tensor cores' 1-bit MMA for Hopper (sm_90a), shared by B2
// (mxu_support.cu) and B7 (pair_support.cu):
//
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//
// C[16 x 8] += popc(A[16 x 256 bits] AND B[256 bits x 8]) in int32: the dot
// product of two 0/1 vectors is the population count of their AND, taken on
// the packed words themselves.  Each fragment register is one packed word:
// a0 is word t of row g (t the thread's index in its group of four, g the
// group), a1 the same word of row g+8, a2 and a3 word 4+t of the two rows;
// b0 and b1 words t and 4+t of column g.  c0 and c1 are row g, columns 2t
// and 2t+1; c2 and c3 the same at row g+8.
#pragma once

#include <cstdint>

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
