// Shared device code of the mma.sync conv kernel (conv_stats.cuh, design
// 0): bf16 tensor-core tiles (mma.sync m16n8k16, fp32 accumulate) and the
// ldmatrix loads of their fragments.
//
// Conventions
//   * Every shared-memory tile is row-major with PAD extra bf16 per row. The
//     padded row stride is a multiple of 16 bytes (ldmatrix needs that) and
//     shifts consecutive rows by 4 banks, so the 8 rows one ldmatrix phase
//     touches fall on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

constexpr int PAD = 8;    // bf16 elements of row padding in shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l supplies the address of row (l % 8) of
// matrix (l / 8). Register i of every lane holds, of matrix i, the two
// elements (row = lane / 4, cols = 2 * (lane % 4) + {0, 1}).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Same, each matrix transposed on the way: register i holds the elements
// (rows = 2 * (lane % 4) + {0, 1}, col = lane / 4) of stored matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per-lane row/column offsets of the ldmatrix addresses.
//   a-pattern: matrices (rows 0-7, col 0), (rows 8-15, col 0),
//              (rows 0-7, col 8), (rows 8-15, col 8)
//     -> the A operand of a 16x16 row-major tile, and (with .trans) the B
//        operands of two adjacent 8-wide column tiles of a [k][n] tile.
//   b-pattern: matrices (rows 0-7, col 0), (rows 0-7, col 8),
//              (rows 8-15, col 0), (rows 8-15, col 8)
//     -> the B operands of two adjacent n-tiles of an [n][k] row-major tile.
struct LaneOffsets {
  int a_row, a_col, b_row, b_col;
  __device__ __forceinline__ explicit LaneOffsets(int lane) {
    a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    a_col = (lane >> 4) * 8;
    b_row = (lane & 7) + (lane >> 4) * 8;
    b_col = ((lane >> 3) & 1) * 8;
  }
};
