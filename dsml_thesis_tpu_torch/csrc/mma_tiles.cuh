// Shared device code of the mma.sync kernels (the bf16 D = 512 attention of
// flash_attention.cu and flash_attention_streaming.cu, and conv_stats.cuh):
// bf16 tensor-core tiles (mma.sync m16n8k16, fp32 accumulate), shared-memory
// tile loads and the online-softmax attention core of the D = 512 forward.
//
// Conventions
//   * Every shared-memory tile is row-major with PAD extra bf16 per row. The
//     padded row stride is a multiple of 16 bytes (ldmatrix needs that) and
//     shifts consecutive rows by 4 banks, so the 8 rows one ldmatrix phase
//     touches fall on distinct banks.
//   * A block owns BM = 64 query rows. Warp w owns rows (w / DSPLIT) * 16 ..
//     +15; with DSPLIT > 1 the DSPLIT warps of a row group each accumulate
//     D / DSPLIT output columns (they recompute the same scores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

constexpr int PAD = 8;    // bf16 elements of row padding in shared memory
constexpr int BM = 64;    // query rows per block

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Copy a rows x COLS tile from device memory (row stride ld elements) into a
// padded shared-memory tile, 16 bytes a thread; rows at or past valid_rows
// and columns at or past valid_cols (a multiple of 8) are filled with zeros
// and not read. Needs 16-byte aligned rows in device memory.
template <int COLS, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t ld,
                                          int rows, int valid_rows, int tid,
                                          int valid_cols = COLS) {
  constexpr int CHUNKS = COLS / 8;
  for (int i = tid; i < rows * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows && c < valid_cols)
      v = *reinterpret_cast<const uint4*>(g + r * ld + c);
    *reinterpret_cast<uint4*>(s + r * (COLS + PAD) + c) = v;
  }
}

// load_tile with every element multiplied by c in bf16 on the way (one
// rounding to bf16, as a bf16 tensor times a bf16 scalar gives): the
// streaming attention kernels fold scale * log2(e) into q this way.
template <int COLS, int NTHREADS>
__device__ __forceinline__ void load_tile_scaled(bf16* s, const bf16* g,
                                                 int64_t ld, int rows,
                                                 int valid_rows, int tid,
                                                 bf16 c) {
  constexpr int CHUNKS = COLS / 8;
  const __nv_bfloat162 c2 = __bfloat162bfloat162(c);
  for (int i = tid; i < rows * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int col = (i % CHUNKS) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) {
      v = *reinterpret_cast<const uint4*>(g + r * ld + col);
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = __hmul2(p[j], c2);
    }
    *reinterpret_cast<uint4*>(s + r * (COLS + PAD) + col) = v;
  }
}

// Online-softmax attention of this block's 64 query rows (already in shared
// memory, row stride ldq elements: D + PAD for a tile of one head, H*D + PAD
// for one head's columns of a packed tile) against nk key/value rows
// streamed from device memory in tiles of BN rows. On return `o` holds the
// warp's unnormalised output fragment (rows lane/4 and lane/4 + 8 of its row
// group, D / DSPLIT columns), l0 / l1 the softmax denominators of those two
// rows and m0 / m1 their row maxima in the scaled base-2 domain (so that
// m + log2(l) is the row's log-sum-exp of the scores times scale * log2(e),
// which the backward kernels read).
//
// Arithmetic: scores in fp32 times scale * log2(e), running row max and row
// sum in fp32, P = exp2(s - max) cast to bf16 before P.V, fp32 accumulation.
template <int D, int DSPLIT, int BN, int NTHREADS>
__device__ __forceinline__ void attend_rows(
    const bf16* sQ, int ldq, const bf16* gK, const bf16* gV, int64_t ld_kv,
    int nk,
    float scale_log2, bf16* sK, bf16* sV, float (&o)[D / DSPLIT / 8][4],
    float& l0, float& l1, float& m0, float& m1) {
  constexpr int LDS = D + PAD;
  constexpr int DO = D / DSPLIT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = (warp / DSPLIT) * 16;
  const int dcol0 = (warp % DSPLIT) * DO;
  const LaneOffsets lo(lane);

  m0 = -INFINITY;
  m1 = -INFINITY;
  l0 = 0.f;
  l1 = 0.f;
#pragma unroll
  for (int i = 0; i < DO / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int kv0 = 0; kv0 < nk; kv0 += BN) {
    __syncthreads();  // the previous tile's readers are done; sQ is visible
    load_tile<D, NTHREADS>(sK, gK + kv0 * ld_kv, ld_kv, BN, nk - kv0, tid);
    load_tile<D, NTHREADS>(sV, gV + kv0 * ld_kv, ld_kv, BN, nk - kv0, tid);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (row0 + lo.a_row) * ldq + kk + lo.a_col);
#pragma unroll
      for (int nt = 0; nt < BN / 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, sK + (nt * 8 + lo.b_row) * LDS + kk + lo.b_col);
        mma_bf16(s[nt], a, b[0], b[1]);
        mma_bf16(s[nt + 1], a, b[2], b[3]);
      }
    }

    // scale, mask the keys past nk, new row max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kv0 + nt * 8 + 2 * (lane & 3) + (j & 1);
        s[nt][j] = key < nk ? s[nt][j] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int i = 0; i < DO / 8; ++i) {
      o[i][0] *= alpha0;
      o[i][1] *= alpha0;
      o[i][2] *= alpha1;
      o[i][3] *= alpha1;
    }

    // P = exp2(S - max), summed in fp32, cast to bf16 as the A operand
    uint32_t p[BN / 8][2];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m0);
      const float p1 = exp2f(s[nt][1] - m0);
      const float p2 = exp2f(s[nt][2] - m1);
      const float p3 = exp2f(s[nt][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      p[nt][0] = pack_bf16(p0, p1);
      p[nt][1] = pack_bf16(p2, p3);
    }

    // O += P V for the warp's D / DSPLIT columns
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      const uint32_t a[4] = {p[2 * kt][0], p[2 * kt][1], p[2 * kt + 1][0],
                             p[2 * kt + 1][1]};
#pragma unroll
      for (int dt = 0; dt < DO / 8; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, sV + (kt * 16 + lo.a_row) * LDS + dcol0 + dt * 8 + lo.a_col);
        mma_bf16(o[dt], a, b[0], b[1]);
        mma_bf16(o[dt + 1], a, b[2], b[3]);
      }
    }
  }

  // each lane summed its own 2 of every 8 columns: finish the row sums
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
}
