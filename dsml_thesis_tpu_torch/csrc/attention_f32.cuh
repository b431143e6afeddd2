// fp32 attention at head width 512: the first stage's single-head AttnBlock
// (one head as wide as the channels) in first-stage training, where the
// model runs in fp32. Device code of the four fp32 instantiations:
//   flash_attention.cu            forward + row log-sum-exp (flash_fwd_f32)
//   flash_attention_streaming.cu  the streaming forward's roundings (same
//                                 kernel, STREAMING = true)
//   flash_attention_bwd.cu        delta, dk/dv grid, dq grid
//   flash_attention_streaming_bwd.cu  the same with the log-sum-exp launch
//                                 and q pre-scaled (PRESCALED = true)
//
// Products on the tensor cores in TF32 (mma.sync m16n8k8, fp32 accumulate):
// every operand is rounded to TF32 (cvt.rna) once, where it is stored in
// shared memory (q, k, v, do) or formed in registers (p, ds). TF32 keeps 10
// of fp32's 23 mantissa bits; the card's TF32 rate is 7.4 times its fp32 rate
// outside the tensor cores (494.7 against 67 TFLOP/s dense), and the result
// stays within the 2e-2 of the maximum every attention kernel is held to.
// Softmax statistics, exponentials, delta and every sum are fp32.
//
// What shapes the design is shared memory, not registers: one fp32 row of
// 512 is 2 KB, so a 64-row tile is 132 KB of the block's 227 KB.
//   * forward: 64 query rows a block (132 KB), K / V tiles of 16 rows (33 KB
//     each), 8 warps: two per 16-row group, each accumulating 256 of the 512
//     output columns (128 registers a thread), both forming the group's
//     scores (1.5x the products of the function, as the bf16 design).
//   * backward: the three-launch structure of attention_bwd.cuh (delta, a
//     grid over key tiles writing dk / dv once, a grid over query tiles
//     writing dq once; no atomics, equal inputs give equal bits), with D cut
//     over the 8 warps of a block: warp w owns depth columns 64w .. 64w+63.
//     For a 32 x 16 step it forms the partial sums of S^T (or S) and dP^T
//     (or dP) over its 64 columns and parks them in shared memory; p and ds
//     are formed elementwise from the eight partials added in warp order, and
//     every warp reads them back as the A operand of the product that
//     updates its 64 columns of dk / dv (or dq) for the block's 32 rows (128
//     registers a thread). Shared memory traffic, not the tensor cores, is
//     what bounds these kernels: every operand reaches a warp by 32-bit
//     loads.
//
// Fragments (lane = 4 g + t): A [16 x 8] holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B [8 x 8] holds (t, g), (t + 4, g); C [16 x 8]
// holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). Where a product's
// A operand is a C fragment (p in the forward) or is read from a score tile,
// the depth index is permuted inside each 8 (logical t -> 2t, t + 4 ->
// 2t + 1) on both operands, which leaves the sum unchanged and lets p stay in
// the registers it was formed in. Rows are padded by 4 words: every fragment
// load of a 516-word row stride hits 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace f32attn {

constexpr int D = 512;         // the one head width of the fp32 kernels
constexpr int PADW = 4;        // words of row padding in shared memory
constexpr int LDS = D + PADW;  // row stride of a [rows][D] tile, in words
constexpr int FBM = 64;        // forward: query rows a block
constexpr int FBN = 16;        // forward: key rows a tile
constexpr int FDSPLIT = 2;     // forward: warps sharing a 16-row group
constexpr int BIG = 32;        // backward: rows a block owns
constexpr int SMALL = 16;      // backward: rows of a streamed tile
constexpr int NWARPS = 8;      // backward: warps a block, 64 depth columns each
constexpr int PART = 2 * BIG * SMALL;  // words of one warp's partial S and dP
constexpr float MASKED = -1e30f;   // the streaming kernels' masked score

constexpr int fwd_smem_bytes() {
  return (FBM + 2 * FBN) * LDS * static_cast<int>(sizeof(uint32_t));
}
constexpr int lse_smem_bytes() {
  return (FBM + FBN) * LDS * static_cast<int>(sizeof(uint32_t));
}
constexpr int bwd_smem_bytes() {
  return (2 * BIG + 2 * SMALL) * LDS * static_cast<int>(sizeof(uint32_t)) +
         NWARPS * PART * static_cast<int>(sizeof(uint32_t)) +
         2 * BIG * static_cast<int>(sizeof(float));
}
static_assert(bwd_smem_bytes() <= 232448, "a Hopper block's shared memory");

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c[16 x 8] += a[16 x 8] * b[8 x 8], TF32 operands, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A of rows r0 .. r0 + 15, depth k0 .. k0 + 7 of a row-major tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint32_t* s,
                                       int ld, int r0, int k0) {
  const uint32_t* p = s + (r0 + lane_g()) * ld + k0 + lane_t();
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// The same with the depth permuted (logical t -> 2t, t + 4 -> 2t + 1).
__device__ __forceinline__ void frag_a_perm(uint32_t (&a)[4], const uint32_t* s,
                                            int ld, int r0, int k0) {
  const uint32_t* p = s + (r0 + lane_g()) * ld + k0 + 2 * lane_t();
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[1];
  a[3] = p[8 * ld + 1];
}

// B of a tile stored [n][k] (a key tile in Q K^T): columns n0 .. n0 + 7,
// depth k0 .. k0 + 7.
__device__ __forceinline__ void frag_b_nk(uint32_t& b0, uint32_t& b1,
                                          const uint32_t* s, int ld, int n0,
                                          int k0) {
  const uint32_t* p = s + (n0 + lane_g()) * ld + k0 + lane_t();
  b0 = p[0];
  b1 = p[4];
}

// B of a tile stored [k][n] (V in P V), depth permuted as frag_a_perm.
__device__ __forceinline__ void frag_b_kn_perm(uint32_t& b0, uint32_t& b1,
                                               const uint32_t* s, int ld,
                                               int k0, int n0) {
  const uint32_t* p = s + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  b0 = p[0];
  b1 = p[ld];
}

// Copy rows x D fp32 from device memory (row stride D) into a padded tile of
// TF32 values, each multiplied by mul in fp32 first; rows at or past
// valid_rows are zeros and are not read.
template <int NTHREADS>
__device__ __forceinline__ void load_tile_tf32(uint32_t* s, const float* g,
                                               int rows, int valid_rows,
                                               int tid, float mul = 1.f) {
  constexpr int CHUNKS = D / 4;
  for (int i = tid; i < rows * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid_rows)
      v = *reinterpret_cast<const float4*>(g + static_cast<int64_t>(r) * D + c);
    *reinterpret_cast<uint4*>(s + r * LDS + c) =
        make_uint4(to_tf32(v.x * mul), to_tf32(v.y * mul), to_tf32(v.z * mul),
                   to_tf32(v.w * mul));
  }
}

// s[16 x 16] = A[rows r0 .., D] B[16 rows, D]^T of two [.][LDS] tiles.
__device__ __forceinline__ void scores_16x16(float (&s)[2][4],
                                             const uint32_t* sA, int r0,
                                             const uint32_t* sB) {
#pragma unroll
  for (int i = 0; i < 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t a[4];
    frag_a(a, sA, LDS, r0, kk);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t b0, b1;
      frag_b_nk(b0, b1, sB, LDS, nt * 8, kk);
      mma_tf32(s[nt], a, b0, b1);
    }
  }
}

// Reduce a per-lane partial over the four lanes of a row (t = 0 .. 3).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Forward of one block: 64 query rows of one head against the keys
// [kv_begin, kv_end). Resident (STREAMING = false): q as given, scores times
// mul = scale * log2(e), keys past nk at -inf. STREAMING: q times mul =
// scale * log2(e) in fp32 before the product, keys past nk at the finite
// -1e30 with probability 0. On return acc holds the warp's unnormalised
// output (256 columns from dcol0), l0 / l1 the row sums (of the fp32
// probabilities: the streaming kernel's cast to v's type is the identity in
// fp32) and m0 / m1 the row maxima, in the base-2 domain.
template <bool STREAMING>
__device__ __forceinline__ void fwd_rows(const float* q, const float* k,
                                         const float* v, int valid_q, int nk,
                                         int kv_begin, int kv_end, float mul,
                                         uint32_t* smem,
                                         float (&acc)[D / FDSPLIT / 8][4],
                                         float& m0, float& m1, float& l0,
                                         float& l1) {
  constexpr int NT = 128 * FDSPLIT;
  constexpr int DO = D / FDSPLIT;
  uint32_t* sQ = smem;
  uint32_t* sK = sQ + FBM * LDS;
  uint32_t* sV = sK + FBN * LDS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int t = lane_t();
  const int row0 = (warp / FDSPLIT) * 16;
  const int dcol0 = (warp % FDSPLIT) * DO;

  load_tile_tf32<NT>(sQ, q, FBM, valid_q, tid, STREAMING ? mul : 1.f);
#pragma unroll
  for (int i = 0; i < DO / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  m0 = m1 = STREAMING ? MASKED : -INFINITY;
  l0 = l1 = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += FBN) {
    __syncthreads();  // the previous tile's readers are done; sQ is visible
    load_tile_tf32<NT>(sK, k + static_cast<int64_t>(kv0) * D, FBN, nk - kv0,
                       tid);
    load_tile_tf32<NT>(sV, v + static_cast<int64_t>(kv0) * D, FBN, nk - kv0,
                       tid);
    __syncthreads();

    float s[2][4];
    scores_16x16(s, sQ, row0, sK);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kv0 + nt * 8 + 2 * t + (j & 1) < nk;
        if (STREAMING)
          s[nt][j] = ok ? s[nt][j] : MASKED;
        else
          s[nt][j] = ok ? s[nt][j] * mul : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int i = 0; i < DO / 8; ++i) {
      acc[i][0] *= alpha0;
      acc[i][1] *= alpha0;
      acc[i][2] *= alpha1;
      acc[i][3] *= alpha1;
    }

    // p = exp2(s - max) (0 for a masked key), summed in fp32; as the A
    // operand of p V it stays in the C fragment's registers
    uint32_t pa[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = kv0 + nt * 8 + 2 * t + (j & 1) < nk;
        p[j] = ok ? exp2f(s[nt][j] - (j < 2 ? m0 : m1)) : 0.f;
      }
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      pa[nt][0] = to_tf32(p[0]);
      pa[nt][1] = to_tf32(p[2]);
      pa[nt][2] = to_tf32(p[1]);
      pa[nt][3] = to_tf32(p[3]);
    }
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
      for (int dt = 0; dt < DO / 8; ++dt) {
        uint32_t b0, b1;
        frag_b_kn_perm(b0, b1, sV, LDS, kt * 8, dcol0 + dt * 8);
        mma_tf32(acc[dt], pa[kt], b0, b1);
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
}

// Write the warp's forward output fragment (rows g and g + 8 of its group,
// its 256 columns) times inv0 / inv1 to rows below valid_rows of a
// [rows][D] fp32 tensor.
__device__ __forceinline__ void store_fwd_rows(float* o, int valid_rows,
                                               const float (&acc)[D / FDSPLIT /
                                                                  8][4],
                                               float inv0, float inv1) {
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / FDSPLIT) * 16 + lane_g();
  const int r1 = r0 + 8;
  const int col0 = (warp % FDSPLIT) * (D / FDSPLIT) + 2 * lane_t();
#pragma unroll
  for (int dt = 0; dt < D / FDSPLIT / 8; ++dt) {
    const int col = col0 + dt * 8;
    if (r0 < valid_rows)
      *reinterpret_cast<float2*>(o + static_cast<int64_t>(r0) * D + col) =
          make_float2(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < valid_rows)
      *reinterpret_cast<float2*>(o + static_cast<int64_t>(r1) * D + col) =
          make_float2(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

namespace {

// delta[row] = sum_d o[row, d] * do[row, d]; one warp a row, lanes in a
// fixed order.
__global__ void __launch_bounds__(256)
bwd_delta_f32_kernel(const float* __restrict__ o,
                     const float* __restrict__ dout, float* __restrict__ delta,
                     int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 4; c < D; c += 128) {
    const float4 a = *reinterpret_cast<const float4*>(o + row * D + c);
    const float4 b = *reinterpret_cast<const float4*>(dout + row * D + c);
    acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

}  // namespace

// The warp's share of a 32 x 16 score step: the partial sums over depth
// columns 64w .. 64w + 63 of S = A0 B0^T and dP = A1 B1^T (A a [32][LDS]
// tile, B a [16][LDS] one), parked in the warp's slot of ``part``: S at
// [0, BIG * SMALL), dP after it, both [BIG][SMALL] row-major.
__device__ __forceinline__ void partial_scores(const uint32_t* sA0,
                                               const uint32_t* sB0,
                                               const uint32_t* sA1,
                                               const uint32_t* sB1,
                                               uint32_t* part) {
  const int warp = threadIdx.x >> 5;
  float s[2][2][4], dp[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[mt][nt][j] = dp[mt][nt][j] = 0.f;
#pragma unroll
  for (int kk = warp * 64; kk < warp * 64 + 64; kk += 8) {
    uint32_t a0[2][4], a1[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      frag_a(a0[mt], sA0, LDS, mt * 16, kk);
      frag_a(a1[mt], sA1, LDS, mt * 16, kk);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t b0, b1, c0, c1;
      frag_b_nk(b0, b1, sB0, LDS, nt * 8, kk);
      frag_b_nk(c0, c1, sB1, LDS, nt * 8, kk);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_tf32(s[mt][nt], a0[mt], b0, b1);
        mma_tf32(dp[mt][nt], a1[mt], c0, c1);
      }
    }
  }
  uint32_t* out = part + warp * PART;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int at = (mt * 16 + lane_g()) * SMALL + nt * 8 + 2 * lane_t();
      out[at] = __float_as_uint(s[mt][nt][0]);
      out[at + 1] = __float_as_uint(s[mt][nt][1]);
      out[at + 8 * SMALL] = __float_as_uint(s[mt][nt][2]);
      out[at + 8 * SMALL + 1] = __float_as_uint(s[mt][nt][3]);
      out[BIG * SMALL + at] = __float_as_uint(dp[mt][nt][0]);
      out[BIG * SMALL + at + 1] = __float_as_uint(dp[mt][nt][1]);
      out[BIG * SMALL + at + 8 * SMALL] = __float_as_uint(dp[mt][nt][2]);
      out[BIG * SMALL + at + 8 * SMALL + 1] = __float_as_uint(dp[mt][nt][3]);
    }
}

// Element i of a score step: the eight warps' partials of S and dP added in
// warp order.
__device__ __forceinline__ void sum_partials(const uint32_t* part, int i,
                                             float& s, float& dp) {
  s = dp = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    s += __uint_as_float(part[w * PART + i]);
    dp += __uint_as_float(part[w * PART + BIG * SMALL + i]);
  }
}

// acc[2][8] (32 rows, the warp's 64 columns) += A[32 x 16] B[16 x D], A a
// [BIG][SMALL] tile of TF32 values in shared memory, B a [SMALL][LDS] tile;
// each B fragment serves both 16-row halves.
__device__ __forceinline__ void slice_update(float (&acc)[2][8][4],
                                             const uint32_t* sA,
                                             const uint32_t* sB) {
  const int col0 = (threadIdx.x >> 5) * 64;
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    uint32_t a[2][4];
    frag_a_perm(a[0], sA, SMALL, 0, kt * 8);
    frag_a_perm(a[1], sA, SMALL, 16, kt * 8);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t b0, b1;
      frag_b_kn_perm(b0, b1, sB, LDS, kt * 8, col0 + n * 8);
      mma_tf32(acc[0][n], a[0], b0, b1);
      mma_tf32(acc[1][n], a[1], b0, b1);
    }
  }
}

// Write the warp's 32 x 64 slice times mul to rows below valid_rows of a
// [rows][D] fp32 tensor.
__device__ __forceinline__ void store_slice(float* g, int valid_rows,
                                            const float (&acc)[2][8][4],
                                            float mul) {
  const int col0 = (threadIdx.x >> 5) * 64 + 2 * lane_t();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = mt * 16 + lane_g();
    const int r1 = r0 + 8;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = col0 + n * 8;
      if (r0 < valid_rows)
        *reinterpret_cast<float2*>(g + static_cast<int64_t>(r0) * D + col) =
            make_float2(acc[mt][n][0] * mul, acc[mt][n][1] * mul);
      if (r1 < valid_rows)
        *reinterpret_cast<float2*>(g + static_cast<int64_t>(r1) * D + col) =
            make_float2(acc[mt][n][2] * mul, acc[mt][n][3] * mul);
    }
  }
}

__device__ __forceinline__ void zero_slice(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
}

// dk and dv of 32 key/value rows of one head (q / dout / lse / delta at the
// head's first query row, k / v / dk / dv at the block's first key row).
// Scores are formed from q times q_mul (PRESCALED: scale * log2(e), as the
// streaming forward forms them) and times scale_log2 after the product
// (1 when PRESCALED); dk leaves the block times dk_mul (scale, or
// scale / q_mul when the stored q carries the factor).
__device__ __forceinline__ void dkdv_block(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv, int nq,
    int kv_valid, float scale_log2, float q_mul, float dk_mul,
    uint32_t* smem) {
  constexpr int NT = 256;
  uint32_t* sK = smem;
  uint32_t* sV = sK + BIG * LDS;
  uint32_t* sQ = sV + BIG * LDS;
  uint32_t* sdO = sQ + SMALL * LDS;
  // the warps' partial S^T and dP^T [key][query]; the first slot then holds
  // P^T and dS^T
  uint32_t* part = sdO + SMALL * LDS;
  float* sLse = reinterpret_cast<float*>(part + NWARPS * PART);
  float* sDelta = sLse + SMALL;
  const int tid = threadIdx.x;

  load_tile_tf32<NT>(sK, k, BIG, kv_valid, tid);
  load_tile_tf32<NT>(sV, v, BIG, kv_valid, tid);
  float dka[2][8][4], dva[2][8][4];
  zero_slice(dka);
  zero_slice(dva);

  for (int q0 = 0; q0 < nq; q0 += SMALL) {
    __syncthreads();  // the previous step's readers are done
    load_tile_tf32<NT>(sQ, q + static_cast<int64_t>(q0) * D, SMALL, nq - q0,
                       tid, q_mul);
    load_tile_tf32<NT>(sdO, dout + static_cast<int64_t>(q0) * D, SMALL,
                       nq - q0, tid);
    if (tid < SMALL) {
      const bool ok = q0 + tid < nq;
      sLse[tid] = ok ? lse[q0 + tid] : 0.f;
      sDelta[tid] = ok ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();  // also makes sK / sV visible on the first round
    partial_scores(sK, sQ, sV, sdO, part);   // S^T = K Q^T, dP^T = V dO^T
    __syncthreads();
    // P^T = exp2(S^T scale_log2 - lse[q]), dS^T = P^T (dP^T - delta[q]); a
    // query past nq gives 0. Each element is read and rewritten by one thread.
    for (int i = tid; i < BIG * SMALL; i += NT) {
      const int c = i % SMALL;
      float st, dpt;
      sum_partials(part, i, st, dpt);
      const float p =
          q0 + c < nq ? exp2f(st * scale_log2 - sLse[c]) : 0.f;
      part[i] = to_tf32(p);
      part[BIG * SMALL + i] = to_tf32(p * (dpt - sDelta[c]));
    }
    __syncthreads();
    slice_update(dva, part, sdO);                // dV += P^T dO
    slice_update(dka, part + BIG * SMALL, sQ);   // dK += dS^T Q
  }
  store_slice(dk, kv_valid, dka, dk_mul);
  store_slice(dv, kv_valid, dva, 1.f);
}

// dq of 32 query rows of one head (q / dout / dq / lse / delta at the block's
// first query row, k / v at the head's first key row); scores as dkdv_block.
__device__ __forceinline__ void dq_block(const float* q, const float* k,
                                         const float* v, const float* dout,
                                         const float* lse, const float* delta,
                                         float* dq, int q_valid, int nk,
                                         float scale_log2, float q_mul,
                                         float scale, uint32_t* smem) {
  constexpr int NT = 256;
  uint32_t* sQ = smem;
  uint32_t* sdO = sQ + BIG * LDS;
  uint32_t* sK = sdO + BIG * LDS;
  uint32_t* sV = sK + SMALL * LDS;
  // the warps' partial S and dP [query][key]; the first slot's dP then
  // holds dS
  uint32_t* part = sV + SMALL * LDS;
  float* sLse = reinterpret_cast<float*>(part + NWARPS * PART);
  float* sDelta = sLse + BIG;
  const int tid = threadIdx.x;

  load_tile_tf32<NT>(sQ, q, BIG, q_valid, tid, q_mul);
  load_tile_tf32<NT>(sdO, dout, BIG, q_valid, tid);
  if (tid < BIG) {
    const bool ok = tid < q_valid;
    sLse[tid] = ok ? lse[tid] : 0.f;
    sDelta[tid] = ok ? delta[tid] : 0.f;
  }
  float dqa[2][8][4];
  zero_slice(dqa);

  for (int kv0 = 0; kv0 < nk; kv0 += SMALL) {
    __syncthreads();  // the previous step's readers are done
    load_tile_tf32<NT>(sK, k + static_cast<int64_t>(kv0) * D, SMALL, nk - kv0,
                       tid);
    load_tile_tf32<NT>(sV, v + static_cast<int64_t>(kv0) * D, SMALL, nk - kv0,
                       tid);
    __syncthreads();  // also makes sQ / sdO / the statistics visible
    partial_scores(sQ, sK, sdO, sV, part);   // S = Q K^T, dP = dO V^T
    __syncthreads();
    // dS = P (dP - delta), P = exp2(S scale_log2 - lse); a key past nk is
    // outside the softmax and gives 0
    for (int i = tid; i < BIG * SMALL; i += NT) {
      const int r = i / SMALL;
      float s, dp;
      sum_partials(part, i, s, dp);
      const float p =
          kv0 + i % SMALL < nk ? exp2f(s * scale_log2 - sLse[r]) : 0.f;
      part[BIG * SMALL + i] = to_tf32(p * (dp - sDelta[r]));
    }
    __syncthreads();
    slice_update(dqa, part + BIG * SMALL, sK);   // dQ += dS K
  }
  store_slice(dq, q_valid, dqa, scale);
}

namespace {

__global__ void __launch_bounds__(256)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int nq, int nk, int kv_tiles,
                    float scale_log2, float q_mul, float dk_mul) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bh = blockIdx.x / kv_tiles;
  const int kv0 = (blockIdx.x % kv_tiles) * BIG;
  const int64_t q_off = bh * nq * D;
  const int64_t kv_off = (bh * nk + kv0) * D;
  dkdv_block(q + q_off, k + kv_off, v + kv_off, dout + q_off, lse + bh * nq,
             delta + bh * nq, dk + kv_off, dv + kv_off, nq, nk - kv0,
             scale_log2, q_mul, dk_mul, reinterpret_cast<uint32_t*>(smem_raw));
}

__global__ void __launch_bounds__(256)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int nq, int nk, int q_tiles, float scale_log2, float q_mul,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BIG;
  const int64_t q_off = (bh * nq + q0) * D;
  const int64_t kv_off = bh * nk * D;
  dq_block(q + q_off, k + kv_off, v + kv_off, dout + q_off,
           lse + bh * nq + q0, delta + bh * nq + q0, dq + q_off, nq - q0, nk,
           scale_log2, q_mul, scale, reinterpret_cast<uint32_t*>(smem_raw));
}

// delta, then the dk/dv grid over 32-row key tiles, then the dq grid over
// 32-row query tiles, on the caller's stream; lse is the row log-sum-exp in
// the scores' base-2 domain. Returns cudaGetLastError() of the first launch
// that failed (0 = all launched) or -1 for an empty shape.
int launch_bwd_f32(const float* q, const float* k, const float* v,
                   const float* o, const float* dout, const float* lse,
                   float* delta, float* dq, float* dk, float* dv, int bh,
                   int nq, int nk, float scale_log2, float q_mul, float scale,
                   float dk_mul, cudaStream_t stream) {
  if (bh < 1 || nq < 1 || nk < 1) return -1;
  const int smem = bwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dq_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(bh) * nq;
  bwd_delta_f32_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                         stream>>>(o, dout, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles = (nk + BIG - 1) / BIG;
  bwd_dkdv_f32_kernel<<<bh * kv_tiles, 256, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, nq, nk, kv_tiles, scale_log2, q_mul,
      dk_mul);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + BIG - 1) / BIG;
  bwd_dq_f32_kernel<<<bh * q_tiles, 256, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, nq, nk, q_tiles, scale_log2, q_mul,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace f32attn
