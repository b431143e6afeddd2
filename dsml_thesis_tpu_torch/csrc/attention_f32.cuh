// fp32 attention at head width 512: the first stage's single-head AttnBlock
// (one head as wide as the channels) in first-stage training, where the
// model runs in fp32. What is left here of the first TF32 mma.sync design is
// shared by the kernels around it:
//   * the delta launch of both fp32 D = 512 backwards (bwd_delta_f32_kernel:
//     delta = rowsum(do * o), one warp a row), which hopper_wide_f32_bwd.cuh
//     launches before its TF32 wgmma grids;
//   * the pieces of the streaming backward's log-sum-exp launch
//     (flash_attention_streaming_bwd.cu: streaming_lse_f32_kernel, 64 query
//     rows of a q-tile against 16-row K tiles on mma.sync m16n8k8): padded
//     row tiles, the TF32 rounding (cvt.rna) as a tile is stored, ldmatrix,
//     the fragments and the quad reductions;
//   * the fragments, rounding and reductions that attention_f32_narrow.cuh
//     (fp32 D = 32) and conv_stats.cuh (fp32 pixel-patch conv) reuse.
// TF32 keeps 10 of fp32's 23 mantissa bits; every operand is rounded once,
// where it is stored, and softmax statistics, exponentials, delta and every
// sum are fp32.
//
// Fragments (lane = 4 g + t): A [16 x 8] holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B [8 x 8] holds (t, g), (t + 4, g); C [16 x 8]
// holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). Where a product's
// A operand is read from a score tile, the depth index is permuted inside
// each 8 (logical t -> 2t, t + 4 -> 2t + 1) on both operands, which leaves
// the sum unchanged. Rows are padded by 4 words: every fragment load of a
// 516-word row stride hits 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace f32attn {

constexpr int D = 512;         // the one head width of the fp32 kernels
constexpr int PADW = 4;        // words of row padding in shared memory
constexpr int LDS = D + PADW;  // row stride of a [rows][D] tile, in words
constexpr int FBM = 64;        // lse launch: query rows a block
constexpr int FBN = 16;        // lse launch: key rows a tile
constexpr float MASKED = -1e30f;   // the streaming kernels' masked score

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// raw fp32 bits times mul, rounded to TF32
__device__ __forceinline__ uint32_t tf32_mul(uint32_t raw, float mul) {
  return to_tf32(__uint_as_float(raw) * mul);
}

// four 8 x 8 matrices of 16-bit pairs from shared memory (a 32-bit value a
// thread each): a TF32 fragment of an 8 x 4-word block a matrix
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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

// Reduce a per-lane partial over the four lanes of a row (t = 0 .. 3).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

}  // namespace f32attn
