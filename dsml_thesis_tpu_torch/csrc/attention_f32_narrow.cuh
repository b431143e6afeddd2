// fp32 attention at head width 32: the UNet of mead-128-ldm-f4.yaml, which
// sets no dtype and so computes in fp32 (in the JAX package too), with
// 32-wide heads at N = 1024, 256 and 64. Device code of the fp32 D = 32
// instantiations:
//   flash_attention_packed.cu     forward + row log-sum-exp, packed rows,
//                                 where Nq and Nk are at most 64 (longer
//                                 rows: hopper_narrow_f32.cuh)
//   flash_attention.cu            the same on split heads (heads = 1),
//                                 likewise
//   flash_attention_bwd_packed.cu delta, dk/dv grid, dq grid, packed rows,
//                                 likewise
//   flash_attention_bwd.cu        the same on split heads (heads = 1),
//                                 likewise
//   flash_attention_streaming.cu  the streaming forward on split heads
//                                 (stream_block: K / V cut over splits)
//                                 where Nq and Nk are at most 64 (longer
//                                 rows: hopper_narrow_f32.cuh)
//   flash_attention_streaming_bwd.cu  its row log-sum-exp (lse_block), then
//                                 the backward's grids on split heads,
//                                 likewise
//
// Rows: a head h of batch b is addressed by base pointer + h * 32 with a row
// stride ld (H * 32 on packed rows, 32 on split heads), so no head-split
// copy exists.
//
// Products on the tensor cores in TF32 (mma.sync m16n8k8, fp32 accumulate;
// attention_f32.cuh's fragment helpers): every operand is rounded to TF32
// (cvt.rna) once, where it is stored in shared memory or loaded into the
// registers it is used from (q, k, v, do) or formed there (p, ds). Softmax statistics, exponentials, delta and every sum are fp32.
//
// What shapes the design: a fp32 row of 32 is 128 bytes, so one warp holds a
// 16-row slab of a head as four TF32 A fragments (16 registers) and a whole
// product over the head's depth is four k8 steps. No operand but the
// streamed tiles needs shared memory:
//   * forward (fwd_block): a block of 4 warps owns 64 query rows of one head
//     (16 a warp, q in registers); 64-key K / V tiles stream through two
//     cp.async stages in shared memory (37 KB); S = q K^T, the online softmax
//     in the base-2 domain and O += P V with P kept in the registers it was
//     formed in (its depth permuted inside each 8, as attention_f32.cuh
//     does). The row log-sum-exp is m + log2(l) with m the maximum of
//     s * scale * log2(e): the domain of hopper_fwd.cuh, which the backward
//     reads. The streaming forward (stream_block) runs the same key loop
//     (attend_keys) with that kernel's roundings: q times scale * log2(e) in
//     fp32 before its TF32 rounding (so the scores are base-2 as formed),
//     keys past nk at the finite -1e30 with probability 0, the denominator
//     the sum of the probabilities as used in P V (the streaming kernel's
//     cast to v's type is the identity in fp32), over one split of the keys.
//   * backward: hopper_bwd.cuh's three launches (no atomics: equal inputs
//     give equal bits). delta = rowsum(do o), one thread a (row, head); a
//     grid over 64-key tiles (dkdv_block: K and V of a warp's 16 keys in
//     registers, 64-row q / do tiles streamed) writes dk / dv once; a grid
//     over 64-query tiles (dq_block: q and do in registers, K / V tiles
//     streamed) writes dq once. Both form S^T (or S) and dP^T (or dP) on the
//     tensor cores, p and ds in registers, and update their 16 x 32 slabs.
//
// Bound on the H100: operations on the TF32 tensor cores (4 N^2 D a head
// forward, 10 N^2 D backward, against 16 N D and 32 N D bytes): at D = 32 a
// score costs 64 (forward) or 160 (backward) multiply-adds and one exp2, so
// the special-function unit weighs as much as the products.
#pragma once

#include "attention_f32.cuh"

namespace {
namespace f32narrow {

using f32attn::frag_a;
using f32attn::frag_b_kn_perm;
using f32attn::frag_b_nk;
using f32attn::lane_g;
using f32attn::lane_t;
using f32attn::mma_tf32;
using f32attn::quad_max;
using f32attn::quad_sum;
using f32attn::to_tf32;

constexpr int D = 32;          // the head width
constexpr int LD = D + 4;      // words of a shared-memory row: fragment loads
                               // of a 36-word stride hit 32 distinct banks
constexpr int ROWS = 64;       // rows a block owns (16 a warp)
constexpr int TILE = 64;       // rows of a streamed tile
constexpr int NT = 128;        // threads a block
constexpr int TILE_WORDS = TILE * LD;
constexpr int CHUNKS = TILE * D / 4 / NT;  // 16-byte chunks a thread copies

__device__ __forceinline__ void cp_async16(uint32_t* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copy of a [TILE][D] fp32 tile (row stride ld in device memory)
// into s ([TILE][LD] words); rows at or past valid are zero-filled.
__device__ __forceinline__ void issue_tile(uint32_t* s, const float* g,
                                           int64_t ld, int valid) {
#pragma unroll
  for (int x = 0; x < CHUNKS; ++x) {
    const int i = threadIdx.x + x * NT;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = r < valid;
    cp_async16(s + r * LD + c, ok ? g + r * ld + c : g, ok);
  }
}

// After cp_async_wait_all: round the chunks this thread copied into s, each
// value times mul in fp32 first, to TF32 in place (a __syncthreads then makes
// the tile visible to the block).
__device__ __forceinline__ void round_tile(uint32_t* s, float mul = 1.f) {
#pragma unroll
  for (int x = 0; x < CHUNKS; ++x) {
    const int i = threadIdx.x + x * NT;
    uint4* p = reinterpret_cast<uint4*>(s + (i / (D / 4)) * LD +
                                        (i % (D / 4)) * 4);
    const uint4 v = *p;
    *p = make_uint4(to_tf32(__uint_as_float(v.x) * mul),
                    to_tf32(__uint_as_float(v.y) * mul),
                    to_tf32(__uint_as_float(v.z) * mul),
                    to_tf32(__uint_as_float(v.w) * mul));
  }
}

// The A fragments (4 k8 steps over the head's 32 columns) of rows r0 ..
// r0 + 15 of a row-major fp32 operand in device memory (row stride ld),
// times mul in fp32, rounded to TF32; rows at or past valid are zeros.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4],
                                            const float* g, int64_t ld,
                                            int r0, int valid,
                                            float mul = 1.f) {
  const int r = r0 + lane_g();
  const bool ok0 = r < valid, ok1 = r + 8 < valid;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 8 + lane_t();
    a[kk][0] = ok0 ? to_tf32(g[r * ld + c] * mul) : 0u;
    a[kk][1] = ok1 ? to_tf32(g[(r + 8) * ld + c] * mul) : 0u;
    a[kk][2] = ok0 ? to_tf32(g[r * ld + c + 4] * mul) : 0u;
    a[kk][3] = ok1 ? to_tf32(g[(r + 8) * ld + c + 4] * mul) : 0u;
  }
}

// s[8][4] = A[16 x 32] B[64 rows of a [TILE][LD] tile]^T: 64 columns.
__device__ __forceinline__ void scores_16x64(float (&s)[8][4],
                                             const uint32_t (&a)[4][4],
                                             const uint32_t* sb) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b0, b1;
      frag_b_nk(b0, b1, sb, LD, nt * 8, kk * 8);
      mma_tf32(s[nt], a[kk], b0, b1);
    }
}

// A C fragment of 16 x 8 (columns = the depth of the next product) as the
// TF32 A operand with its depth permuted (logical t -> 2t, t + 4 -> 2t + 1).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[4]) {
  a[0] = to_tf32(c[0]);
  a[1] = to_tf32(c[2]);
  a[2] = to_tf32(c[1]);
  a[3] = to_tf32(c[3]);
}

// acc[4][4] (16 rows x 32 columns) += P[16 x 64] B[64 rows of a tile]:
// p in C fragments, B stored [k][n] (rows = the 64-long depth).
__device__ __forceinline__ void update_16x32(float (&acc)[4][4],
                                             const float (&p)[8][4],
                                             const uint32_t* sb) {
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    uint32_t a[4];
    c_to_a(a, p[kt]);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      uint32_t b0, b1;
      frag_b_kn_perm(b0, b1, sb, LD, kt * 8, dt * 8);
      mma_tf32(acc[dt], a, b0, b1);
    }
  }
}

// Store the warp's 16 x 32 slab (rows r0 + g, r0 + g + 8) times mul0 /
// mul1 to rows below valid of a row-major fp32 tensor of row stride ld.
__device__ __forceinline__ void store_16x32(float* g, int64_t ld, int r0,
                                            int valid,
                                            const float (&acc)[4][4],
                                            float mul0, float mul1) {
  const int r = r0 + lane_g();
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int c = dt * 8 + 2 * lane_t();
    if (r < valid)
      *reinterpret_cast<float2*>(g + r * ld + c) =
          make_float2(acc[dt][0] * mul0, acc[dt][1] * mul0);
    if (r + 8 < valid)
      *reinterpret_cast<float2*>(g + (r + 8) * ld + c) =
          make_float2(acc[dt][2] * mul1, acc[dt][3] * mul1);
  }
}

__device__ __forceinline__ void zero_16x32(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

struct Smem2 {   // two stages of two streamed tiles
  uint32_t t[2][2][TILE_WORDS];
};
static_assert(sizeof(Smem2) <= 48 * 1024, "static shared memory");

// ------------------------------------------------------------- forward ---

constexpr float MASKED = -1e30f;   // the streaming kernels' masked score

// Issue the copies of the K / V tile of the keys kv0 .. kv0 + 63 of a head
// (row stride ld) into stage st; keys at or past kv_end are zero-filled.
__device__ __forceinline__ void issue_kv(Smem2& sm, int st, const float* k,
                                         const float* v, int64_t ld, int kv0,
                                         int kv_end) {
  issue_tile(sm.t[st][0], k + kv0 * ld, ld, kv_end - kv0);
  issue_tile(sm.t[st][1], v + kv0 * ld, ld, kv_end - kv0);
  cp_async_commit();
}

// The online softmax of a warp's 16 query rows (qa, TF32 A fragments) over
// the keys [kv_begin, kv_end) of a head in 64-key tiles, whose first tile the
// caller has issued into stage 0: acc (unnormalised output), the row maxima
// m0 / m1 and the row sums l0 / l1 (of the fp32 probabilities), in the base-2
// domain. Resident (STREAMING = false): scores times scale_log2, keys past
// kv_end at -inf. STREAMING: q carries the factor, so the scores are used as
// formed; keys past kv_end at the finite -1e30 with probability 0, the
// maximum starting there.
template <bool STREAMING>
__device__ __forceinline__ void attend_keys(const uint32_t (&qa)[4][4],
                                            const float* k, const float* v,
                                            int64_t ldkv, int kv_begin,
                                            int kv_end, float scale_log2,
                                            Smem2& sm, float (&acc)[4][4],
                                            float& m0, float& m1, float& l0,
                                            float& l1) {
  const int t = lane_t();
  const int tiles = (kv_end - kv_begin + TILE - 1) / TILE;
  zero_16x32(acc);
  m0 = m1 = STREAMING ? MASKED : -INFINITY;
  l0 = l1 = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int st = j & 1;
    cp_async_wait_all();
    round_tile(sm.t[st][0]);
    round_tile(sm.t[st][1]);
    __syncthreads();  // tile j visible; every warp is done with tile j - 1
    const int kv0 = kv_begin + j * TILE;
    if (j + 1 < tiles) issue_kv(sm, st ^ 1, k, v, ldkv, kv0 + TILE, kv_end);
    float s[8][4];
    scores_16x64(s, qa, sm.t[st][0]);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kv0 + nt * 8 + 2 * t + (e & 1) < kv_end;
        if (STREAMING)
          s[nt][e] = ok ? s[nt][e] : MASKED;
        else
          s[nt][e] = ok ? s[nt][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
    // p = exp2(s - max), summed in fp32: 0 for a key past kv_end (exp2(-inf)
    // when resident, explicitly when streaming)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - (e < 2 ? m0 : m1));
        s[nt][e] = STREAMING && kv0 + nt * 8 + 2 * t + (e & 1) >= kv_end
                       ? 0.f : p;
      }
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    update_16x32(acc, s, sm.t[st][1]);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
}

// Block (b, q-tile, head), heads adjacent in the grid: 64 query rows of one
// head against all nk keys. q / o at row stride ldq / ldo, k / v at ldkv;
// lse (if not null) is [B, H, nq].
__device__ __forceinline__ void fwd_block(const float* q, const float* k,
                                          const float* v, float* o,
                                          float* lse, int64_t ldq,
                                          int64_t ldkv, int64_t ldo, int nq,
                                          int nk, int heads, int q_tiles,
                                          float scale_log2) {
  __shared__ __align__(16) Smem2 sm;
  const int h = blockIdx.x % heads;
  const int qt = (blockIdx.x / heads) % q_tiles;
  const int64_t b = blockIdx.x / (heads * q_tiles);
  const int q0 = qt * ROWS;
  q += (b * nq + q0) * ldq + h * D;
  o += (b * nq + q0) * ldo + h * D;
  k += b * nk * ldkv + h * D;
  v += b * nk * ldkv + h * D;
  const int t = lane_t();
  const int r0 = (threadIdx.x >> 5) * 16;

  issue_kv(sm, 0, k, v, ldkv, 0, nk);
  uint32_t qa[4][4];
  load_a_rows(qa, q, ldq, r0, nq - q0);
  float acc[4][4], m0, m1, l0, l1;
  attend_keys<false>(qa, k, v, ldkv, 0, nk, scale_log2, sm, acc, m0, m1, l0,
                     l1);
  const int valid = nq - q0;
  if (lse != nullptr && t == 0) {
    float* row = lse + (b * heads + h) * nq + q0 + r0 + lane_g();
    if (r0 + lane_g() < valid) row[0] = m0 + log2f(l0);
    if (r0 + lane_g() + 8 < valid) row[8] = m1 + log2f(l1);
  }
  store_16x32(o, ldo, r0, valid, acc, 1.f / l0, 1.f / l1);
}

// The streaming forward on split heads ([BH, N, 32], row stride 32): block
// (bh, q-tile) in blockIdx.x, the split of the keys in blockIdx.y, each split
// keys_per_split keys (a multiple of 64). q times q_scale (scale * log2(e)
// in fp32) before its TF32 rounding. With one split the block normalises and
// writes o; otherwise it writes its unnormalised fp32 output to part_o
// [splits, BH * nq, 32] and its row maximum and sum to part_ml
// [splits, 2, BH * nq] for the combine launch.
__device__ __forceinline__ void stream_block(const float* q, const float* k,
                                             const float* v, float* o,
                                             float* part_o, float* part_ml,
                                             int nq, int nk, int q_tiles,
                                             int keys_per_split,
                                             float q_scale) {
  __shared__ __align__(16) Smem2 sm;
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * ROWS;
  const int kv_begin = blockIdx.y * keys_per_split;
  const int kv_end = min(nk, kv_begin + keys_per_split);
  const int64_t row_base = bh * nq + q0;  // of this tile's first row
  k += bh * nk * D;
  v += bh * nk * D;
  const int r0 = (threadIdx.x >> 5) * 16;

  issue_kv(sm, 0, k, v, D, kv_begin, kv_end);
  uint32_t qa[4][4];
  load_a_rows(qa, q + row_base * D, D, r0, nq - q0, q_scale);
  float acc[4][4], m0, m1, l0, l1;
  attend_keys<true>(qa, k, v, D, kv_begin, kv_end, 1.f, sm, acc, m0, m1, l0,
                    l1);
  const int valid = nq - q0;
  if (gridDim.y == 1) {
    store_16x32(o + row_base * D, D, r0, valid, acc, 1.f / fmaxf(l0, 1e-30f),
                1.f / fmaxf(l1, 1e-30f));
    return;
  }
  const int64_t rows = static_cast<int64_t>(gridDim.x / q_tiles) * nq;
  part_ml += blockIdx.y * 2 * rows + row_base;
  if (lane_t() == 0) {
    const int r = r0 + lane_g();
    if (r < valid) {
      part_ml[r] = m0;
      part_ml[rows + r] = l0;
    }
    if (r + 8 < valid) {
      part_ml[r + 8] = m1;
      part_ml[rows + r + 8] = l1;
    }
  }
  store_16x32(part_o + (blockIdx.y * rows + row_base) * D, D, r0, valid, acc,
              1.f, 1.f);
}

// The streaming backward's row log-sum-exp on split heads: block (bh,
// q-tile), q times q_scale in fp32 before its TF32 rounding, 64-key K tiles
// through two cp.async stages, the scores as the forward (stream_block) and
// the dq grid (dq_block with q_mul = q_scale) form them: the same
// instructions on the same rounded operands. lse[bh * nq + n] = m +
// log2(max(l, 1e-30)) in the base-2 domain, keys past nk at -1e30 with
// probability 0.
__device__ __forceinline__ void lse_block(const float* q, const float* k,
                                          float* lse, int nq, int nk,
                                          int q_tiles, float q_scale) {
  __shared__ __align__(16) Smem2 sm;
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * ROWS;
  const int64_t row_base = bh * nq + q0;
  k += bh * nk * D;
  const int t = lane_t();
  const int r0 = (threadIdx.x >> 5) * 16;
  const int tiles = (nk + TILE - 1) / TILE;

  issue_tile(sm.t[0][0], k, D, nk);
  cp_async_commit();
  uint32_t qa[4][4];
  load_a_rows(qa, q + row_base * D, D, r0, nq - q0, q_scale);
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const int st = j & 1;
    cp_async_wait_all();
    round_tile(sm.t[st][0]);
    __syncthreads();  // tile j visible; every warp is done with tile j - 1
    const int kv0 = j * TILE;
    if (j + 1 < tiles) {
      issue_tile(sm.t[st ^ 1][0], k + (kv0 + TILE) * D, D, nk - kv0 - TILE);
      cp_async_commit();
    }
    float s[8][4];
    scores_16x64(s, qa, sm.t[st][0]);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kv0 + nt * 8 + 2 * t + (e & 1) >= nk) s[nt][e] = MASKED;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    l0 *= exp2f(m0 - mx0);
    l1 *= exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = kv0 + nt * 8 + 2 * t + (e & 1) < nk
                            ? exp2f(s[nt][e] - (e < 2 ? m0 : m1)) : 0.f;
        (e < 2 ? l0 : l1) += p;
      }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    const int r = r0 + lane_g();
    if (r < nq - q0) lse[row_base + r] = m0 + log2f(fmaxf(l0, 1e-30f));
    if (r + 8 < nq - q0) lse[row_base + r + 8] = m1 + log2f(fmaxf(l1, 1e-30f));
  }
}

// grid size and launch of a forward kernel wrapping fwd_block
template <typename Kernel>
int launch_fwd(Kernel kernel, const float* q, const float* k, const float* v,
               float* o, float* lse, int b, int nq, int nk, int heads,
               int64_t ldq, int64_t ldkv, int64_t ldo, float scale,
               cudaStream_t stream) {
  if (b < 1 || nq < 1 || nk < 1 || heads < 1) return -1;
  const int q_tiles = (nq + ROWS - 1) / ROWS;
  kernel<<<b * q_tiles * heads, NT, 0, stream>>>(
      q, k, v, o, lse, ldq, ldkv, ldo, nq, nk, heads, q_tiles,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ backward ---

// delta[(b * H + h) * nq + n] = sum_c o[b, n, h * D + c] do[b, n, h * D + c]
// on packed rows of H heads; one thread a (row, head), columns in order.
__global__ void __launch_bounds__(256)
delta_f32_narrow_kernel(const float* __restrict__ o,
                        const float* __restrict__ dout,
                        float* __restrict__ delta, int64_t rows, int nq,
                        int heads) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= rows * heads) return;
  const int h = static_cast<int>(i % heads);
  const int64_t row = i / heads;   // b * nq + n
  const float4* a = reinterpret_cast<const float4*>(o + i * D);
  const float4* c = reinterpret_cast<const float4*>(dout + i * D);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float4 x = a[j], y = c[j];
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  delta[(row / nq * heads + h) * nq + row % nq] = acc;
}

// Block (b, key tile, head): dk / dv of 64 key rows of one head, every query
// row of the head streamed in 64-row tiles. All operands at row stride ld.
// The scores are (q q_mul) k^T scale_log2 in the base-2 domain of lse (q_mul
// = 1 after the resident forward; the streaming backward pre-scales q by
// scale * log2(e) with scale_log2 = 1), and dk = dS^T (q q_mul) dk_mul.
__device__ __forceinline__ void dkdv_block(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv, int64_t ld,
    int nq, int nk, int heads, int kv_tiles, float scale_log2, float q_mul,
    float dk_mul) {
  __shared__ __align__(16) Smem2 sm;
  __shared__ float s_stat[2][2][TILE];   // [stage][lse, delta][query]
  const int h = blockIdx.x % heads;
  const int kt = (blockIdx.x / heads) % kv_tiles;
  const int64_t b = blockIdx.x / (heads * kv_tiles);
  const int kv0 = kt * ROWS;
  const int64_t kv_off = (b * nk + kv0) * ld + h * D;
  const int64_t q_off = b * nq * ld + h * D;
  q += q_off;
  dout += q_off;
  lse += (b * heads + h) * nq;
  delta += (b * heads + h) * nq;
  const int warp = threadIdx.x >> 5;
  const int t = lane_t();
  const int r0 = warp * 16;
  const int tid = threadIdx.x;

  auto issue = [&](int j, int st) {
    const int q1 = j * TILE;
    issue_tile(sm.t[st][0], q + q1 * ld, ld, nq - q1);
    issue_tile(sm.t[st][1], dout + q1 * ld, ld, nq - q1);
    cp_async_commit();
    if (tid < TILE) {
      const bool ok = q1 + tid < nq;
      s_stat[st][0][tid] = ok ? lse[q1 + tid] : 0.f;
      s_stat[st][1][tid] = ok ? delta[q1 + tid] : 0.f;
    }
  };
  const int tiles = (nq + TILE - 1) / TILE;
  issue(0, 0);
  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, k + kv_off, ld, r0, nk - kv0);
  load_a_rows(va, v + kv_off, ld, r0, nk - kv0);
  float dka[4][4], dva[4][4];
  zero_16x32(dka);
  zero_16x32(dva);

  for (int j = 0; j < tiles; ++j) {
    const int st = j & 1;
    cp_async_wait_all();
    round_tile(sm.t[st][0], q_mul);
    round_tile(sm.t[st][1]);
    __syncthreads();  // tile j visible; every warp is done with tile j - 1
    if (j + 1 < tiles) issue(j + 1, st ^ 1);
    const int q1 = j * TILE;
    float s[8][4], dp[8][4];
    scores_16x64(s, ka, sm.t[st][0]);    // S^T = K Q^T
    scores_16x64(dp, va, sm.t[st][1]);   // dP^T = V dO^T
    // P^T = exp2(S^T scale_log2 - lse[q]), dS^T = P^T (dP^T - delta[q]); a
    // query past nq gives 0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const float p = q1 + c < nq
                            ? exp2f(s[nt][e] * scale_log2 - s_stat[st][0][c])
                            : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - s_stat[st][1][c]);
      }
    update_16x32(dva, s, sm.t[st][1]);    // dV += P^T dO
    update_16x32(dka, dp, sm.t[st][0]);   // dK += dS^T Q
  }
  store_16x32(dk + kv_off, ld, r0, nk - kv0, dka, dk_mul, dk_mul);
  store_16x32(dv + kv_off, ld, r0, nk - kv0, dva, 1.f, 1.f);
}

// Block (b, query tile, head): dq of 64 query rows of one head, every key
// row streamed in 64-row tiles; scores as in dkdv_block, dq = dS k scale.
__device__ __forceinline__ void dq_block(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dq, int64_t ld, int nq,
    int nk, int heads, int q_tiles, float scale_log2, float q_mul,
    float scale) {
  __shared__ __align__(16) Smem2 sm;
  const int h = blockIdx.x % heads;
  const int qt = (blockIdx.x / heads) % q_tiles;
  const int64_t b = blockIdx.x / (heads * q_tiles);
  const int q0 = qt * ROWS;
  const int64_t q_off = (b * nq + q0) * ld + h * D;
  k += b * nk * ld + h * D;
  v += b * nk * ld + h * D;
  const int warp = threadIdx.x >> 5;
  const int t = lane_t();
  const int r0 = warp * 16;
  const int valid = nq - q0;

  const int tiles = (nk + TILE - 1) / TILE;
  issue_tile(sm.t[0][0], k, ld, nk);
  issue_tile(sm.t[0][1], v, ld, nk);
  cp_async_commit();
  uint32_t qa[4][4], da[4][4];
  load_a_rows(qa, q + q_off, ld, r0, valid, q_mul);
  load_a_rows(da, dout + q_off, ld, r0, valid);
  const int64_t stat = (b * heads + h) * nq + q0 + r0 + lane_g();
  const bool ok0 = r0 + lane_g() < valid, ok1 = r0 + lane_g() + 8 < valid;
  const float lse0 = ok0 ? lse[stat] : 0.f, lse1 = ok1 ? lse[stat + 8] : 0.f;
  const float dl0 = ok0 ? delta[stat] : 0.f, dl1 = ok1 ? delta[stat + 8] : 0.f;
  float dqa[4][4];
  zero_16x32(dqa);

  for (int j = 0; j < tiles; ++j) {
    const int st = j & 1;
    cp_async_wait_all();
    round_tile(sm.t[st][0]);
    round_tile(sm.t[st][1]);
    __syncthreads();
    if (j + 1 < tiles) {
      const int kv1 = (j + 1) * TILE;
      issue_tile(sm.t[st ^ 1][0], k + kv1 * ld, ld, nk - kv1);
      issue_tile(sm.t[st ^ 1][1], v + kv1 * ld, ld, nk - kv1);
      cp_async_commit();
    }
    const int kv0 = j * TILE;
    float s[8][4], dp[8][4];
    scores_16x64(s, qa, sm.t[st][0]);    // S = Q K^T
    scores_16x64(dp, da, sm.t[st][1]);   // dP = dO V^T
    // dS = P (dP - delta), P = exp2(S scale_log2 - lse); a key past nk is
    // outside the softmax and gives 0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kv0 + nt * 8 + 2 * t + (e & 1) < nk;
        const float p =
            ok ? exp2f(s[nt][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1));
      }
    update_16x32(dqa, dp, sm.t[st][0]);   // dQ += dS K
  }
  store_16x32(dq + q_off, ld, r0, valid, dqa, scale, scale);
}

// delta, then the dk/dv grid, then the dq grid on the caller's stream, for
// kernels wrapping dkdv_block and dq_block (scale_log2, q_mul, dk_mul as
// there; dq_mul = scale); lse is the [B, H, nq] row log-sum-exp. Returns
// cudaGetLastError() of the first launch that failed (0 = all launched) or
// -1 for an empty shape.
template <typename DkdvKernel, typename DqKernel>
int launch_bwd(DkdvKernel dkdv, DqKernel dqk, const float* q, const float* k,
               const float* v, const float* o, const float* dout,
               const float* lse, float* delta, float* dq, float* dk, float* dv,
               int b, int nq, int nk, int heads, float scale_log2, float q_mul,
               float dk_mul, float dq_mul, cudaStream_t stream) {
  if (b < 1 || nq < 1 || nk < 1 || heads < 1) return -1;
  const int64_t ld = static_cast<int64_t>(heads) * D;
  const int64_t rows = static_cast<int64_t>(b) * nq;
  delta_f32_narrow_kernel<<<static_cast<unsigned>(
                                (rows * heads + 255) / 256),
                            256, 0, stream>>>(o, dout, delta, rows, nq, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles = (nk + ROWS - 1) / ROWS;
  dkdv<<<b * kv_tiles * heads, NT, 0, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, ld, nq, nk, heads, kv_tiles,
      scale_log2, q_mul, dk_mul);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + ROWS - 1) / ROWS;
  dqk<<<b * q_tiles * heads, NT, 0, stream>>>(
      q, k, v, dout, lse, delta, dq, ld, nq, nk, heads, q_tiles, scale_log2,
      q_mul, dq_mul);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32narrow
}  // namespace
