// The Hopper design of the fp32 attention backwards at head width 512 (the
// first stage's AttnBlock in first-stage training), shared by the split-head
// backward (flash_attention_bwd.cu, row 7) and the streaming backward
// (flash_attention_streaming_bwd.cu, row 5, after its log-sum-exp launch).
//
// Bound: operations on the TF32 tensor cores, 10 * Nq * Nk * 512 a head (the
// scores S = q k^T and dP = do v^T, then dV = P^T do, dK = dS^T q and
// dQ = dS k). What limits a design at D = 512 is the register file: the
// fused backward keeps dK and dV of its key rows (64 x 512 fp32 each, the
// whole register file of an SM for the two) or dQ in registers while the
// scores contract over all 512 columns, so D has to be cut over the blocks
// of a cluster and every score step waits for the partial scores of the
// other blocks (an earlier pair of such blocks on mma.sync was one latency
// chain a step).
// Here the scores and the gradient products are separate grids of plain
// TF32 wgmma GEMMs, joined by the probabilities and the score gradients of
// a chunk of keys in scratch: no score is formed twice (the fused grids form
// them in both the dk/dv and the dq grid: 14 against 10 N^2 D), no block
// waits for another, and each product runs at full width from shared-memory
// operands. The price is the traffic of three [Nq, chunk] fp32 arrays a
// chunk, written once and read once, and the scratch they take:
// CHUNK_BUDGET_MB of it at most, the keys cut into chunks where a call needs
// more, so that memory stays linear in the sequence, as the streaming
// kernels promise.
//
// Launches a call, in stream order:
//   delta   rowsum(do * o) (attention_f32.cuh's bwd_delta_f32_kernel);
//   images  q (times q_mul), do, k and v rounded to TF32 once, as they lie
//           (the scores' operands) and, but v, transposed to
//           [BH][512][N padded to TILE] with zeros past Nq / Nk (the B
//           operands of the gradient products, whose contraction, queries
//           or keys, TF32 wgmma wants contiguous: it reads K-major operands
//           only);
//   then for each chunk of keys (one at the shipped shapes):
//   scores  a block (two warpgroups, 64 query rows each) a 128-query x
//           128-key tile: S = q k^T, then dP = do v^T, each 16 steps of 32
//           columns through a ring of S_STAGES cp.async stages; then
//           P = exp2(S scale_log2 - lse), 0 for a query past Nq or a key
//           past Nk, dS = P (dP - delta), both rounded to TF32 and written
//           as P^T and dS^T [BH][chunk][Nq pad] and dS [BH][Nq pad][chunk];
//   grads   one launch of three GEMMs (blockIdx.z): dV = P^T do,
//           dK = dK_mul dS^T q, dQ = scale dS k over the chunk (added to the
//           earlier chunks' dQ in chunk order); a block (two warpgroups) a
//           128-row x 256-column tile, m64n256k8 from G_STAGES stages.
// The operands reach the rings already rounded: rounding each stage in
// shared memory (a read and a write of every byte the tensor cores then
// read) left the scores grid paced by shared memory, 1.4x slower at
// [16, 1, 1024, 512], which cost more than the images launch's extra pass
// over HBM (tools/variants.py --f32-attn, H100 SXM at 700 W; PERF.md, the
// fp32 D = 512 backward readings).
// Both product grids keep one wgmma group in flight behind the loads: a
// stage is refilled only after a barrier that follows the wait retiring its
// reader in both warpgroups. Loads past the end are issued with zero size
// (no branch between a wgmma and its wait). No atomics; every sum is taken
// in a fixed order, so equal inputs give equal bits.
//
// Arithmetic (the plain versions': ops/attention.py
// flash_attention_bwd_reference, streaming_bwd_reference, and the fused
// grids this design replaces): every product operand is rounded to TF32
// (tf32_rna, cvt.rna's rounding) where it is stored; scores, exponentials,
// delta and every sum in fp32. Row 7: q_mul = 1, scale_log2 = scale *
// log2(e), dK_mul = scale. Row 5: q_mul = scale * log2(e) (the streaming
// forward's scaled q), scale_log2 = 1, dK_mul = scale / q_mul, lse its own
// launch's (keys past Nk there at -1e30 with probability 0).
#pragma once

#include "attention_f32.cuh"
#include "hopper_tf32.cuh"
#include "hopper_tiles.cuh"

namespace {
namespace hwide_f32_bwd {

using namespace hopper;

constexpr int D = 512;              // the head width
constexpr int TILE = 128;           // rows of a score / gradient tile
constexpr int BK = 32;              // columns a stage: 128-byte rows
constexpr int NT = 256;             // two warpgroups a block
constexpr int GN = 256;             // output columns of a gradient tile
constexpr int S_STAGES = 6;         // scores: stages of one A and one B tile
constexpr int G_STAGES = 4;         // grads: stages of A (128) and B (256)
constexpr int IMG_ROWS = 32;        // images: rows x columns of a block
constexpr int CHUNK_BUDGET_MB = 512;  // P^T, dS^T and dS of a key chunk
constexpr int ROW_TILE = TILE * 128;          // 128 rows of 128 bytes
constexpr int S_STAGE = 2 * ROW_TILE;
constexpr int G_STAGE = ROW_TILE + GN * 128;
constexpr int S_SMEM = 1024 + S_STAGES * S_STAGE;
constexpr int G_SMEM = 1024 + G_STAGES * G_STAGE;
static_assert(S_SMEM <= 232448 && G_SMEM <= 232448,
              "shared memory of a block");
constexpr int S_STEPS = D / BK;     // 32-column steps of one score product

inline int pad_rows(int n) {
  return (n + TILE - 1) / TILE * TILE;
}

// Keys of a chunk: as many whole tiles as keep P^T, dS^T and dS within
// CHUNK_BUDGET_MB, at least one tile, at most all of them.
inline int chunk_keys(int bh, int nqp, int nkp) {
  const int64_t per_key = 3ll * 4 * bh * nqp;
  int64_t c = (static_cast<int64_t>(CHUNK_BUDGET_MB) << 20) / per_key /
              TILE * TILE;
  if (c < TILE) c = TILE;
  if (c > nkp) c = nkp;
  return static_cast<int>(c);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float(tf32_rna(x));
}

// Copy rows x 32 fp32 (row i at src + i * ld) into a swizzled tile at dst;
// rows at or past valid, and everything when !live, are zeros and are not
// read.
template <int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src,
                                          int64_t ld, int valid, bool live,
                                          int t) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / NT; ++i) {
    const int x = t + i * NT;
    const int r = x >> 3, c = x & 7;
    const bool ok = live && r < valid;
    cp_async16(dst + Swz<128>::at(r, c), src + (ok ? r * ld + 4 * c : 0), ok);
  }
}

// images: blockIdx.z = head * IMAGES + (0: q times q_mul, 1: do, 2: k, 3: v),
// blockIdx.x the IMG_ROWS rows of the padded length, blockIdx.y the
// IMG_ROWS columns of d; 256 threads. Each is written rounded to TF32 as it
// lies ([BH][N][D], the scores' operands: rows [BH][Nq][D] q, then do, then
// [BH][Nk][D] k, then v) and, but v, transposed ([BH][D][N padded], zeros
// past N: the gradient products' B operands).
constexpr int IMAGES = 4;
__device__ __forceinline__ void images(const float* __restrict__ q,
                                       const float* __restrict__ dout,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       float* __restrict__ qt,
                                       float* __restrict__ dot,
                                       float* __restrict__ kt,
                                       float* __restrict__ rows, int nq,
                                       int nk, int nqp, int nkp, float q_mul) {
  __shared__ float tile[IMG_ROWS][IMG_ROWS + 1];
  const int which = blockIdx.z % IMAGES;
  const int64_t h = blockIdx.z / IMAGES, bh = gridDim.z / IMAGES;
  const int n = which >= 2 ? nk : nq, np = which >= 2 ? nkp : nqp;
  const int r0 = blockIdx.x * IMG_ROWS, d0 = blockIdx.y * IMG_ROWS;
  if (r0 >= np) return;
  const float* src =
      (which == 0 ? q : which == 1 ? dout : which == 2 ? k : v) + h * n * D;
  const float mul = which == 0 ? q_mul : 1.f;
  float* rm = rows + (which == 0   ? h * nq
                      : which == 1 ? (bh + h) * nq
                      : which == 2 ? 2 * bh * nq + h * nk
                                   : 2 * bh * nq + (bh + h) * nk) * D;
  const int tx = threadIdx.x % IMG_ROWS, ty = threadIdx.x / IMG_ROWS;
#pragma unroll
  for (int i = ty; i < IMG_ROWS; i += NT / IMG_ROWS) {
    const int r = r0 + i;
    const float x = r < n ? tf32_round(
                                src[static_cast<int64_t>(r) * D + d0 + tx] *
                                mul)
                          : 0.f;
    tile[i][tx] = x;
    if (r < n) rm[static_cast<int64_t>(r) * D + d0 + tx] = x;
  }
  if (which == 3) return;
  float* dst = (which == 0 ? qt : which == 1 ? dot : kt) + h * D * np;
  __syncthreads();
#pragma unroll
  for (int i = ty; i < IMG_ROWS; i += NT / IMG_ROWS)
    dst[static_cast<int64_t>(d0 + i) * np + r0 + tx] = tile[tx][i];
}

// scores: block (blockIdx.x: 128 queries, blockIdx.y: 128 keys of the
// chunk that starts at key c0, blockIdx.z: head) -> P^T, dS^T and dS of the
// tile (see the file's note).
__device__ __forceinline__ void scores(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ pt, float* __restrict__ dst, float* __restrict__ ds,
    int nq, int nk, int nqp, int chunk, int c0, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sb = cvta(base);
  const int t = threadIdx.x, wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int64_t h = blockIdx.z;
  const int q0 = blockIdx.x * TILE;
  const int kc = blockIdx.y * TILE;   // the tile's first key in the chunk
  const int key0 = c0 + kc;
  const float* qh = q + (h * nq + q0) * D;
  const float* doh = dout + (h * nq + q0) * D;
  const float* kh = k + (h * nk + key0) * D;
  const float* vh = v + (h * nk + key0) * D;
  const int qv = nq - q0, kv = nk - key0;   // valid rows, both >= 1

  // ring step s: 32 columns of (q, k) for S, then of (do, v) for dP, into
  // stage s % S_STAGES
  auto load = [&](int s) {
    const bool live = s < 2 * S_STEPS;
    const int sc = min(s, 2 * S_STEPS - 1);
    const int k0 = (sc % S_STEPS) * BK;
    const uint32_t st = sb + (s % S_STAGES) * S_STAGE;
    load_rows<TILE>(st, (sc < S_STEPS ? qh : doh) + k0, D, qv, live, t);
    load_rows<TILE>(st + ROW_TILE, (sc < S_STEPS ? kh : vh) + k0, D, kv, live,
                    t);
    cp_commit();
  };
  float sacc[TILE / 2], dpacc[TILE / 2];
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) sacc[i] = dpacc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < S_STAGES - 2; ++s) load(s);
  // stage s: its copies landed, the stage S_STAGES - 2 ahead
  // refilled (its last reader, step s - 2, retired in both warpgroups
  // before the barrier), then the four k8 steps of the product with one
  // group left in flight
  auto step = [&](int s, float (&acc)[TILE / 2]) {
    cp_wait<S_STAGES - 3>();
    fence_async_shared();
    __syncthreads();
    load(s + S_STAGES - 2);
    const uint32_t sa = sb + (s % S_STAGES) * S_STAGE + wg * (ROW_TILE / 2);
    const uint32_t sbt = sb + (s % S_STAGES) * S_STAGE + ROW_TILE;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
      wgmma_tf32_ss<TILE>(acc, desc_k<128>(sa + 32 * c),
                          desc_k<128>(sbt + 32 * c), 1);
    wgmma_commit();
    wgmma_wait<1>();
  };
  for (int s = 0; s < S_STEPS; ++s) step(s, sacc);
  for (int s = S_STEPS; s < 2 * S_STEPS; ++s) step(s, dpacc);
  wgmma_wait<0>();
  fence_regs(sacc);
  fence_regs(dpacc);

  // P and dS of rows r0 and r0 + 8, keys 8 j + 2 (lane % 4) + {0, 1}
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const bool in0 = r0 < nq, in1 = r1 < nq;
  const float lse0 = in0 ? lse[h * nq + r0] : 0.f;
  const float lse1 = in1 ? lse[h * nq + r1] : 0.f;
  const float del0 = in0 ? delta[h * nq + r0] : 0.f;
  const float del1 = in1 ? delta[h * nq + r1] : 0.f;
  float* pth = pt + h * chunk * nqp;
  float* dsth = dst + h * chunk * nqp;
  float* dsh = ds + h * nqp * chunk;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    const int c = kc + 8 * j + 2 * (lane & 3);   // column of the chunk
    float p[4], g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = (e < 2 ? in0 : in1) && c0 + c + (e & 1) < nk;
      const float x = exp2f(sacc[4 * j + e] * scale_log2 - (e < 2 ? lse0 : lse1));
      const float pe = live ? x : 0.f;
      p[e] = __uint_as_float(tf32_rna(pe));
      g[e] = __uint_as_float(
          tf32_rna(pe * (dpacc[4 * j + e] - (e < 2 ? del0 : del1))));
    }
    *reinterpret_cast<float2*>(dsh + static_cast<int64_t>(r0) * chunk + c) =
        make_float2(g[0], g[1]);
    *reinterpret_cast<float2*>(dsh + static_cast<int64_t>(r1) * chunk + c) =
        make_float2(g[2], g[3]);
    const int64_t a0 = static_cast<int64_t>(c) * nqp;
    pth[a0 + r0] = p[0];
    pth[a0 + nqp + r0] = p[1];
    pth[a0 + r1] = p[2];
    pth[a0 + nqp + r1] = p[3];
    dsth[a0 + r0] = g[0];
    dsth[a0 + nqp + r0] = g[1];
    dsth[a0 + r1] = g[2];
    dsth[a0 + nqp + r1] = g[3];
  }
}

// One 128 x 256 tile of C = alpha A B^T (+ C where accumulate): A [M][K] at
// its first row (row stride lda), B [N][K] at its first row (ldb), C at the
// tile's corner (row stride D); K a multiple of BK, every operand row read
// in range and already TF32; rows at or past m_valid are not written.
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a,
                                          int64_t lda,
                                          const float* __restrict__ b,
                                          int64_t ldb, int kdim,
                                          float* __restrict__ c, int m_valid,
                                          float alpha, bool accumulate) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sb = cvta(base);
  const int t = threadIdx.x, wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int steps = kdim / BK;
  auto load = [&](int s) {
    const bool live = s < steps;
    const int k0 = min(s, steps - 1) * BK;
    const uint32_t st = sb + (s % G_STAGES) * G_STAGE;
    load_rows<TILE>(st, a + k0, lda, TILE, live, t);
    load_rows<GN>(st + ROW_TILE, b + k0, ldb, GN, live, t);
    cp_commit();
  };
  float acc[GN / 2];
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < G_STAGES - 2; ++s) load(s);
  for (int s = 0; s < steps; ++s) {
    cp_wait<G_STAGES - 3>();
    fence_async_shared();
    __syncthreads();
    load(s + G_STAGES - 2);
    const uint32_t st = sb + (s % G_STAGES) * G_STAGE;
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < BK / 8; ++k8)
      wgmma_tf32_ss<GN>(acc, desc_k<128>(st + wg * (ROW_TILE / 2) + 32 * k8),
                        desc_k<128>(st + ROW_TILE + 32 * k8), 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const int r0 = wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < GN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    float2 x0 = make_float2(acc[4 * j] * alpha, acc[4 * j + 1] * alpha);
    float2 x1 = make_float2(acc[4 * j + 2] * alpha, acc[4 * j + 3] * alpha);
    float2* p0 = reinterpret_cast<float2*>(c + static_cast<int64_t>(r0) * D +
                                           col);
    float2* p1 = reinterpret_cast<float2*>(c + static_cast<int64_t>(r1) * D +
                                           col);
    if (r0 < m_valid) {
      if (accumulate) {
        const float2 y = *p0;
        x0 = make_float2(y.x + x0.x, y.y + x0.y);
      }
      *p0 = x0;
    }
    if (r1 < m_valid) {
      if (accumulate) {
        const float2 y = *p1;
        x1 = make_float2(y.x + x1.x, y.y + x1.y);
      }
      *p1 = x1;
    }
  }
}

// grads: blockIdx.z 0 dV, 1 dK (rows: the chunk's cw keys, contraction over
// the padded queries), 2 dQ (rows: the padded queries, contraction over the
// chunk's keys, added to the earlier chunks' dQ); blockIdx.y the head,
// blockIdx.x the row tile * 2 + the column half. Blocks past a product's
// row tiles return at once.
__device__ __forceinline__ void grads(
    const float* __restrict__ pt, const float* __restrict__ dst,
    const float* __restrict__ ds, const float* __restrict__ dot,
    const float* __restrict__ qt, const float* __restrict__ kt,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    int nq, int nk, int nqp, int nkp, int chunk, int c0, int cw, float scale,
    float dk_mul) {
  const int which = blockIdx.z;
  const int64_t h = blockIdx.y;
  const int m0 = (blockIdx.x >> 1) * TILE, n0 = (blockIdx.x & 1) * GN;
  if (which < 2) {
    if (m0 >= cw) return;
    gemm_tile((which == 0 ? pt : dst) + (h * chunk + m0) * nqp, nqp,
              (which == 0 ? dot : qt) + (h * D + n0) * nqp, nqp, nqp,
              (which == 0 ? dv : dk) + (h * nk + c0 + m0) * D + n0,
              nk - c0 - m0, which == 0 ? 1.f : dk_mul, false);
  } else {
    if (m0 >= nqp) return;
    gemm_tile(ds + (h * nqp + m0) * chunk, chunk,
              kt + (h * D + n0) * nkp + c0, nkp, cw,
              dq + (h * nq + m0) * D + n0, nq - m0, scale, c0 > 0);
  }
}

// Each caller defines its own __global__ kernels around images
// (__launch_bounds__(NT)), scores and grads (__launch_bounds__(NT, 1)), so
// that a profile names the row that launched them.

// delta, the images, then scores and grads a chunk of keys, on the caller's
// stream; scratch holds the three images and one chunk's P^T, dS^T and dS,
// bh * (512 * (2 Nq + Nk) + 3 * chunk * Nq) floats at the padded lengths
// (ops/attention.py:wide_f32_bwd_plan); lse the row log-sum-exp in the scores' base-2 domain. Returns the
// CUDA error of the first launch that failed (0 = all launched), or -1 for
// an empty shape or no scratch.
template <typename... PI, typename... PS, typename... PG>
int launch(void (*images_k)(PI...), void (*scores_k)(PS...),
           void (*grads_k)(PG...), const float* q, const float* k,
           const float* v, const float* o, const float* dout,
           const float* lse, float* delta, float* dq, float* dk, float* dv,
           float* scratch, int bh, int nq, int nk, float scale_log2,
           float q_mul, float scale, float dk_mul, cudaStream_t stream) {
  if (bh < 1 || nq < 1 || nk < 1 || scratch == nullptr) return -1;
  const int nqp = pad_rows(nq), nkp = pad_rows(nk);
  const int chunk = chunk_keys(bh, nqp, nkp);
  float* qt = scratch;
  float* dot = qt + static_cast<int64_t>(bh) * D * nqp;
  float* kt = dot + static_cast<int64_t>(bh) * D * nqp;
  float* pt = kt + static_cast<int64_t>(bh) * D * nkp;
  float* dst = pt + static_cast<int64_t>(bh) * chunk * nqp;
  float* ds = dst + static_cast<int64_t>(bh) * chunk * nqp;
  float* rows = ds + static_cast<int64_t>(bh) * chunk * nqp;
  const float* qr = rows;
  const float* dor = qr + static_cast<int64_t>(bh) * nq * D;
  const float* kr = dor + static_cast<int64_t>(bh) * nq * D;
  const float* vr = kr + static_cast<int64_t>(bh) * nk * D;
  cudaError_t err = cudaFuncSetAttribute(
      scores_k, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(grads_k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t qrows = static_cast<int64_t>(bh) * nq;
  f32attn::bwd_delta_f32_kernel<<<static_cast<unsigned>((qrows + 7) / 8), 256,
                                  0, stream>>>(o, dout, delta, qrows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  images_k<<<dim3((nqp > nkp ? nqp : nkp) / IMG_ROWS, D / IMG_ROWS,
                  bh * IMAGES),
             NT, 0, stream>>>(q, dout, k, v, qt, dot, kt, rows, nq, nk, nqp,
                              nkp, q_mul);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int c0 = 0; c0 < nkp; c0 += chunk) {
    const int cw = chunk < nkp - c0 ? chunk : nkp - c0;
    scores_k<<<dim3(nqp / TILE, cw / TILE, bh), NT, S_SMEM, stream>>>(
        qr, kr, vr, dor, lse, delta, pt, dst, ds, nq, nk, nqp, chunk, c0,
        scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    grads_k<<<dim3((cw > nqp ? cw : nqp) / TILE * 2, bh, 3), NT, G_SMEM, stream>>>(
        pt, dst, ds, dot, qt, kt, dq, dk, dv, nq, nk, nqp, nkp, chunk, c0, cw,
        scale, dk_mul);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace hwide_f32_bwd
}  // namespace
