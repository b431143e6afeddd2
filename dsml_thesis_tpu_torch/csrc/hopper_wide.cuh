// The Hopper design of the bf16 attention forwards at head width 512 (the
// first stage's AttnBlock: one head of 512 channels over 4096 tokens at
// 256 px), shared by the split-head forward (flash_attention.cu, row 2) and
// the streaming forward (flash_attention_streaming.cu, row 4) through the
// STREAMING parameter.
//
// Bound: operations (4 * Nq * Nk * 512 a head against 2 * (2 Nq + 2 Nk) *
// 512 bytes). What limits a design is registers: the fp32 output of a
// 64-row tile is 64 x 512 x 4 = 128 KB, so one warpgroup cannot hold it.
//
// Design. A block owns 64 query rows of one (batch * head) and has two
// warpgroups; warpgroup w owns output columns [256 w, 256 w + 256), 128
// fp32 accumulators a thread. Every operand a warpgroup reads is its own
// half of the columns: q (64 KB for both halves, resident), and the K and V
// tiles of KEYS keys streamed through STAGES stages by cp.async completing
// on mbarriers of the warpgroup (a stage's K is refilled once the score
// product that read it retires, its V once P V retires). Each row of 512
// columns is held as eight 64-column panels of 128-byte rows under the
// 128-byte swizzle.
//   * S = q K^T once, split over the depth: each warpgroup runs wgmma
//     m64nKEYSk16 over its 256 columns (q and K from shared memory, K-major),
//     stores its partial S in fp32 to shared memory, and after a named
//     barrier of both adds the other's partial to its own. fp32 addition
//     commutes, so both hold the same bits of S, of the row maxima and of P:
//     the scores are formed once, not once a warpgroup.
//   * The online softmax is taken by both warpgroups alike on the whole S
//     (exp2 by ex2.approx); P, packed to bf16 in registers, is the A operand
//     of O += P V, wgmma m64n256k16 over the warpgroup's columns of V
//     (MN-major B spanning four panels).
//   * No atomics; equal inputs give equal bits.
//
// Arithmetic. Resident (row 2): scores in fp32 times scale * log2(e), keys
// past the end at -inf, running row maximum and row sum in fp32 of the fp32
// probabilities, P cast to bf16 for P V, one cast of o; the row log-sum-exp
// m * scale * log2(e) + log2(l) where asked for. STREAMING (row 4, the TPU
// streaming kernel's roundings): q times the bf16 factor scale * log2(e),
// rounded in bf16, once a block in shared memory; keys past the end at the
// finite -1e30 with probability exactly 0, the maximum starting at -1e30;
// the denominator the sum of the probabilities as cast to bf16; a split of
// the keys writes its fp32 partial output, maximum and sum for the combine
// launch of flash_attention_streaming.cu.
#pragma once

#include "hopper_tiles.cuh"

namespace {
namespace hwide {

using namespace hopper;

constexpr int D = 512;            // the head width
constexpr int ROWS = 64;          // query rows a block
constexpr int NT = 256;           // two warpgroups
constexpr int HALF = D / 2;       // output columns of a warpgroup
constexpr int PANELS = HALF / 64; // its 64-column panels of 128-byte rows

// The tiles: KEYS keys a K / V tile, STAGES stages. 64 / 1 (K, V and the
// exchange in 224 KB) against 32 / 2 (a two-stage ring in 208 KB): 0.639
// against 0.916 ms at [8, 1, 4096, 512] (row 2; row 4 0.692 against 0.926),
// tools/variants.py --wide-attn, H100 SXM at 700 W. The stage loop stays at
// one stage: the same code without it took 242 registers against 235 and
// read 4-12% slower on row 2 (the same tool and card, one call).
constexpr int KEYS = 64;
constexpr int STAGES = 1;

// Byte offsets in the block's shared memory (after 1024-byte alignment).
constexpr int Q_HALF = ROWS * 2 * HALF;    // a warpgroup's q columns
constexpr int KV_HALF = KEYS * 2 * HALF;   // its columns of a K or V tile
constexpr int X_HALF = ROWS * KEYS * 4;    // its partial S
constexpr int K_OFF = 2 * Q_HALF;
constexpr int V_OFF = K_OFF + STAGES * 2 * KV_HALF;
constexpr int X_OFF = V_OFF + STAGES * 2 * KV_HALF;
constexpr int BAR_OFF = X_OFF + 2 * X_HALF;
constexpr int BARS = 2 + 4 * STAGES;       // q, then K and V full, a half each
constexpr int SMEM = 1024 + BAR_OFF + BARS * 8;
static_assert(SMEM <= 232448, "shared memory of a block");

// Named barriers: the warpgroup's own (1 + w), both partials stored (3),
// warpgroup w's partial read by the other (4 + w).
constexpr int BAR_WG = 1, BAR_X_READY = 3, BAR_X_FREE = 4;

// The attention of block (blockIdx.x: batch * head and 64-row q-tile,
// blockIdx.y: split of the keys) over keys [split * keys_per_split, + that)
// of nk. Resident: factor = scale * log2(e), lse (or null) gets the row
// log-sum-exp, o the output. STREAMING: factor = scale * log2(e) rounded to
// bf16; with one split o gets the output, else part_o [splits, BH * Nq, D]
// and part_ml [splits, 2, BH * Nq] the split's unnormalised output, row
// maxima and row sums.
template <bool STREAMING>
__device__ __forceinline__ void attend(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ part_o, float* __restrict__ part_ml, int nq, int nk,
    int q_tiles, int keys_per_split, float factor) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sb = cvta(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + BAR_OFF);

  const int tid = threadIdx.x;
  const int w = tid >> 7;           // the warpgroup
  const int t = tid & 127;          // the thread in it
  const int lane = tid & 31;
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * ROWS;
  const int kv_begin = blockIdx.y * keys_per_split;
  const int kv_end = min(nk, kv_begin + keys_per_split);
  const int ntiles = (kv_end - kv_begin + KEYS - 1) / KEYS;
  const int col0 = w * HALF;
  const int64_t row_base = bh * nq + q0;  // of the tile's first row
  const bf16* kw = k + bh * nk * D + col0;
  const bf16* vw = v + bh * nk * D + col0;
  const uint32_t sq = sb + w * Q_HALF;
  uint64_t* qbar = bars + w;
  auto kfull = [&](int s) { return bars + 2 + 2 * s + w; };
  auto vfull = [&](int s) { return bars + 2 + 2 * STAGES + 2 * s + w; };
  auto kslot = [&](int s) { return sb + K_OFF + (2 * s + w) * KV_HALF; };
  auto vslot = [&](int s) { return sb + V_OFF + (2 * s + w) * KV_HALF; };

  if (tid == 0) {
    for (int i = 0; i < BARS; ++i) mbar_init(&bars[i], 128);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone arrives on them

  // this warpgroup's columns of the q-tile (the ragged last tile: rows past
  // nq are zeros and are not written back), then of the first K / V tiles
#pragma unroll
  for (int p = 0; p < PANELS; ++p)
    load_tile_async<128, ROWS, 128>(sq + p * ROWS * 128,
                                    q + row_base * D + col0 + 64 * p, D,
                                    nq - q0, t);
  cp_async_arrive(qbar);
  auto load_kv = [&](const bf16* src, uint32_t slot, uint64_t* bar, int i) {
    const int kv0 = kv_begin + i * KEYS;
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
      load_tile_async<128, KEYS, 128>(
          slot + p * KEYS * 128, src + static_cast<int64_t>(kv0) * D + 64 * p,
          D, kv_end - kv0, t);
    cp_async_arrive(bar);
  };
  for (int i = 0; i < STAGES && i < ntiles; ++i) {
    load_kv(kw, kslot(i), kfull(i), i);
    load_kv(vw, vslot(i), vfull(i), i);
  }

  mbar_wait(qbar, 0);
  if constexpr (STREAMING) {
    // q times the factor in bf16, in place (zeros stay zeros)
    const __nv_bfloat162 c2 = __float2bfloat162_rn(factor);
    uint4* qh = reinterpret_cast<uint4*>(base + w * Q_HALF);
    for (int i = t; i < Q_HALF / 16; i += 128) {
      uint4 x = qh[i];
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = __hmul2(h[e], c2);
      qh[i] = x;
    }
    fence_async_shared();
    bar_sync(BAR_WG + w, 128);  // the whole scaled half before wgmma reads it
  } else {
    fence_async_shared();
  }

  float acc[HALF / 2];
#pragma unroll
  for (int x = 0; x < HALF / 2; ++x) acc[x] = 0.f;
  float m0 = STREAMING ? -1e30f : -INFINITY, m1 = m0, l0 = 0.f, l1 = 0.f;
  float4* x_mine = reinterpret_cast<float4*>(base + X_OFF + w * X_HALF);
  const float4* x_other =
      reinterpret_cast<const float4*>(base + X_OFF + (1 - w) * X_HALF);
  const float softmax_scale = STREAMING ? 1.f : factor;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    mbar_wait(kfull(s), parity);
    fence_async_shared();
    float sc[KEYS / 2];  // this half's partial S = q K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HALF / 16; ++kk) {
      const int p = kk / 4, c = 32 * (kk % 4);
      wgmma_ss<KEYS, 0>(sc, desc_k<128>(sq + p * ROWS * 128 + c),
                        desc_k<128>(kslot(s) + p * KEYS * 128 + c), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    bar_sync(BAR_WG + w, 128);  // the warpgroup is done with this K stage
    if (j + STAGES < ntiles) load_kv(kw, kslot(s), kfull(s), j + STAGES);

    // S = this half's partial + the other's (the same bits in both)
    if (j > 0) bar_sync(BAR_X_FREE + w, 256);  // the other read it last time
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i)
      x_mine[i * 128 + t] =
          make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]);
    bar_sync(BAR_X_READY, 256);
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i) {
      const float4 y = x_other[i * 128 + t];
      sc[4 * i] += y.x;
      sc[4 * i + 1] += y.y;
      sc[4 * i + 2] += y.z;
      sc[4 * i + 3] += y.w;
    }
    if (j + 1 < ntiles) bar_arrive(BAR_X_FREE + (1 - w), 256);

    float alpha0, alpha1;
    softmax_scores<KEYS, STREAMING>(sc, m0, m1, alpha0, alpha1,
                                    kv_begin + j * KEYS, kv_end,
                                    softmax_scale, lane);
    uint32_t pa[KEYS / 16][4];  // P cast to bf16: the A operand of P V
#pragma unroll
    for (int kt = 0; kt < KEYS / 16; ++kt) acc_to_a<KEYS>(pa[kt], sc, kt);
    scale_rows<HALF>(acc, alpha0, alpha1);
    l0 *= alpha0;
    l1 *= alpha1;
    if constexpr (STREAMING) {  // the sums of the cast probabilities
#pragma unroll
      for (int kt = 0; kt < KEYS / 16; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&pa[kt][e]));
          if (e & 1)
            l1 += f.x + f.y;
          else
            l0 += f.x + f.y;
        }
    } else {
      add_row_sums<KEYS>(sc, l0, l1);
    }

    mbar_wait(vfull(s), parity);
    fence_async_shared();
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KEYS / 16; ++kt)  // k16 step kt: 16 rows in
      wgmma_rs<HALF, 1>(acc, pa[kt],
                        desc_mn_panels<128>(vslot(s) + kt * 16 * 128,
                                            KEYS * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    bar_sync(BAR_WG + w, 128);  // the warpgroup is done with this V stage
    if (j + STAGES < ntiles) load_kv(vw, vslot(s), vfull(s), j + STAGES);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  const int r0 = (t >> 5) * 16 + (lane >> 2), r1 = r0 + 8;
  const int c0 = 2 * (lane & 3);
  const bool ok0 = q0 + r0 < nq, ok1 = q0 + r1 < nq;
  if (!STREAMING || gridDim.y == 1) {
    if (!STREAMING && lse != nullptr && w == 0 && (lane & 3) == 0) {
      if (ok0) lse[row_base + r0] = m0 * factor + log2f(l0);
      if (ok1) lse[row_base + r1] = m1 * factor + log2f(l1);
    }
    const float inv0 = 1.f / (STREAMING ? fmaxf(l0, 1e-30f) : l0);
    const float inv1 = 1.f / (STREAMING ? fmaxf(l1, 1e-30f) : l1);
    bf16* orow = o + row_base * D + col0 + c0;
#pragma unroll
    for (int i = 0; i < HALF / 8; ++i) {
      if (ok0)
        *reinterpret_cast<uint32_t*>(orow + r0 * D + 8 * i) =
            pack2(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      if (ok1)
        *reinterpret_cast<uint32_t*>(orow + r1 * D + 8 * i) =
            pack2(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
    return;
  }
  // part_o [splits, BH * Nq, D], part_ml [splits, 2, BH * Nq]
  const int64_t rows = static_cast<int64_t>(gridDim.x / q_tiles) * nq;
  part_ml += blockIdx.y * 2 * rows + row_base;
  if (w == 0 && (lane & 3) == 0) {
    if (ok0) {
      part_ml[r0] = m0;
      part_ml[rows + r0] = l0;
    }
    if (ok1) {
      part_ml[r1] = m1;
      part_ml[rows + r1] = l1;
    }
  }
  float* prow = part_o + (blockIdx.y * rows + row_base) * D + col0 + c0;
#pragma unroll
  for (int i = 0; i < HALF / 8; ++i) {
    if (ok0)
      *reinterpret_cast<float2*>(prow + r0 * D + 8 * i) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
    if (ok1)
      *reinterpret_cast<float2*>(prow + r1 * D + 8 * i) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// Each caller defines its own __global__ kernel around attend<STREAMING>
// with __launch_bounds__(NT, 1), so that a profile names the row that
// launched it.

// Launches `kernel` (the caller's __global__ around attend) on bh * q-tiles
// x splits blocks. Returns the CUDA error of the launch (0 = launched).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int bh, int nq, int splits, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + ROWS - 1) / ROWS;
  kernel<<<dim3(bh * q_tiles, splits), NT, SMEM, stream>>>(args..., q_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hwide
}  // namespace
