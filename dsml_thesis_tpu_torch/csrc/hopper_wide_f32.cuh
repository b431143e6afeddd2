// The Hopper design of the fp32 attention forwards at head width 512 (the
// first stage's AttnBlock in fp32: first-stage training, and the frozen
// encodes and decodes of mead-128-ldm-f4), shared by the split-head forward
// (flash_attention.cu, row 2) and the streaming forward
// (flash_attention_streaming.cu, row 4) through the STREAMING parameter.
//
// Bound: operations on the TF32 tensor cores (4 * Nq * Nk * 512 a head
// against 4 * (2 Nq + 2 Nk) * 512 bytes). What limits a design is shared
// memory: a 64-row fp32 q-tile is 128 KB, and TF32 wgmma reads its
// shared-memory operands K-major only, so P V needs V^T ([d][key]); and every
// 64-row q-tile reads all of K and V from L2 (1 GB at [16, 1, 1024, 512]).
//
// Two launches a call:
//   (1) prep_tile: K rounded to TF32, and V^T rounded to TF32 with the keys
//       permuted inside each 8 (so that P stays in the accumulator's
//       registers as the A operand: hopper_tf32.cuh), each written as the
//       image of a shared-memory tile (swizzled; keys past Nk zeros) into
//       scratch the wrapper allocates (ops/attention.py:wide_f32_plan). K and
//       V are rounded and transposed once a call here instead of once a
//       q-tile in (2), and (2) copies a tile as it lies.
//   (2) attend: a cluster of two blocks owns 64 query rows of one
//       (batch * head); block w (its rank) owns depth and output columns
//       [256 w, + 256), one warpgroup, 128 fp32 accumulators a thread. Its
//       half of q (64 KB, rounded and for STREAMING scaled once in shared
//       memory), of a 64-key K tile and of that tile's V^T (64 KB each) and
//       two buffers of the other block's partial scores (16 KB each) fill its
//       shared memory: one stage of K and V^T.
//   * S = q K^T once, split over the depth: a block runs 32 TF32 wgmma
//     m64n64k8 over its 256 columns, a commit group a 32-column K panel; the
//     next tile's K streams into a panel once the products two groups later
//     have retired. Its partial S goes into the other block's buffer by
//     st.async, counted on that block's mbarrier; the other's partial,
//     counted here, is added to it (fp32 addition commutes: both blocks hold
//     the same bits of S, the maxima and P). A block stores into a buffer
//     again two tiles later, after it has received the other's next partial,
//     which the other sends only once it has read the buffer.
//   * O += P V is TF32 wgmma m64n256k8 over the block's 256 rows of V^T with
//     P in registers, one tile behind: P V of tile j - 1 runs on the tensor
//     cores while tile j's partial crosses and its online softmax (exp2 by
//     ex2.approx) is taken; the rescale of O waits for it.
//   * No atomics; equal inputs give equal bits.
// The choices are the A/B's of tools/variants.py --f32-attn (PERF.md, the
// fp32 D = 512 forward readings; H100 SXM at 700 W). Against the pair's first
// version (a cluster barrier a tile, the partials loaded from the other
// block, P V in step): one block of two warpgroups splitting D over 16-key
// tiles (K and V^T at one stage, the partials through shared memory) ran
// 1.02-1.05x slower, 2x at 64 blocks; 16- and 32-key tiles of the pair
// 1.25-1.34x slower; then the st.async exchange took 15% off and P V one
// tile behind 3-11% more.
//
// Arithmetic (the plain versions': ops/attention.py attention_reference,
// streaming_attention_reference). Every product operand is rounded to TF32
// (tf32_rna, cvt.rna's rounding) where it is stored; scores in fp32, softmax
// statistics and sums in fp32. Resident (row 2): scores times
// scale * log2(e), keys past the end at -inf, the row log-sum-exp
// m * scale * log2(e) + log2(l) where asked for (row 7 reads it).
// STREAMING (row 4): q times scale * log2(e) in fp32 before its rounding,
// keys past the end at the finite -1e30 with probability exactly 0, the
// maximum starting at -1e30, the denominator the sum of the probabilities
// (their "cast" to v's type is the identity in fp32); a split of the keys
// writes its partial output, maximum and sum for the combine launch of
// flash_attention_streaming.cu.
#pragma once

#include "hopper_tf32.cuh"
#include "hopper_tiles.cuh"

namespace {
namespace hwide_f32 {

using namespace hopper;

constexpr int D = 512;             // the head width
constexpr int ROWS = 64;           // query rows of a q-tile
constexpr int NT = 128;            // one warpgroup a block
constexpr int PREP_NT = 256;       // threads of a block of (1)
constexpr int HALF = D / 2;        // depth / output columns of a block
constexpr int PANELS = HALF / 32;  // its 32-column panels of 128-byte rows
constexpr int KEYS = 64;           // keys of a K / V^T tile
// K panels (commit groups of the score product) in flight before a retired
// panel's next tile is loaded
constexpr int K_LAG = 2;

// Bytes. q: the block's 8 panels of [64 rows][128 B]. A half of a K tile
// image: 8 panels of [64 keys][128 B]; of a V^T tile image: two panels of
// the 256 rows d, 32 keys (128 B) each. Each panel under the 128-byte
// swizzle.
constexpr int Q_PANEL = ROWS * 128;
constexpr int Q_BYTES = PANELS * Q_PANEL;
constexpr int K_PANEL = KEYS * 128;
constexpr int HALF_TILE = KEYS * HALF * 4;
constexpr int V_PANEL = HALF * 128;
constexpr int X_BYTES = ROWS * KEYS * 4;   // a partial S
constexpr int K_OFF = Q_BYTES;
constexpr int V_OFF = K_OFF + HALF_TILE;
constexpr int X_OFF = V_OFF + HALF_TILE;   // the other block's partials [2]
constexpr int BAR_OFF = X_OFF + 2 * X_BYTES;
constexpr int BARS = 5;                    // q, K, V^T, the partials [2]
constexpr int SMEM = 1024 + BAR_OFF + BARS * 8;
static_assert(SMEM <= 232448, "shared memory of a block");
constexpr int BAR_WG = 1;                  // named barrier of the block

__device__ __forceinline__ uint4 round4(float4 x) {
  return make_uint4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                    tf32_rna(x.w));
}

// One arrival on a barrier of this block that also expects `bytes` more of
// asynchronous stores (its phase completes once both are in).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          cvta(bar)),
      "r"(bytes)
      : "memory");
}

// 16 bytes into another block's shared memory (cluster addresses, mapa),
// counted on that block's barrier as they land.
__device__ __forceinline__ void st_async16(uint32_t addr, float4 v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// (1) The tile images of one (batch * head): a block writes 16 keys, keys
// [KEYS j + 16 s, + 16) (blockIdx.x = (bh * tiles + j) * KEYS / 16 + s), of
// kimg / vimg [BH, tiles, 2 halves, HALF_TILE bytes]. In a V^T row the 16
// positions of these keys hold, chunk q (16 bytes), the keys
// 8 (q / 2) + 2 e + q % 2, e = 0 .. 3 (perm8 inverted).
__device__ __forceinline__ void prep_tile(const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          float* __restrict__ kimg,
                                          float* __restrict__ vimg, int nk,
                                          int tiles) {
  __shared__ float sv[16][D + 8];  // 16 keys of V; 8 words of row padding
  const int s = blockIdx.x % (KEYS / 16);
  const int64_t tile = blockIdx.x / (KEYS / 16);  // bh * tiles + j
  const int key0 = static_cast<int>(tile % tiles) * KEYS + 16 * s;
  const int64_t at = (tile / tiles * nk + key0) * D;
  unsigned char* ko =
      reinterpret_cast<unsigned char*>(kimg) + tile * 2 * HALF_TILE;
  unsigned char* vo =
      reinterpret_cast<unsigned char*>(vimg) + tile * 2 * HALF_TILE;
  // K: 16-byte chunk c of key row r (columns 4 c ..) into half c / 64,
  // panel (c / 8) % 8, row 16 s + r, chunk c % 8
#pragma unroll
  for (int i = 0; i < 16 * D / 4 / PREP_NT; ++i) {
    const int x = threadIdx.x + i * PREP_NT;
    const int r = x / (D / 4), c = x % (D / 4);
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (key0 + r < nk) {
      kx = *reinterpret_cast<const float4*>(k + at + r * D + 4 * c);
      vx = *reinterpret_cast<const float4*>(v + at + r * D + 4 * c);
    }
    *reinterpret_cast<uint4*>(ko + (c >> 6) * HALF_TILE +
                              ((c >> 3) & 7) * K_PANEL +
                              Swz<128>::at(16 * s + r, c & 7)) = round4(kx);
    *reinterpret_cast<float4*>(&sv[r][4 * c]) = vx;
  }
  __syncthreads();
  // V^T: row d, panel s / 2, chunks 4 (s % 2) + q; a warp writes eight
  // rows' 64 bytes
#pragma unroll
  for (int i = 0; i < D * 4 / PREP_NT; ++i) {
    const int x = threadIdx.x + i * PREP_NT;
    const int d = 8 * (x >> 5) + ((x & 31) >> 2), q = x & 3;
    const int kb = 8 * (q >> 1) + (q & 1);
    const float4 y = make_float4(sv[kb][d], sv[kb + 2][d], sv[kb + 4][d],
                                 sv[kb + 6][d]);
    *reinterpret_cast<uint4*>(vo + (d / HALF) * HALF_TILE +
                              (s >> 1) * V_PANEL +
                              Swz<128>::at(d % HALF, 4 * (s & 1) + q)) =
        round4(y);
  }
}

// hopper_tiles.cuh's softmax_scores with the keys at or past key_end
// masked by selects in place of a branch: it runs while a P V product is in
// flight, where a branch would serialize the wgmma pipeline. The same
// operations in the same order otherwise.
template <int AKV, bool FINITE>
__device__ __forceinline__ void softmax_select(float (&sc)[AKV / 2],
                                               float& m0, float& m1,
                                               float& alpha0, float& alpha1,
                                               int key0, int key_end,
                                               float scale, int lane) {
  const float masked = FINITE ? -1e30f : -INFINITY;
#pragma unroll
  for (int j = 0; j < AKV / 8; ++j) {
    const int key = key0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[4 * j + e] = key + (e & 1) >= key_end ? masked : sc[4 * j + e];
  }
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = sc[e];
#pragma unroll
  for (int j = 2; j < AKV / 8; j += 2)
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = fmaxf(x[e], sc[4 * j + e]);
  float mx0 = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[4], x[5]));
  float mx1 = fmaxf(fmaxf(x[2], x[3]), fmaxf(x[6], x[7]));
  mx0 = fmaxf(m0, fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1)));
  mx1 = fmaxf(m1, fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1)));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha0 = exp2_fast((m0 - mx0) * scale);
  alpha1 = exp2_fast((m1 - mx1) * scale);
  m0 = mx0;
  m1 = mx1;
  const float ms0 = mx0 * scale, ms1 = mx1 * scale;
#pragma unroll
  for (int j = 0; j < AKV / 8; ++j) {
    const int key = key0 + 8 * j + 2 * (lane & 3);
    sc[4 * j] = exp2_fast(fmaf(sc[4 * j], scale, -ms0));
    sc[4 * j + 1] = exp2_fast(fmaf(sc[4 * j + 1], scale, -ms0));
    sc[4 * j + 2] = exp2_fast(fmaf(sc[4 * j + 2], scale, -ms1));
    sc[4 * j + 3] = exp2_fast(fmaf(sc[4 * j + 3], scale, -ms1));
    if (FINITE) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = key + (e & 1) >= key_end ? 0.f : sc[4 * j + e];
    }
  }
}

// The epilogue of block w, owning output columns [256 w, + 256) of a 64-row
// q-tile (rows q0 .. of nq; row_base its first row of all BH * Nq = rows):
// resident, o = acc / l and, where lse is not null (w = 0 writes), the row
// log-sum-exp; STREAMING with one split, o = acc / max(l, 1e-30); with
// splits (grid.y), the split's unnormalised output, maxima and sums.
template <bool STREAMING>
__device__ __forceinline__ void store_out(
    const float (&acc)[HALF / 2], float m0, float m1, float l0, float l1,
    int w, int q0, int nq, int64_t row_base, int64_t rows, float factor,
    float* __restrict__ o, float* __restrict__ lse, float* __restrict__ part_o,
    float* __restrict__ part_ml) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2), r1 = r0 + 8;
  const int c0 = w * HALF + 2 * (lane & 3);
  const bool ok0 = q0 + r0 < nq, ok1 = q0 + r1 < nq;
  float* dst = o;
  float inv0 = 1.f, inv1 = 1.f;
  if (!STREAMING || gridDim.y == 1) {
    if (!STREAMING && lse != nullptr && w == 0 && (lane & 3) == 0) {
      if (ok0) lse[row_base + r0] = m0 * factor + log2f(l0);
      if (ok1) lse[row_base + r1] = m1 * factor + log2f(l1);
    }
    inv0 = 1.f / (STREAMING ? fmaxf(l0, 1e-30f) : l0);
    inv1 = 1.f / (STREAMING ? fmaxf(l1, 1e-30f) : l1);
    dst += row_base * D;
  } else {
    // part_o [splits, BH * Nq, D], part_ml [splits, 2, BH * Nq]
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
    dst = part_o + (blockIdx.y * rows + row_base) * D;
  }
#pragma unroll
  for (int i = 0; i < HALF / 8; ++i) {
    if (ok0)
      *reinterpret_cast<float2*>(dst + r0 * D + c0 + 8 * i) =
          make_float2(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    if (ok1)
      *reinterpret_cast<float2*>(dst + r1 * D + c0 + 8 * i) =
          make_float2(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
  }
}

// (2) The attention of the block pair (blockIdx.x / 2: batch * head and
// 64-row q-tile, blockIdx.y: split of the keys) over keys
// [split * keys_per_split, + that) of nk, from the tile images of (1).
// Resident: factor = scale * log2(e), lse (or null) gets the row
// log-sum-exp, o the output. STREAMING: factor = scale * log2(e) in fp32;
// with one split o gets the output, else part_o [splits, BH * Nq, D] and
// part_ml [splits, 2, BH * Nq] the split's unnormalised output, row maxima
// and row sums.
template <bool STREAMING>
__device__ __forceinline__ void attend(
    const float* __restrict__ q, const float* __restrict__ kimg,
    const float* __restrict__ vimg, float* __restrict__ o,
    float* __restrict__ lse, float* __restrict__ part_o,
    float* __restrict__ part_ml, int nq, int nk, int keys_per_split,
    float factor, int tiles, int q_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sb = cvta(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + BAR_OFF);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = static_cast<int>(cluster_rank());  // the half of D
  const int pair = blockIdx.x >> 1;
  const int64_t bh = pair / q_tiles;
  const int q0 = (pair % q_tiles) * ROWS;
  const int kv_begin = blockIdx.y * keys_per_split;
  const int kv_end = min(nk, kv_begin + keys_per_split);
  const int ntiles = (kv_end - kv_begin + KEYS - 1) / KEYS;
  const int64_t row_base = bh * nq + q0;
  const int64_t first = bh * tiles + kv_begin / KEYS;  // tile image
  const unsigned char* kw = reinterpret_cast<const unsigned char*>(kimg) +
                            first * 2 * HALF_TILE + w * HALF_TILE;
  const unsigned char* vw = reinterpret_cast<const unsigned char*>(vimg) +
                            first * 2 * HALF_TILE + w * HALF_TILE;
  const uint32_t sq = sb, sk = sb + K_OFF, sv = sb + V_OFF;
  uint64_t* qbar = bars;
  uint64_t* kbar = bars + 1;
  uint64_t* vbar = bars + 2;
  uint64_t* xbar = bars + 3;  // [2]: the other block's partial has landed

  if (t == 0) {
    for (int i = 0; i < BARS; ++i) mbar_init(&bars[i], NT);
    mbar_fence_init();
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();  // both blocks' barriers exist before either stores

  // this block's columns of the q-tile: 16-byte chunk c of row r (columns
  // 256 w + 4 c ..) into panel c / 8, chunk c % 8 (rows past nq zeros and
  // not written back)
  const float* qw = q + row_base * D + w * HALF;
#pragma unroll 8
  for (int i = 0; i < ROWS * HALF / 4 / NT; ++i) {
    const int x = t + i * NT;
    const int r = x / (HALF / 4), c = x % (HALF / 4);
    const bool ok = q0 + r < nq;
    cp_async16(sq + (c >> 3) * Q_PANEL + Swz<128>::at(r, c & 7),
               qw + (ok ? r * D + 4 * c : 0), ok);
  }
  cp_async_arrive(qbar);
  // tile j of the block's keys: its half of the V^T image, and panel p of
  // its half of the K image, each copied as it lies
  auto load_v = [&](int j) {
    const unsigned char* src = vw + static_cast<int64_t>(j) * 2 * HALF_TILE;
#pragma unroll 8
    for (int i = 0; i < HALF_TILE / 16 / NT; ++i)
      cp_async16(sv + 16 * (t + NT * i), src + 16 * (t + NT * i), true);
    cp_async_arrive(vbar);
  };
  auto load_k_panel = [&](int j, int p) {
    const unsigned char* src =
        kw + static_cast<int64_t>(j) * 2 * HALF_TILE + p * K_PANEL;
#pragma unroll
    for (int i = 0; i < K_PANEL / 16 / NT; ++i)
      cp_async16(sk + p * K_PANEL + 16 * (t + NT * i),
                 src + 16 * (t + NT * i), true);
  };
#pragma unroll
  for (int p = 0; p < PANELS; ++p) load_k_panel(0, p);
  cp_async_arrive(kbar);
  load_v(0);

  // q rounded to TF32 in place (STREAMING: times the factor in fp32 first;
  // zeros stay zeros)
  mbar_wait(qbar, 0);
  {
    const float mul = STREAMING ? factor : 1.f;
    uint4* qh = reinterpret_cast<uint4*>(base);
#pragma unroll 4
    for (int i = t; i < Q_BYTES / 16; i += NT) {
      const uint4 x = qh[i];
      qh[i] = round4(make_float4(
          __uint_as_float(x.x) * mul, __uint_as_float(x.y) * mul,
          __uint_as_float(x.z) * mul, __uint_as_float(x.w) * mul));
    }
  }
  fence_async_shared();
  bar_sync(BAR_WG, NT);  // the whole rounded q before wgmma reads it

  float acc[HALF / 2];
#pragma unroll
  for (int x = 0; x < HALF / 2; ++x) acc[x] = 0.f;
  float m0 = STREAMING ? -1e30f : -INFINITY, m1 = m0, l0 = 0.f, l1 = 0.f;
  const float softmax_scale = STREAMING ? 1.f : factor;
  const uint32_t x_peer = map_rank(sb + X_OFF, w ^ 1);
  const uint32_t xbar_peer = map_rank(cvta(xbar), w ^ 1);
  // P V of tile j - 1 runs on the tensor cores while tile j's partial
  // scores cross to the other block and its softmax is taken; P of "tile
  // -1" is zero (times V^T tile 0)
  uint32_t pa_prev[KEYS / 8][4];
#pragma unroll
  for (int kt = 0; kt < KEYS / 8; ++kt)
    pa_prev[kt][0] = pa_prev[kt][1] = pa_prev[kt][2] = pa_prev[kt][3] = 0u;
  auto issue_pv = [&]() {
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KEYS / 8; ++kt)  // k8 step kt: 32 bytes a step
      wgmma_tf32_rs<HALF>(acc, pa_prev[kt],
                          desc_k<128>(sv + (kt / 4) * V_PANEL + 32 * (kt % 4)),
                          1);
    wgmma_commit();
  };

  for (int j = 0; j < ntiles; ++j) {
    mbar_wait(kbar, j & 1);
    fence_async_shared();
    // this block's partial S = q K^T, a commit group a K panel (four k8
    // steps, 32 bytes apart); panel p of the next tile (past the last: the
    // last again, the same bytes, so that no branch sits between a wgmma
    // and its wait) streams in once the products K_LAG groups later have
    // retired in all four warps
    const int next = min(j + 1, ntiles - 1);
    float sc[KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma_tf32_ss<KEYS>(sc, desc_k<128>(sq + p * Q_PANEL + 32 * c),
                            desc_k<128>(sk + p * K_PANEL + 32 * c),
                            p + c > 0);
      wgmma_commit();
      if (p >= K_LAG) {
        wgmma_wait<K_LAG>();
        bar_sync(BAR_WG, NT);
        load_k_panel(next, p - K_LAG);
      }
    }
    wgmma_wait<0>();
    fence_regs(sc);
    bar_sync(BAR_WG, NT);  // the block is done with this K tile
#pragma unroll
    for (int p = PANELS - K_LAG; p < PANELS; ++p) load_k_panel(next, p);
    cp_async_arrive(kbar);

    // P V of the previous tile (V^T tile j - 1 is phase j - 1 of its
    // barrier: tile 0 arrived first, tile i >= 1 at iteration i)
    mbar_wait(vbar, (j > 0 ? j - 1 : 0) & 1);
    fence_async_shared();
    issue_pv();

    // S = this block's partial + the other's (the same bits in both)
    const int b = j & 1;
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i)
      st_async16(x_peer + b * X_BYTES + 16 * (i * NT + t),
                 make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                             sc[4 * i + 3]),
                 xbar_peer + 8 * b);
    mbar_expect_tx(&xbar[b], X_BYTES / NT);
    mbar_wait(&xbar[b], (j >> 1) & 1);
    const float4* x_other =
        reinterpret_cast<const float4*>(base + X_OFF + b * X_BYTES);
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i) {
      const float4 y = x_other[i * NT + t];
      sc[4 * i] += y.x;
      sc[4 * i + 1] += y.y;
      sc[4 * i + 2] += y.z;
      sc[4 * i + 3] += y.w;
    }

    float alpha0, alpha1;
    softmax_select<KEYS, STREAMING>(sc, m0, m1, alpha0, alpha1,
                                    kv_begin + j * KEYS, kv_end,
                                    softmax_scale, lane);
    l0 *= alpha0;
    l1 *= alpha1;
    add_row_sums<KEYS>(sc, l0, l1);
    // P rounded to TF32, the A operand of k8 step kt: the accumulator's
    // columns 2 t and 2 t + 1 are the fragment's t and t + 4
    uint32_t pa[KEYS / 8][4];
#pragma unroll
    for (int kt = 0; kt < KEYS / 8; ++kt) {
      pa[kt][0] = tf32_rna(sc[4 * kt]);
      pa[kt][1] = tf32_rna(sc[4 * kt + 2]);
      pa[kt][2] = tf32_rna(sc[4 * kt + 1]);
      pa[kt][3] = tf32_rna(sc[4 * kt + 3]);
    }

    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa_prev);
    bar_sync(BAR_WG, NT);  // V^T tile j - 1 is read in all four warps
    if (j > 0) load_v(j);
    scale_rows<HALF>(acc, alpha0, alpha1);
#pragma unroll
    for (int kt = 0; kt < KEYS / 8; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa_prev[kt][e] = pa[kt][e];
  }
  mbar_wait(vbar, (ntiles - 1) & 1);  // the last tile's P V
  fence_async_shared();
  issue_pv();
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_wait(kbar, ntiles & 1);  // no copy in flight when the block exits
  cluster_arrive();
  cluster_wait();  // neither block leaves while the other may store into it
  store_out<STREAMING>(acc, m0, m1, quad_sum(l0), quad_sum(l1), w, q0, nq,
                       row_base,
                       gridDim.x / (2 * q_tiles) * static_cast<int64_t>(nq),
                       factor, o, lse, part_o, part_ml);
}

// Each caller defines its own __global__ kernels around prep_tile (with
// __launch_bounds__(PREP_NT)) and attend<STREAMING> (__launch_bounds__(NT,
// 1)), so that a profile names the row that launched them.

// Launches (1) on bh * tiles * KEYS / 16 blocks and (2) on clusters of two
// blocks, bh * q-tiles pairs x splits; scratch holds the two images,
// 2 * bh * tiles * KEYS * 2 KB (ops/attention.py:wide_f32_plan). Returns the
// CUDA error of the first launch that failed (0 = both launched).
template <typename Prep, typename... Params, typename... Args>
int launch(Prep prep, void (*kernel)(Params...), const float* k,
           const float* v, float* scratch, int bh, int nq, int nk, int splits,
           cudaStream_t stream, Args... args) {
  const int tiles = (nk + KEYS - 1) / KEYS;
  float* kimg = scratch;
  float* vimg = scratch + static_cast<int64_t>(bh) * tiles * (HALF_TILE / 2);
  prep<<<bh * tiles * (KEYS / 16), PREP_NT, 0, stream>>>(k, v, kimg, vimg, nk,
                                                          tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + ROWS - 1) / ROWS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(bh * q_tiles * 2),
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...,
                           static_cast<const float*>(kimg),
                           static_cast<const float*>(vimg), tiles, q_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hwide_f32
}  // namespace
