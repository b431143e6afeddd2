// The Hopper grids of the attention backward, shared by the packed backward
// (flash_attention_bwd_packed.cu), the split-head backward
// (flash_attention_bwd.cu) and the streaming backward
// (flash_attention_streaming_bwd.cu) in bf16 at D = 32 / 64 / 80. With s
// the score of a (query, key) pair in the scaled base-2 domain and lse2 its
// row's log-sum-exp there:
//   p  = exp2(s - lse2)                 fp32
//   dp = do v^T,  ds = p (dp - delta),  delta = rowsum(do o)
//   dv = p^T do,  dk = scale ds^T q,  dq = scale ds k
// P and dS are cast to bf16 before their products, every product
// accumulates in fp32, and dk and dv are summed over all query rows in fp32
// and cast once. Three launches, no atomics (equal inputs give equal bits):
// delta (bwd_delta_kernel); a grid over (batch, head, 128 key/value rows)
// that streams the query tiles and writes dk / dv once; a grid over (batch,
// head, 128 query rows) that streams the key/value tiles and writes dq once.
//
// Layout: rows of `heads` heads of D columns, a head addressed by base
// pointer + h * D and the row stride heads * D. Split heads [BH, N, D] are
// heads = 1 with B = BH, so every caller runs the same instantiations. In
// shared memory a tile of rows is the column panels of
// hopper_tiles.cuh:HeadSplit (load_head_async): at D = 32 / 64 one panel
// swizzled by the width of its rows; at D = 80 a 128-byte panel of 64
// columns, then a 32-byte panel of 16. A product over D (the scores, dP)
// takes 4 k16 steps on the first panel and 1 on the second; a product whose
// columns are D (dV, dK, dq) is an N = 64 product on the first panel and an
// N = 16 one on the second into the two parts of the accumulator.
//
// Score rounding. The packed backward forms s = (q k^T) * scale * log2(e)
// in fp32 (scale_log2 = scale * log2(e)), as its forward kernel did. The
// streaming backward forms it from qs = bf16(q * bf16(scale * log2(e))), as
// its forward and its lse launch do, with scale_log2 = 1; dk is still taken
// against the unscaled q. PRESCALED gives the dk/dv grid qs as a tile of
// its own beside q in each stage (+4 KB a stage at D = 32, +8 KB at 64, +10 KB
// at 80); the dq grid reads q only for the scores, so it is handed qs in q's
// place.
//
// Design (hopper_tiles.cuh): a block is two warpgroups, each owning 64 of
// the block's 128 rows, whose K and V (or q and do) stay in shared memory.
// The streamed 64-row tiles (q, do, [qs,] and the rows' lse and delta; or K
// and V) arrive through a ring of STAGES buffers filled by cp.async, each
// stage completing on an mbarrier and released on another, so the copies of
// the next tiles overlap the products of this one. Every product runs on
// wgmma from the swizzled tiles: S^T = K q^T and dP^T = V do^T with both
// operands in shared memory, then dV += P^T do and dK += dS^T q with P^T
// and dS^T packed to bf16 in registers as the A operand; in the dq grid
// S = q K^T, dP = do V^T and dq += dS K alike. exp2 is the special-function
// unit's alone (exp2_fast), and the dk/dv grid fits two blocks an SM at
// D = 32 (at most 128 registers a thread). At D = 80 the dk and dv
// accumulators are 40 fp32 registers a thread each; with the scores, dP and
// their bf16 packings a thread holds some 180, so both grids run one block
// an SM (as at D = 64), and shared memory is no limit: 104 KB for the dk/dv
// grid (134 KB with the pre-scaled q), 101 KB for the dq grid.
//
// Bound on this card: operations. The function is 10 Nq Nk H D operations a
// batch element against 2 (4 Nq + 4 Nk) H D bytes; with the scores and dP
// formed in both grids the kernels execute 14, and at D = 32 each score also
// costs an exp2 in each grid and a few fp32 operations outside the tensor
// cores.
#pragma once

#include "hopper_tiles.cuh"

namespace {

// delta[(b * heads + h) * nq + i] = sum_d o[b, i, h, d] * do[b, i, h, d] on
// rows of stride heads * D (heads = 1 addresses split heads [BH, N, D]).
template <int D>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int nq, int heads, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= total) return;
  const int i = static_cast<int>(idx % nq);
  const int64_t bh = idx / nq;
  const int h = static_cast<int>(bh % heads);
  const int64_t b = bh / heads;
  const int64_t off = ((b * nq + i) * heads + h) * D;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    const uint4 va = *reinterpret_cast<const uint4*>(o + off + c);
    const uint4 vb = *reinterpret_cast<const uint4*>(dout + off + c);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&va);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&vb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fa = __bfloat1622float2(pa[j]);
      const float2 fb = __bfloat1622float2(pb[j]);
      acc += fa.x * fb.x + fa.y * fb.y;
    }
  }
  delta[idx] = acc;
}

namespace hbwd {

using namespace hopper;

constexpr int OWN = 128;    // rows a block owns: two warpgroups of 64
constexpr int STR = 64;     // rows of a streamed tile
constexpr int STAGES = 3;   // buffers of the ring
constexpr int NT = 256;     // threads of a block

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

template <int D, bool PRESCALED>
struct Layout {
  static constexpr int OWN_TILE = OWN * 2 * D;       // both panels
  static constexpr int STR_TILE = STR * 2 * D;
  // dk/dv grid: a stage holds q, do, [qs,] lse, delta; dq grid: K, V
  static constexpr int Q_TILES = PRESCALED ? 3 : 2;
  static constexpr int STAGE_DKDV =
      round_up(Q_TILES * STR_TILE + 2 * STR * 4, 1024);
  static constexpr int STAGE_DQ = 2 * STR_TILE;
  static constexpr int BARS = 2 * STAGES + 1;        // full, empty, own
  static constexpr int smem(int stage) {
    return 1024 + 2 * OWN_TILE + STAGES * stage + BARS * 8;
  }
};

// The 64 rows from row r0 (a multiple of 8) of a tile of `rows` rows at
// `tile`, as the addresses of their rows in the two panels of HeadSplit<D>.
template <int D>
struct Rows64 {
  uint32_t a, b;
  __device__ __forceinline__ Rows64(uint32_t tile, int rows, int r0)
      : a(tile + r0 * 2 * HeadSplit<D>::A),
        b(tile + rows * 2 * HeadSplit<D>::A + r0 * 32) {}
};

// acc[64 x 64] = x y^T, the reduction over the D columns of two 64-row
// blocks in shared memory (both K-major): the k16 steps of panel A, then of
// panel B.
template <int D>
__device__ __forceinline__ void rows_times_rows_t(float (&acc)[32], Rows64<D> x,
                                                  Rows64<D> y) {
  constexpr int DA = HeadSplit<D>::A, DB = HeadSplit<D>::B;
#pragma unroll
  for (int kk = 0; kk < DA / 16; ++kk)
    wgmma_ss<64, 0>(acc, desc_k<2 * DA>(x.a + 32 * kk),
                    desc_k<2 * DA>(y.a + 32 * kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DB / 16; ++kk)
    wgmma_ss<64, 0>(acc, desc_k<32>(x.b + 32 * kk), desc_k<32>(y.b + 32 * kk));
}

// acc[64 x D] += A y, A [64 x 64] in registers (its four k16 steps, P^T or
// dS^T or dS packed to bf16) and y the 64 rows of a tile (MN-major: its rows
// are the reduction): N = 64 (or D) on panel A, N = 16 on panel B.
template <int D>
__device__ __forceinline__ void frag_times_rows(float (&acc)[D / 2],
                                                const uint32_t (&a)[4][4],
                                                Rows64<D> y) {
  constexpr int DA = HeadSplit<D>::A, DB = HeadSplit<D>::B;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    wgmma_rs<DA, 1>(part<0, DA>(acc), a[t],
                    desc_mn<2 * DA>(y.a + t * 16 * 2 * DA));
    if constexpr (DB > 0)
      wgmma_rs<DB, 1>(part<DA, DB>(acc), a[t], desc_mn<32>(y.b + t * 16 * 32));
  }
}

// Epilogue of both grids: the warpgroup's [64 x D] accumulator times mul,
// cast to bf16, into rows below valid of a tensor of row stride ld; g
// points at the warpgroup's first row.
template <int D>
__device__ __forceinline__ void store_acc(bf16* g, int64_t ld, int valid,
                                          const float (&acc)[D / 2],
                                          float mul) {
  const int wt = threadIdx.x & 127;
  const int r0 = (wt >> 5) * 16 + ((wt & 31) >> 2);
  const int c = 2 * (wt & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < valid)
      *reinterpret_cast<uint32_t*>(g + r0 * ld + 8 * j + c) =
          pack2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r0 + 8 < valid)
      *reinterpret_cast<uint32_t*>(g + (r0 + 8) * ld + 8 * j + c) =
          pack2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// two blocks an SM at D = 32 (at most 128 registers a thread). qs is read
// for the scores where PRESCALED, q otherwise.
template <int D, bool PRESCALED>
__global__ void __launch_bounds__(NT, D == 32 ? 2 : 1)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ qs,
            const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk,
            bf16* __restrict__ dv, int nq, int nk, int heads, int kv_tiles,
            float scale, float scale_log2) {
  using L = Layout<D, PRESCALED>;
  constexpr int STAGE = L::STAGE_DKDV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sK = cvta(base), sV = sK + L::OWN_TILE;
  const uint32_t ring = sV + L::OWN_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 2 * L::OWN_TILE +
                                               STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;

  const int tid = threadIdx.x;
  const int kv0 = (blockIdx.x % kv_tiles) * OWN;
  const int64_t bh = blockIdx.x / kv_tiles;
  const int h = static_cast<int>(bh % heads);
  const int64_t b = bh / heads;
  const int64_t ld = static_cast<int64_t>(heads) * D;
  const bf16* gq = q + b * nq * ld + h * D;
  const bf16* gqs = qs + b * nq * ld + h * D;
  const bf16* gdo = dout + b * nq * ld + h * D;
  const float* glse = lse + bh * nq;
  const float* gdl = delta + bh * nq;
  const int64_t kv_off = (b * nk + kv0) * ld + h * D;
  const int kv_valid = nk - kv0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NT);
    }
    mbar_init(own, NT);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  load_head_async<D, OWN, NT>(sK, k + kv_off, ld, kv_valid, tid);
  load_head_async<D, OWN, NT>(sV, v + kv_off, ld, kv_valid, tid);
  cp_async_arrive(own);

  const int q_tiles = (nq + STR - 1) / STR;
  auto issue = [&](int j) {  // query tile j into stage j % STAGES
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
    const uint32_t st = ring + s * STAGE;
    const int q0 = j * STR;
    load_head_async<D, STR, NT>(st, gq + q0 * ld, ld, nq - q0, tid);
    load_head_async<D, STR, NT>(st + L::STR_TILE, gdo + q0 * ld, ld, nq - q0,
                                tid);
    if constexpr (PRESCALED)
      load_head_async<D, STR, NT>(st + 2 * L::STR_TILE, gqs + q0 * ld, ld,
                                  nq - q0, tid);
    if (tid < 2 * STR) {  // lse then delta, one fp32 a thread
      const int i = tid % STR;
      const bool ok = q0 + i < nq;
      const float* src = (tid < STR ? glse : gdl) + (ok ? q0 + i : 0);
      cp_async4(st + L::Q_TILES * L::STR_TILE + 4 * tid, src, ok);
    }
    cp_async_arrive(&full[s]);
  };
  for (int j = 0; j < STAGES - 1 && j < q_tiles; ++j) issue(j);

  const int wg = tid >> 7;
  const int lane = tid & 31;
  const Rows64<D> myK(sK, OWN, wg * 64), myV(sV, OWN, wg * 64);
  float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  mbar_wait(own, 0);

  for (int j = 0; j < q_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    if (j + STAGES - 1 < q_tiles) issue(j + STAGES - 1);
    fence_async_shared();
    const uint32_t sQ = ring + s * STAGE, sdO = sQ + L::STR_TILE;
    const uint32_t sS = PRESCALED ? sQ + 2 * L::STR_TILE : sQ;  // scores' q
    const float* sLse = reinterpret_cast<const float*>(
        base + 2 * L::OWN_TILE + s * STAGE + L::Q_TILES * L::STR_TILE);
    const float* sDl = sLse + STR;

    // S^T = K q^T and dP^T = V do^T: [64 key rows] x [64 query rows]
    float st[32], dpt[32];
    wgmma_fence();
    rows_times_rows_t<D>(st, myK, Rows64<D>(sS, STR, 0));
    rows_times_rows_t<D>(dpt, myV, Rows64<D>(sdO, STR, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp2(S^T scale_log2 - lse[q]); dS^T = P^T (dP^T - delta[q]).
    // A column is a query row: those past nq give 0.
    const int q0 = j * STR;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c0 = 8 * jj + 2 * (lane & 3);
      const bool ok0 = q0 + c0 < nq, ok1 = q0 + c0 + 1 < nq;
      const float l0 = sLse[c0], l1 = sLse[c0 + 1];
      const float d0 = sDl[c0], d1 = sDl[c0 + 1];
      const float p0 = ok0 ? exp2_fast(st[4 * jj] * scale_log2 - l0) : 0.f;
      const float p1 = ok1 ? exp2_fast(st[4 * jj + 1] * scale_log2 - l1) : 0.f;
      const float p2 = ok0 ? exp2_fast(st[4 * jj + 2] * scale_log2 - l0) : 0.f;
      const float p3 = ok1 ? exp2_fast(st[4 * jj + 3] * scale_log2 - l1) : 0.f;
      dpt[4 * jj] = p0 * (dpt[4 * jj] - d0);
      dpt[4 * jj + 1] = p1 * (dpt[4 * jj + 1] - d1);
      dpt[4 * jj + 2] = p2 * (dpt[4 * jj + 2] - d0);
      dpt[4 * jj + 3] = p3 * (dpt[4 * jj + 3] - d1);
      st[4 * jj] = p0;
      st[4 * jj + 1] = p1;
      st[4 * jj + 2] = p2;
      st[4 * jj + 3] = p3;
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      acc_to_a<64>(pa[t], st, t);
      acc_to_a<64>(da[t], dpt, t);
    }

    // dV += P^T do, dK += dS^T q: the query rows are the reduction
    wgmma_fence();
    frag_times_rows<D>(dvacc, pa, Rows64<D>(sdO, STR, 0));
    frag_times_rows<D>(dkacc, da, Rows64<D>(sQ, STR, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dvacc);
    fence_regs(dkacc);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(&empty[s]);
  }

  const int64_t wg_off = kv_off + wg * 64 * ld;
  store_acc<D>(dk + wg_off, ld, kv_valid - wg * 64, dkacc, scale);
  store_acc<D>(dv + wg_off, ld, kv_valid - wg * 64, dvacc, 1.f);
}

// q is the scores' operand (qs where the scores are pre-scaled). It is not
// __restrict__: the streaming backward keeps qs in dq's own memory, and a
// block reads its q rows (before its loop) and writes the same rows of dq
// (after it), which no other block reads.
template <int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const bf16* q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* dq, int nq, int nk, int heads, int q_tiles, float scale,
          float scale_log2) {
  using L = Layout<D, false>;
  constexpr int STAGE = L::STAGE_DQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sQ = cvta(base), sdO = sQ + L::OWN_TILE;
  const uint32_t ring = sdO + L::OWN_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 2 * L::OWN_TILE +
                                               STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;

  const int tid = threadIdx.x;
  const int q0 = (blockIdx.x % q_tiles) * OWN;
  const int64_t bh = blockIdx.x / q_tiles;
  const int h = static_cast<int>(bh % heads);
  const int64_t b = bh / heads;
  const int64_t ld = static_cast<int64_t>(heads) * D;
  const int64_t q_off = (b * nq + q0) * ld + h * D;
  const bf16* gk = k + b * nk * ld + h * D;
  const bf16* gv = v + b * nk * ld + h * D;
  const int q_valid = nq - q0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NT);
    }
    mbar_init(own, NT);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  load_head_async<D, OWN, NT>(sQ, q + q_off, ld, q_valid, tid);
  load_head_async<D, OWN, NT>(sdO, dout + q_off, ld, q_valid, tid);
  cp_async_arrive(own);

  const int kv_tiles = (nk + STR - 1) / STR;
  auto issue = [&](int j) {  // key/value tile j into stage j % STAGES
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
    const uint32_t st = ring + s * STAGE;
    const int kv0 = j * STR;
    load_head_async<D, STR, NT>(st, gk + kv0 * ld, ld, nk - kv0, tid);
    load_head_async<D, STR, NT>(st + L::STR_TILE, gv + kv0 * ld, ld, nk - kv0,
                                tid);
    cp_async_arrive(&full[s]);
  };
  for (int j = 0; j < STAGES - 1 && j < kv_tiles; ++j) issue(j);

  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  const Rows64<D> myQ(sQ, OWN, wg * 64), mydO(sdO, OWN, wg * 64);
  // the thread's two query rows and their statistics
  const int r0 = wg * 64 + (wt >> 5) * 16 + (lane >> 2), r1 = r0 + 8;
  const int64_t row_stat = bh * nq + q0;
  const float lse0 = r0 < q_valid ? lse[row_stat + r0] : 0.f;
  const float lse1 = r1 < q_valid ? lse[row_stat + r1] : 0.f;
  const float dl0 = r0 < q_valid ? delta[row_stat + r0] : 0.f;
  const float dl1 = r1 < q_valid ? delta[row_stat + r1] : 0.f;
  float dqacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
  mbar_wait(own, 0);

  for (int j = 0; j < kv_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    if (j + STAGES - 1 < kv_tiles) issue(j + STAGES - 1);
    fence_async_shared();
    const uint32_t sK = ring + s * STAGE, sV = sK + L::STR_TILE;

    // S = q K^T and dP = do V^T: [64 query rows] x [64 key rows]
    float sc[32], dp[32];
    wgmma_fence();
    rows_times_rows_t<D>(sc, myQ, Rows64<D>(sK, STR, 0));
    rows_times_rows_t<D>(dp, mydO, Rows64<D>(sV, STR, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta), P = exp2(S scale_log2 - lse); keys past nk are
    // outside the softmax and give 0.
    const int kv0 = j * STR;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int key = kv0 + 8 * jj + 2 * (lane & 3);
      const bool ok0 = key < nk, ok1 = key + 1 < nk;
      const float p0 = ok0 ? exp2_fast(sc[4 * jj] * scale_log2 - lse0) : 0.f;
      const float p1 = ok1 ? exp2_fast(sc[4 * jj + 1] * scale_log2 - lse0) : 0.f;
      const float p2 = ok0 ? exp2_fast(sc[4 * jj + 2] * scale_log2 - lse1) : 0.f;
      const float p3 = ok1 ? exp2_fast(sc[4 * jj + 3] * scale_log2 - lse1) : 0.f;
      dp[4 * jj] = p0 * (dp[4 * jj] - dl0);
      dp[4 * jj + 1] = p1 * (dp[4 * jj + 1] - dl0);
      dp[4 * jj + 2] = p2 * (dp[4 * jj + 2] - dl1);
      dp[4 * jj + 3] = p3 * (dp[4 * jj + 3] - dl1);
    }
    uint32_t da[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) acc_to_a<64>(da[t], dp, t);

    // dq += dS K: the key rows are the reduction
    wgmma_fence();
    frag_times_rows<D>(dqacc, da, Rows64<D>(sK, STR, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqacc);
    fence_regs(da);
    mbar_arrive(&empty[s]);
  }

  store_acc<D>(dq + q_off + wg * 64 * ld, ld, q_valid - wg * 64, dqacc, scale);
}

// delta, the dk/dv grid and the dq grid of b batch elements of `heads`
// heads of D columns, in that order on `stream`. qs is the scores' q where
// PRESCALED (it may be dq's own memory), else ignored. Returns
// cudaGetLastError() of the first launch that failed (0 = all launched).
template <int D, bool PRESCALED>
int launch(const bf16* q, const bf16* qs, const bf16* k, const bf16* v,
           const bf16* o, const bf16* dout, const float* lse, float* delta,
           bf16* dq, bf16* dk, bf16* dv, int b, int nq, int nk, int heads,
           float scale, float scale_log2, cudaStream_t stream) {
  using L = Layout<D, PRESCALED>;
  auto dkdv = dkdv_kernel<D, PRESCALED>;
  auto dqk = dq_kernel<D>;
  const int smem_dkdv = L::smem(L::STAGE_DKDV);
  const int smem_dq = L::smem(L::STAGE_DQ);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(b) * heads * nq;
  bwd_delta_kernel<D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                        stream>>>(o, dout, delta, nq, heads, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles = (nk + OWN - 1) / OWN;
  dkdv<<<b * heads * kv_tiles, NT, smem_dkdv, stream>>>(
      q, PRESCALED ? qs : q, k, v, dout, lse, delta, dk, dv, nq, nk, heads,
      kv_tiles, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + OWN - 1) / OWN;
  dqk<<<b * heads * q_tiles, NT, smem_dq, stream>>>(
      PRESCALED ? qs : q, k, v, dout, lse, delta, dq, nq, nk, heads, q_tiles,
      scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hbwd
}  // namespace
