// Device code of the split-head attention backward (flash_attention_bwd.cu,
// mma.sync), and the delta launch that the Hopper grids of hopper_bwd.cuh
// share with it. The function, per (batch, head), with s = scale * q k^T:
//   p  = softmax(s)                      fp32, recomputed from the saved
//                                        row log-sum-exp: p = exp(s - lse)
//   dp = do v^T
//   ds = p * (dp - delta),  delta = rowsum(p * dp) = rowsum(do * o)
//   dv = p^T do,  dk = scale * ds^T q,  dq = scale * ds k
// p and ds are cast to bf16 before their products (as the forward casts p
// before p v); every product accumulates in fp32; dk and dv are summed in
// fp32 over all query rows and cast once.
//
// Blocks run in no order and nothing carries over between them, and no
// output is summed with atomics (equal inputs give equal bits). So the work
// is cut twice:
//   * bwd_dkdv_tile: a block owns 64 key/value rows of one head, keeps their
//     K and V in shared memory, loops over the query tiles, and writes its
//     rows of dk and dv once;
//   * bwd_dq_tile: a block owns 64 query rows of one head, keeps their q and
//     do in shared memory, loops over the key/value tiles, and writes its
//     rows of dq once.
// Both recompute the scores and dp, so the backward does 7 products of
// N x N x D where the function has 5: accepted for a first version.
//   * bwd_delta_kernel: one thread per (batch, head, query row) forms delta
//     from o and do before the other two run.
//
// A head is addressed by base pointer and row stride (D on split heads, H*D
// on packed rows).
#pragma once

#include "mma_tiles.cuh"

constexpr int BT = 64;  // rows of a backward tile (owned and streamed)

// Bytes of shared memory a block of either backward grid uses: four
// [BT][D + PAD] bf16 tiles and two [BT] fp32 vectors.
template <int D>
constexpr int bwd_smem_bytes() {
  return 4 * BT * (D + PAD) * static_cast<int>(sizeof(bf16)) +
         2 * BT * static_cast<int>(sizeof(float));
}

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

}  // namespace

// c[16 x 64] = A[16 x D] B[64 x D]^T for the warp's 16 rows of sA (from row
// row0) against the 64 rows of sB, both [.][D + PAD] tiles in shared memory.
template <int D>
__device__ __forceinline__ void rows_times_rows_t(float (&c)[BT / 8][4],
                                                  const bf16* sA, int row0,
                                                  const bf16* sB,
                                                  const LaneOffsets& lo) {
  constexpr int LDS = D + PAD;
#pragma unroll
  for (int i = 0; i < BT / 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + (row0 + lo.a_row) * LDS + kk + lo.a_col);
#pragma unroll
    for (int nt = 0; nt < BT / 8; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (nt * 8 + lo.b_row) * LDS + kk + lo.b_col);
      mma_bf16(c[nt], a, b[0], b[1]);
      mma_bf16(c[nt + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x D] += A[16 x 64] B[64 x D], A the warp's bf16 fragment in
// registers (a[nt][0]: row lane/4, a[nt][1]: row lane/4 + 8, of the 8 columns
// nt), B a [64][D + PAD] tile in shared memory.
template <int D>
__device__ __forceinline__ void frag_times_rows(float (&acc)[D / 8][4],
                                                const uint32_t (&a)[BT / 8][2],
                                                const bf16* sB,
                                                const LaneOffsets& lo) {
  constexpr int LDS = D + PAD;
#pragma unroll
  for (int kt = 0; kt < BT / 16; ++kt) {
    const uint32_t af[4] = {a[2 * kt][0], a[2 * kt][1], a[2 * kt + 1][0],
                            a[2 * kt + 1][1]};
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sB + (kt * 16 + lo.a_row) * LDS + dt * 8 + lo.a_col);
      mma_bf16(acc[dt], af, b[0], b[1]);
      mma_bf16(acc[dt + 1], af, b[2], b[3]);
    }
  }
}

// Write the warp's fp32 fragment times `mul`, cast to bf16, to rows
// row0 + lane/4 and + 8 (below valid_rows) of a device tensor of row stride ld.
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, int64_t ld, int row0,
                                           int valid_rows,
                                           const float (&acc)[D / 8][4],
                                           float mul) {
  const int lane = threadIdx.x & 31;
  const int r0 = row0 + (lane >> 2);
  const int r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * (lane & 3);
    if (r0 < valid_rows)
      *reinterpret_cast<uint32_t*>(g + r0 * ld + col) =
          pack_bf16(acc[dt][0] * mul, acc[dt][1] * mul);
    if (r1 < valid_rows)
      *reinterpret_cast<uint32_t*>(g + r1 * ld + col) =
          pack_bf16(acc[dt][2] * mul, acc[dt][3] * mul);
  }
}

// dk and dv of one tile of BT key/value rows of one head. gK / gV / gdK / gdV
// point at the tile's first row (row stride ld_kv, kv_valid rows of it exist);
// gQ / gdO at the head's first query row (row stride ld_q, nq rows); gLse /
// gDelta at the head's [nq] row statistics. 128 threads: warp w owns
// key/value rows 16 w .. 16 w + 15 and holds their dk and dv in registers
// across the loop over the query tiles. The scores are formed transposed
// (S^T = K Q^T), so that P^T and dS^T come out as the A operands of the two
// accumulating products.
template <int D>
__device__ __forceinline__ void bwd_dkdv_tile(
    const bf16* gQ, const bf16* gdO, int64_t ld_q, const bf16* gK,
    const bf16* gV, bf16* gdK, bf16* gdV, int64_t ld_kv, const float* gLse,
    const float* gDelta, int nq, int kv_valid, float scale, float scale_log2,
    unsigned char* smem) {
  constexpr int NTHREADS = 128;
  constexpr int LDS = D + PAD;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BT * LDS;
  bf16* sQ = sV + BT * LDS;
  bf16* sdO = sQ + BT * LDS;
  float* sLse = reinterpret_cast<float*>(sdO + BT * LDS);
  float* sDelta = sLse + BT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16;
  const LaneOffsets lo(lane);

  load_tile<D, NTHREADS>(sK, gK, ld_kv, BT, kv_valid, tid);
  load_tile<D, NTHREADS>(sV, gV, ld_kv, BT, kv_valid, tid);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, NTHREADS>(sQ, gQ + q0 * ld_q, ld_q, BT, nq - q0, tid);
    load_tile<D, NTHREADS>(sdO, gdO + q0 * ld_q, ld_q, BT, nq - q0, tid);
    if (tid < BT) {
      const bool ok = q0 + tid < nq;
      sLse[tid] = ok ? gLse[q0 + tid] : 0.f;
      sDelta[tid] = ok ? gDelta[q0 + tid] : 0.f;
    }
    __syncthreads();  // also makes sK / sV visible on the first round

    float st[BT / 8][4], dpt[BT / 8][4];
    rows_times_rows_t<D>(st, sK, row0, sQ, lo);    // S^T  = K Q^T
    rows_times_rows_t<D>(dpt, sV, row0, sdO, lo);  // dP^T = V dO^T

    // P^T = exp2(S^T * scale * log2(e) - lse[q]); dS^T = P^T (dP^T - delta[q]).
    // A column of the fragment is a query row: those past nq give 0.
    uint32_t p[BT / 8][2], ds[BT / 8][2];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      const int c0 = nt * 8 + 2 * (lane & 3);
      const bool ok0 = q0 + c0 < nq;
      const bool ok1 = q0 + c0 + 1 < nq;
      const float lse0 = sLse[c0], lse1 = sLse[c0 + 1];
      const float dl0 = sDelta[c0], dl1 = sDelta[c0 + 1];
      const float p0 = ok0 ? exp2f(st[nt][0] * scale_log2 - lse0) : 0.f;
      const float p1 = ok1 ? exp2f(st[nt][1] * scale_log2 - lse1) : 0.f;
      const float p2 = ok0 ? exp2f(st[nt][2] * scale_log2 - lse0) : 0.f;
      const float p3 = ok1 ? exp2f(st[nt][3] * scale_log2 - lse1) : 0.f;
      p[nt][0] = pack_bf16(p0, p1);
      p[nt][1] = pack_bf16(p2, p3);
      ds[nt][0] = pack_bf16(p0 * (dpt[nt][0] - dl0), p1 * (dpt[nt][1] - dl1));
      ds[nt][1] = pack_bf16(p2 * (dpt[nt][2] - dl0), p3 * (dpt[nt][3] - dl1));
    }

    frag_times_rows<D>(dv, p, sdO, lo);  // dV += P^T dO
    frag_times_rows<D>(dk, ds, sQ, lo);  // dK += dS^T Q
  }

  store_rows<D>(gdK, ld_kv, row0, kv_valid, dk, scale);
  store_rows<D>(gdV, ld_kv, row0, kv_valid, dv, 1.f);
}

// dq of one tile of BT query rows of one head. gQ / gdO / gdQ point at the
// tile's first row (row stride ld_q, q_valid rows of it exist), gLse / gDelta
// at the tile's first row statistic; gK / gV at the head's first key/value
// row (row stride ld_kv, nk rows). 128 threads: warp w owns query rows
// 16 w .. 16 w + 15 and holds their dq in registers across the loop over the
// key/value tiles.
template <int D>
__device__ __forceinline__ void bwd_dq_tile(
    const bf16* gQ, const bf16* gdO, bf16* gdQ, int64_t ld_q, const bf16* gK,
    const bf16* gV, int64_t ld_kv, const float* gLse, const float* gDelta,
    int q_valid, int nk, float scale, float scale_log2, unsigned char* smem) {
  constexpr int NTHREADS = 128;
  constexpr int LDS = D + PAD;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BT * LDS;
  bf16* sK = sdO + BT * LDS;
  bf16* sV = sK + BT * LDS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16;
  const LaneOffsets lo(lane);

  load_tile<D, NTHREADS>(sQ, gQ, ld_q, BT, q_valid, tid);
  load_tile<D, NTHREADS>(sdO, gdO, ld_q, BT, q_valid, tid);

  const int r0 = row0 + (lane >> 2);
  const int r1 = r0 + 8;
  const float lse0 = r0 < q_valid ? gLse[r0] : 0.f;
  const float lse1 = r1 < q_valid ? gLse[r1] : 0.f;
  const float dl0 = r0 < q_valid ? gDelta[r0] : 0.f;
  const float dl1 = r1 < q_valid ? gDelta[r1] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int kv0 = 0; kv0 < nk; kv0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, NTHREADS>(sK, gK + kv0 * ld_kv, ld_kv, BT, nk - kv0, tid);
    load_tile<D, NTHREADS>(sV, gV + kv0 * ld_kv, ld_kv, BT, nk - kv0, tid);
    __syncthreads();  // also makes sQ / sdO visible on the first round

    float s[BT / 8][4], dp[BT / 8][4];
    rows_times_rows_t<D>(s, sQ, row0, sK, lo);    // S  = Q K^T
    rows_times_rows_t<D>(dp, sdO, row0, sV, lo);  // dP = dO V^T

    // dS = P (dP - delta), P = exp2(S * scale * log2(e) - lse); keys past nk
    // are outside the softmax and give 0.
    uint32_t ds[BT / 8][2];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      const int key = kv0 + nt * 8 + 2 * (lane & 3);
      const bool ok0 = key < nk;
      const bool ok1 = key + 1 < nk;
      const float p0 = ok0 ? exp2f(s[nt][0] * scale_log2 - lse0) : 0.f;
      const float p1 = ok1 ? exp2f(s[nt][1] * scale_log2 - lse0) : 0.f;
      const float p2 = ok0 ? exp2f(s[nt][2] * scale_log2 - lse1) : 0.f;
      const float p3 = ok1 ? exp2f(s[nt][3] * scale_log2 - lse1) : 0.f;
      ds[nt][0] = pack_bf16(p0 * (dp[nt][0] - dl0), p1 * (dp[nt][1] - dl0));
      ds[nt][1] = pack_bf16(p2 * (dp[nt][2] - dl1), p3 * (dp[nt][3] - dl1));
    }

    frag_times_rows<D>(dq, ds, sK, lo);  // dQ += dS K
  }

  store_rows<D>(gdQ, ld_q, row0, q_valid, dq, scale);
}
