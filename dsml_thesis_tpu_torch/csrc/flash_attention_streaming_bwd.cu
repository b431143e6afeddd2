// flash_attention_streaming_bwd: (dq, dk, dv) of the streaming attention,
//   q / o / do [BH, Nq, D], k / v [BH, Nk, D] bf16 -> dq [BH, Nq, D],
//   dk / dv [BH, Nk, D] bf16; lse and delta [BH, Nq] fp32 are scratch.
//
// Replaces the TPU kernels of
// dsml_thesis_tpu/ops/attention.py:flash_attention_streaming_bwd
// (_streaming_lse_kernel, _streaming_dq_kernel, _streaming_dkdv_kernel). Its
// residuals are (q, k, v, o) and no row statistic, so the row log-sum-exp is
// recomputed from q and k by a launch of its own, as there. Four launches:
//   lse    one warpgroup a (head, 64 query rows): each thread loads its rows
//          of q straight into registers as the A operand of the score
//          product, multiplied by scale * log2(e) in bf16 on the way, and
//          writes that qs = bf16(q * c) back to device memory; 128-key K
//          tiles (the column panels of hopper_tiles.cuh:HeadSplit, 64 + 16
//          at D = 80) stream through a ring of LSE_STAGES cp.async stages on
//          mbarriers; S = qs K^T on wgmma; an online maximum with the finite
//          mask (keys past Nk score -1e30 and weigh 0) and fp32 sums of the
//          probabilities (hopper_tiles.cuh: softmax_scores, add_row_sums);
//          lse2 = m + log2(max(l, 1e-30)) per row;
//   delta  rowsum(do * o) from the saved output (hopper_bwd.cuh);
//   dk/dv, dq  hopper_bwd.cuh's grids, the packed backward's, on split heads
//          (one head, row stride D) with the scores formed from qs (scale 1),
//          exactly as the forward and the lse launch form them, so that
//          p = exp2(s - lse2) sums to one; dk is taken against the unscaled q.
// qs lives in dq's memory until the dq grid overwrites it: the lse launch
// writes it, the dk/dv grid streams it beside q, and each block of the dq
// grid reads its own 128 rows of it before it writes those rows of dq. No
// output is summed with atomics, and equal inputs give equal bits. dk and dv
// are summed in fp32 over all query rows and cast once.
//
// Where the TPU kernels form dP, dS and their products in fp32, P and dS are
// rounded to bf16 here before the tensor-core products (as in
// flash_attention_bwd.cu).
//
// Bound: operations (10 * Nq * Nk * D a head, plus 2 * Nq * Nk * D for the
// log-sum-exp launch, against 2 * (4 Nq + 4 Nk) * D bytes), and at D = 32
// the exp2 of every score, once in each of the three launches that form the
// scores, on the special-function unit. Head widths 32, 64 and 80 in bf16,
// as flash_attention_bwd_packed.cu.
//
// fp32 at D = 512 (dsml_flash_attention_streaming_bwd_f32; first-stage
// training under DSML_FLASH_STREAMING=1): a log-sum-exp launch of its own
// (64 query rows a block, key tiles of 16 through a cp.async ring, TF32
// products from q times scale * log2(e) in fp32), then the launches of
// flash_attention_bwd's fp32 instantiation (hopper_wide_f32_bwd.cuh: delta,
// the tile images, the scores grid and the gradient GEMMs on TF32 wgmma) with
// q pre-scaled by c = scale * log2(e) where it is rounded: the scores of all
// the launches are formed from the same rounded operands. dk is taken against
// that q * c and multiplied by scale / c at the end, as the earlier fused
// grids did: the two differ by one fp32 rounding of q * c, far under the TF32
// rounding of the operand itself.
//
// fp32 at D = 32 (the same entry; mead-128-ldm-f4.yaml's fp32 UNet in
// training under DSML_ATTN_PACKED=0 DSML_FLASH_STREAMING=1): the packed
// fp32 backward's TF32 wgmma design (hopper_narrow_f32.cuh) on split heads
// (heads = 1, row stride 32) with this kernel's roundings: the images
// launch writes tf32(q * c) (c = scale * log2(e) in fp32, the product in
// fp32) as q's row and transposed images beside do, do^T, k, k^T, v and
// delta; a log-sum-exp grid (lse_block: q's row image as the A operand from
// shared memory, the K row images through the forward's ring of 64-key
// tiles, the -1e30 mask, lse2 = m + log2(max(l, 1e-30))); then the dk/dv
// and dq grids with scale_log2 = 1. Every grid forms its scores from the
// same bits, tf32(q * c) and tf32(k), so p = exp2(s - lse2) sums to one. dk
// is taken against the pre-scaled q and multiplied by scale / c at the end.
// Where Nq and Nk are both at most hnarrow_f32::MMA_SYNC_MAX (the N = 64
// level): attention_f32_narrow.cuh's TF32 mma.sync launches on split heads
// (an lse launch, lse_block, then delta, the dk/dv grid and the dq grid of
// the packed fp32 backward with q_mul = c and scale_log2 = 1), no scratch.
// No atomics: equal inputs give equal bits.
#include "attention_f32.cuh"
#include "attention_f32_narrow.cuh"
#include "hopper_bwd.cuh"
#include "hopper_narrow_f32.cuh"
#include "hopper_wide_f32_bwd.cuh"

namespace {

constexpr int LSE_ROWS = 64;     // query rows a block of the lse launch
constexpr int LSE_NT = 128;      // its threads: one warpgroup
constexpr int LSE_KV = 128;      // keys of a streamed K tile
constexpr int LSE_STAGES = 3;

__host__ __device__ constexpr int lse_wgmma_smem(int d) {
  return 1024 + LSE_STAGES * LSE_KV * 2 * d + 2 * LSE_STAGES * 8;
}

template <int D>
__global__ void __launch_bounds__(LSE_NT)
streaming_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     bf16* __restrict__ qs, float* __restrict__ lse, int nq,
                     int nk, int q_tiles, float q_scale) {
  using namespace hopper;
  constexpr int DA = HeadSplit<D>::A, DB = HeadSplit<D>::B;
  constexpr int STAGE = LSE_KV * 2 * D;   // a K tile: panels A and B
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t ring = cvta(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + LSE_STAGES * STAGE);
  uint64_t* empty = full + LSE_STAGES;

  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * LSE_ROWS;
  const int ntiles = (nk + LSE_KV - 1) / LSE_KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // the thread's two rows
  k += bh * nk * D;

  if (tid == 0) {
    for (int s = 0; s < LSE_STAGES; ++s) {
      mbar_init(&full[s], LSE_NT);
      mbar_init(&empty[s], LSE_NT);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  int issued = 0;
  auto issue_next = [&]() {  // the keys of tile `issued` into its stage
    const int i = issued++;
    const int s = i % LSE_STAGES;
    if (i >= LSE_STAGES) mbar_wait(&empty[s], ((i / LSE_STAGES) - 1) & 1);
    const int kv0 = i * LSE_KV;
    load_head_async<D, LSE_KV, LSE_NT>(
        ring + s * STAGE, k + static_cast<int64_t>(kv0) * D, D, nk - kv0,
        tid);
    cp_async_arrive(&full[s]);
  };
  while (issued < LSE_STAGES && issued < ntiles) issue_next();

  // qs = q times the factor in bf16, as the A fragment of k16 step s (rows
  // r0 and r0 + 8, columns 16 s + 2 (lane % 4) + {0, 1} and + 8; rows past
  // nq are zeros), and into qs for the rows that exist
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat162 c2 = __float2bfloat162_rn(q_scale);
    const int64_t row0 = bh * nq + q0 + r0;
    const bool ok0 = q0 + r0 < nq, ok1 = q0 + r0 + 8 < nq;
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (e & 1) ? ok1 : ok0;
        const int64_t at = (row0 + ((e & 1) ? 8 : 0)) * D + 16 * s +
                           ((e & 2) ? 8 : 0) + 2 * (lane & 3);
        __nv_bfloat162 x = __float2bfloat162_rn(0.f);
        if (ok) x = *reinterpret_cast<const __nv_bfloat162*>(q + at);
        x = __hmul2(x, c2);
        if (ok) *reinterpret_cast<__nv_bfloat162*>(qs + at) = x;
        qa[s][e] = *reinterpret_cast<uint32_t*>(&x);
      }
    }
  }

  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % LSE_STAGES;
    mbar_wait(&full[s], (t / LSE_STAGES) & 1);
    fence_async_shared();
    const uint32_t ka = ring + s * STAGE, kb = ka + LSE_KV * 2 * DA;
    float sc[LSE_KV / 2];  // S = qs K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DA / 16; ++kk)
      wgmma_rs<LSE_KV, 0>(sc, qa[kk], desc_k<2 * DA>(ka + 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DB / 16; ++kk)
      wgmma_rs<LSE_KV, 0>(sc, qa[DA / 16 + kk], desc_k<32>(kb + 32 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    // the K tile is read: release its stage before the softmax
    mbar_arrive(&empty[s]);
    if (issued < ntiles) issue_next();
    float alpha0, alpha1;
    softmax_scores<LSE_KV, true>(sc, m0, m1, alpha0, alpha1, t * LSE_KV, nk,
                                 1.f, lane);
    l0 *= alpha0;
    l1 *= alpha1;
    add_row_sums<LSE_KV>(sc, l0, l1);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if ((lane & 3) == 0) {
    float* row_lse = lse + bh * nq + q0;
    if (q0 + r0 < nq) row_lse[r0] = m0 + log2f(fmaxf(l0, 1e-30f));
    if (q0 + r0 + 8 < nq) row_lse[r0 + 8] = m1 + log2f(fmaxf(l1, 1e-30f));
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, float* lse, float* delta, bf16* dq, bf16* dk,
           bf16* dv, int bh, int nq, int nk, float scale, float q_scale,
           cudaStream_t stream) {
  if (bh < 1 || nq < 1 || nk < 1) return -1;
  auto kernel = streaming_lse_kernel<D>;
  const int smem = lse_wgmma_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + LSE_ROWS - 1) / LSE_ROWS;
  bf16* qs = dq;  // q * c until the dq grid writes dq over it
  kernel<<<bh * q_tiles, LSE_NT, smem, stream>>>(q, k, qs, lse, nq, nk,
                                                 q_tiles, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return hbwd::launch<D, true>(q, qs, k, v, o, dout, lse, delta, dq, dk, dv,
                               bh, nq, nk, 1, scale, 1.f, stream);
}

// The row log-sum-exp at D = 512: block (bh, 64-row q-tile) of 4 warps, q
// times q_scale in fp32 rounded to TF32 in shared memory, 16-key K tiles
// through two cp.async stages (rounded to TF32 in registers), fragments by
// ldmatrix, each score's 512-long sum in four interleaved chains (added
// (c0 + c1) + (c2 + c3)) so that a warp has four products in flight; keys
// past nk at -1e30 with probability 0. lse = m + log2(max(l, 1e-30)) in
// the base-2 domain. (The first design loaded each K tile synchronously
// and summed in one chain: 1.06 against 0.33 ms at [16, 1, 1024, 512],
// tools/variants.py --f32-attn, H100 SXM at 700 W.)
constexpr int LSE_RING_STAGES = 2;
constexpr int lse_f32_smem_bytes() {
  return (f32attn::FBM + LSE_RING_STAGES * f32attn::FBN) * f32attn::LDS *
         static_cast<int>(sizeof(uint32_t));
}

__global__ void __launch_bounds__(128)
streaming_lse_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k, float* __restrict__ lse,
                         int nq, int nk, int q_tiles, float q_scale) {
  using namespace f32attn;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sQ = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* sK = sQ + FBM * LDS;   // [stage][FBN][LDS], raw fp32
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * FBM;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = (tid >> 5) * 16;
  const int t = lane_t();
  k += bh * nk * D;
  auto issue = [&](int kv0, int st) {
    uint32_t* dst = sK + st * FBN * LDS;
#pragma unroll
    for (int x = 0; x < FBN * (D / 4) / 128; ++x) {
      const int i = tid + 128 * x;
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool ok = kv0 + r < nk;
      hopper::cp_async16(hopper::cvta(dst + r * LDS + c),
                         ok ? k + static_cast<int64_t>(kv0 + r) * D + c : k,
                         ok);
    }
    cp_commit();
  };
  issue(0, 0);
  load_tile_tf32<128>(sQ, q + (bh * nq + q0) * D, FBM, nq - q0, tid, q_scale);
  // ldmatrix lane addresses: A (rows row0 .., matrices (rows + 8 (m % 2),
  // columns + 4 (m / 2))) and B (matrices (rows + 8 (m / 2), columns +
  // 4 (m % 2)): B0 / B1 of n8 tile 0, then of tile 1)
  const uint32_t a_at =
      hopper::cvta(sQ + (row0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS +
                   (lane >> 4) * 4);
  const uint32_t b_off =
      (((lane >> 4) * 8 + (lane & 7)) * LDS + ((lane >> 3) & 1) * 4) * 4;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  const int tiles = (nk + FBN - 1) / FBN;
  for (int j = 0; j < tiles; ++j) {
    const int st = j % LSE_RING_STAGES;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // tile j (and sQ) visible; every warp done with j - 1
    if (j + 1 < tiles) issue((j + 1) * FBN, (j + 1) % LSE_RING_STAGES);
    const uint32_t b_at = hopper::cvta(sK + st * FBN * LDS) + b_off;
    float c4[4][2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        c4[c][nt][0] = c4[c][nt][1] = c4[c][nt][2] = c4[c][nt][3] = 0.f;
#pragma unroll 2
    for (int kb = 0; kb < D / 8; kb += 4) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t a[4], b[4];
        ldsm_x4(a, a_at + (kb + c) * 32);
        ldsm_x4(b, b_at + (kb + c) * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = tf32_mul(b[i], 1.f);
        mma_tf32(c4[c][0], a, b[0], b[1]);
        mma_tf32(c4[c][1], a, b[2], b[3]);
      }
    }
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = (c4[0][nt][e] + c4[1][nt][e]) +
                   (c4[2][nt][e] + c4[3][nt][e]);
    const int kv0 = j * FBN;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
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
    for (int nt = 0; nt < 2; ++nt) {
      const bool ok0 = kv0 + nt * 8 + 2 * t < nk;
      const bool ok1 = kv0 + nt * 8 + 2 * t + 1 < nk;
      l0 += (ok0 ? exp2f(s[nt][0] - m0) : 0.f) +
            (ok1 ? exp2f(s[nt][1] - m0) : 0.f);
      l1 += (ok0 ? exp2f(s[nt][2] - m1) : 0.f) +
            (ok1 ? exp2f(s[nt][3] - m1) : 0.f);
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    const int r0 = row0 + lane_g();
    float* row_lse = lse + bh * nq + q0;
    if (q0 + r0 < nq) row_lse[r0] = m0 + log2f(fmaxf(l0, 1e-30f));
    if (q0 + r0 + 8 < nq) row_lse[r0 + 8] = m1 + log2f(fmaxf(l1, 1e-30f));
  }
}

__global__ void __launch_bounds__(hwide_f32_bwd::NT)
streaming_bwd_wide_f32_images_kernel(
    const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ qt, float* __restrict__ dot, float* __restrict__ kt,
    float* __restrict__ rows, int nq, int nk, int nqp, int nkp, float q_mul) {
  hwide_f32_bwd::images(q, dout, k, v, qt, dot, kt, rows, nq, nk, nqp, nkp,
                        q_mul);
}

__global__ void __launch_bounds__(hwide_f32_bwd::NT, 1)
streaming_bwd_wide_f32_scores_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ pt, float* __restrict__ dst, float* __restrict__ ds,
    int nq, int nk, int nqp, int chunk, int c0, float scale_log2) {
  hwide_f32_bwd::scores(q, k, v, dout, lse, delta, pt, dst, ds, nq, nk, nqp,
                        chunk, c0, scale_log2);
}

__global__ void __launch_bounds__(hwide_f32_bwd::NT, 1)
streaming_bwd_wide_f32_grads_kernel(
    const float* __restrict__ pt, const float* __restrict__ dst,
    const float* __restrict__ ds, const float* __restrict__ dot,
    const float* __restrict__ qt, const float* __restrict__ kt,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    int nq, int nk, int nqp, int nkp, int chunk, int c0, int cw, float scale,
    float dk_mul) {
  hwide_f32_bwd::grads(pt, dst, ds, dot, qt, kt, dq, dk, dv, nq, nk, nqp, nkp,
                       chunk, c0, cw, scale, dk_mul);
}

__global__ void __launch_bounds__(f32narrow::NT)
streaming_lse_f32_narrow_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                float* __restrict__ lse, int nq, int nk,
                                int q_tiles, float q_scale) {
  f32narrow::lse_block(q, k, lse, nq, nk, q_tiles, q_scale);
}

__global__ void __launch_bounds__(f32narrow::NT)
streaming_bwd_dkdv_f32_narrow_kernel(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     float* __restrict__ dk,
                                     float* __restrict__ dv, int64_t ld,
                                     int nq, int nk, int heads, int kv_tiles,
                                     float scale_log2, float q_mul,
                                     float dk_mul) {
  f32narrow::dkdv_block(q, k, v, dout, lse, delta, dk, dv, ld, nq, nk, heads,
                        kv_tiles, scale_log2, q_mul, dk_mul);
}

__global__ void __launch_bounds__(f32narrow::NT)
streaming_bwd_dq_f32_narrow_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   float* __restrict__ dq, int64_t ld, int nq,
                                   int nk, int heads, int q_tiles,
                                   float scale_log2, float q_mul,
                                   float scale) {
  f32narrow::dq_block(q, k, v, dout, lse, delta, dq, ld, nq, nk, heads,
                      q_tiles, scale_log2, q_mul, scale);
}

int launch_f32_narrow(const float* q, const float* k, const float* v,
                      const float* o, const float* dout, float* lse,
                      float* delta, float* dq, float* dk, float* dv, int bh,
                      int nq, int nk, float scale, float q_scale,
                      cudaStream_t stream) {
  using f32narrow::ROWS;
  const int q_tiles = (nq + ROWS - 1) / ROWS;
  streaming_lse_f32_narrow_kernel<<<bh * q_tiles, f32narrow::NT, 0, stream>>>(
      q, k, lse, nq, nk, q_tiles, q_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return f32narrow::launch_bwd(
      streaming_bwd_dkdv_f32_narrow_kernel, streaming_bwd_dq_f32_narrow_kernel,
      q, k, v, o, dout, lse, delta, dq, dk, dv, bh, nq, nk, 1, 1.f, q_scale,
      scale / q_scale, scale, stream);
}

// fp32 D = 32 past the N = 64 level: hopper_narrow_f32.cuh's images launch,
// log-sum-exp grid and backward grids, kernels of their own so that a
// profile tells row 5 from rows 7 and 8
__global__ void __launch_bounds__(hnarrow_f32::IMG_NT)
streaming_bwd_images_f32_kernel(hnarrow_f32::ImageJobs jobs, int64_t ld,
                                int heads) {
  hnarrow_f32::images(jobs, ld, heads);
}

template <int WGS>
__global__ void __launch_bounds__(WGS * 128, hnarrow_f32::lse_min_blocks(WGS))
streaming_bwd_lse_f32_kernel(hnarrow_f32::LseArgs a) {
  hnarrow_f32::lse_block<WGS>(a);
}

template <int WGS>
__global__ void __launch_bounds__(WGS * 128, 4 / WGS)
streaming_bwd_dkdv_f32_kernel(hnarrow_f32::BwdArgs a) {
  hnarrow_f32::dkdv_block<WGS>(a);
}

template <int WGS>
__global__ void __launch_bounds__(WGS * 128, 4 / WGS)
streaming_bwd_dq_f32_kernel(hnarrow_f32::BwdArgs a) {
  hnarrow_f32::dq_block<WGS>(a);
}

struct StreamingBwdF32Kernels {
  static auto images() { return streaming_bwd_images_f32_kernel; }
  template <int WGS>
  static auto lse() {
    return streaming_bwd_lse_f32_kernel<WGS>;
  }
  template <int WGS>
  static auto dkdv() {
    return streaming_bwd_dkdv_f32_kernel<WGS>;
  }
  template <int WGS>
  static auto dq() {
    return streaming_bwd_dq_f32_kernel<WGS>;
  }
};

}  // namespace

// The fp32 instantiations (d = 32 and 512): the same contract as
// dsml_flash_attention_streaming_bwd on fp32 tensors, q_scale = scale *
// log2(e) in fp32; at d = 512 scratch holds the tile images and a chunk's
// P^T, dS^T and dS (ops/attention.py:wide_f32_bwd_plan), at d = 32
// hnarrow_f32::bwd_scratch_floats(bh, nq, nk) (narrow_f32_plan; unread
// where both lengths are at most hnarrow_f32::MMA_SYNC_MAX).
extern "C" int dsml_flash_attention_streaming_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* lse, void* delta, void* dq, void* dk, void* dv,
    int bh, int nq, int nk, int d, float scale, float q_scale, void* scratch,
    void* stream) {
  using namespace f32attn;
  if (bh < 1 || nq < 1 || nk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == hnarrow_f32::D && !hnarrow_f32::keeps_mma_sync(nq, nk))
    return hnarrow_f32::launch_bwd<StreamingBwdF32Kernels, true>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), nullptr, static_cast<float*>(delta),
        static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), static_cast<float*>(scratch), bh, nq, nk, 1,
        hnarrow_f32::D, scale, 1.f, scale / q_scale, s, q_scale,
        static_cast<float*>(lse));
  if (d == f32narrow::D)
    return launch_f32_narrow(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), static_cast<float*>(lse),
        static_cast<float*>(delta), static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), bh, nq, nk, scale,
        q_scale, s);
  if (d != D || scratch == nullptr) return -1;
  const int smem = lse_f32_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      streaming_lse_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + FBM - 1) / FBM;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  float* l = static_cast<float*>(lse);
  streaming_lse_f32_kernel<<<bh * q_tiles, 128, smem, s>>>(qf, kf, l, nq, nk,
                                                            q_tiles, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  return hwide_f32_bwd::launch(
      streaming_bwd_wide_f32_images_kernel,
      streaming_bwd_wide_f32_scores_kernel,
      streaming_bwd_wide_f32_grads_kernel, qf, kf, c(v), c(o), c(dout), l,
      m(delta), m(dq), m(dk), m(dv), m(scratch), bh, nq, nk, 1.f, q_scale,
      scale, scale / q_scale, s);
}

// q_scale is scale * log2(e) as rounded to bf16 by the caller. Returns
// cudaGetLastError() of the first launch that failed (0 = all launched), or
// -1 for a shape this file does not take (a head width other than 32, 64,
// 80).
extern "C" int dsml_flash_attention_streaming_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* lse, void* delta, void* dq, void* dk, void* dv,
    int bh, int nq, int nk, int d, float scale, float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (d) {
    case 32:
      return launch<32>(c(q), c(k), c(v), c(o), c(dout), l, dl, m(dq), m(dk),
                        m(dv), bh, nq, nk, scale, q_scale, s);
    case 64:
      return launch<64>(c(q), c(k), c(v), c(o), c(dout), l, dl, m(dq), m(dk),
                        m(dv), bh, nq, nk, scale, q_scale, s);
    case 80:
      return launch<80>(c(q), c(k), c(v), c(o), c(dout), l, dl, m(dq), m(dk),
                        m(dv), bh, nq, nk, scale, q_scale, s);
    default:
      return -1;
  }
}
