// flash_attention_streaming_bwd: (dq, dk, dv) of the streaming attention,
//   q / o / do [BH, Nq, D], k / v [BH, Nk, D] bf16 -> dq [BH, Nq, D],
//   dk / dv [BH, Nk, D] bf16; lse and delta [BH, Nq] fp32 are scratch.
//
// Replaces the TPU kernels of
// dsml_thesis_tpu/ops/attention.py:flash_attention_streaming_bwd
// (_streaming_lse_kernel, _streaming_dq_kernel, _streaming_dkdv_kernel). Its
// residuals are (q, k, v, o) and no row statistic, so the row log-sum-exp is
// recomputed from q and k by a launch of its own, as there. Four launches:
//   lse    a block per (head, 64 query rows) streams the K tiles under an
//          online maximum / sum (fp32 probabilities) and writes
//          lse2 = m + log2(max(l, 1e-30)) per row;
//   delta  rowsum(do * o) from the saved output (attention_bwd.cuh);
//   dk/dv  a block per (head, 64 key/value rows) loops over the query tiles;
//   dq     a block per (head, 64 query rows) loops over the key/value tiles
// (the two grids of attention_bwd.cuh with PRESCALED_Q: the scores are formed
// from q times scale * log2(e) rounded to bf16, exactly as the forward and
// the lse launch form them, so that p = exp2(s - lse2) sums to one). The TPU
// kernels carry dq, dk and dv in scratch from one sequential grid step to
// the next; here each output tile belongs to one block that loops, nothing
// is summed with atomics, and equal inputs give equal bits. dk and dv are
// summed in fp32 over all query rows and cast once.
//
// Where the TPU kernels form dP, dS and their products in fp32, P and dS are
// rounded to bf16 here before the tensor-core products (as in
// flash_attention_bwd.cu).
//
// Bound: operations (10 * Nq * Nk * D a head, plus 2 * Nq * Nk * D for the
// log-sum-exp launch, against 2 * (4 Nq + 4 Nk) * D bytes). This version does
// 16 (scores and dp are formed in both grids), loads tiles synchronously and
// uses mma.sync. Head widths 32 and 64, as flash_attention_bwd.cu.
#include "attention_bwd.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(128)
streaming_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     float* __restrict__ lse, int nq, int nk, int q_tiles,
                     float q_scale) {
  constexpr int NTHREADS = 128;
  constexpr int LDS = D + PAD;
  __shared__ __align__(16) unsigned char smem_raw[2 * BT * LDS * sizeof(bf16)];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BT * LDS;
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * 16;
  const LaneOffsets lo(lane);
  k += bh * nk * D;

  load_tile_scaled<D, NTHREADS>(sQ, q + (bh * nq + q0) * D, D, BT, nq - q0,
                                tid, __float2bfloat16(q_scale));
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  for (int kv0 = 0; kv0 < nk; kv0 += BT) {
    __syncthreads();  // the previous tile's readers are done; sQ is visible
    load_tile<D, NTHREADS>(sK, k + static_cast<int64_t>(kv0) * D, D, BT,
                           nk - kv0, tid);
    __syncthreads();
    float s[BT / 8][4];
    rows_times_rows_t<D>(s, sQ, row0, sK, lo);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kv0 + nt * 8 + 2 * (lane & 3) + (j & 1);
        if (key >= nk) s[nt][j] = -1e30f;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    l0 *= exp2f(m0 - mx0);
    l1 *= exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      const int key = kv0 + nt * 8 + 2 * (lane & 3);
      const bool ok0 = key < nk;
      const bool ok1 = key + 1 < nk;
      l0 += (ok0 ? exp2f(s[nt][0] - m0) : 0.f) +
            (ok1 ? exp2f(s[nt][1] - m0) : 0.f);
      l1 += (ok0 ? exp2f(s[nt][2] - m1) : 0.f) +
            (ok1 ? exp2f(s[nt][3] - m1) : 0.f);
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if ((lane & 3) == 0) {
    const int r0 = row0 + (lane >> 2);
    const int r1 = r0 + 8;
    float* row_lse = lse + bh * nq + q0;
    if (q0 + r0 < nq) row_lse[r0] = m0 + log2f(fmaxf(l0, 1e-30f));
    if (q0 + r1 < nq) row_lse[r1] = m1 + log2f(fmaxf(l1, 1e-30f));
  }
}

template <int D>
__global__ void __launch_bounds__(128)
streaming_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int nq, int nk, int kv_tiles,
                      float scale, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bh = blockIdx.x / kv_tiles;
  const int kv0 = (blockIdx.x % kv_tiles) * BT;
  const int64_t q_off = bh * nq * D;
  const int64_t kv_off = (bh * nk + kv0) * D;
  bwd_dkdv_tile<D, true>(q + q_off, dout + q_off, D, k + kv_off, v + kv_off,
                         dk + kv_off, dv + kv_off, D, lse + bh * nq,
                         delta + bh * nq, nq, nk - kv0, scale, 1.f, smem_raw,
                         q_scale);
}

template <int D>
__global__ void __launch_bounds__(128)
streaming_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int nq, int nk, int q_tiles, float scale, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BT;
  const int64_t q_off = (bh * nq + q0) * D;
  const int64_t kv_off = bh * nk * D;
  bwd_dq_tile<D, true>(q + q_off, dout + q_off, dq + q_off, D, k + kv_off,
                       v + kv_off, D, lse + bh * nq + q0, delta + bh * nq + q0,
                       nq - q0, nk, scale, 1.f, smem_raw, q_scale);
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, float* lse, float* delta, bf16* dq, bf16* dk,
           bf16* dv, int bh, int nq, int nk, float scale, float q_scale,
           cudaStream_t stream) {
  if (bh < 1 || nq < 1 || nk < 1) return -1;
  const int smem = bwd_smem_bytes<D, true>();
  auto dkdv = streaming_dkdv_kernel<D>;
  auto dqk = streaming_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + BT - 1) / BT;
  const int kv_tiles = (nk + BT - 1) / BT;
  streaming_lse_kernel<D><<<bh * q_tiles, 128, 0, stream>>>(q, k, lse, nq, nk,
                                                            q_tiles, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(bh) * nq;
  bwd_delta_kernel<D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                        stream>>>(o, dout, delta, nq, 1, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<bh * kv_tiles, 128, smem, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                             nq, nk, kv_tiles, scale, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<bh * q_tiles, 128, smem, stream>>>(q, k, v, dout, lse, delta, dq, nq,
                                           nk, q_tiles, scale, q_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_scale is scale * log2(e) as rounded to bf16 by the caller. Returns
// cudaGetLastError() of the first launch that failed (0 = all launched), or
// -1 for a head width this file has no instantiation for.
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
    default:
      return -1;
  }
}
