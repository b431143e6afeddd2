// flash_attention_bwd_packed: (dq, dk, dv) of exact-softmax attention on the
// packed layout,
//   q / o / do [B, Nq, H*D], k / v [B, Nk, H*D], lse [B, H, Nq] fp32 (the
//   forward kernel's row log-sum-exp) -> dq [B, Nq, H*D], dk / dv
//   [B, Nk, H*D], bf16, written in place in the packed layout: no head-split
//   copy appears around the backward.
//
// Replaces the TPU kernel
// dsml_thesis_tpu/ops/attention.py:_flash_bwd_kernel_packed
// (flash_attention_bwd_packed). That kernel runs one program per (batch,
// q-block), keeps the batch element's whole K / V resident, walks the heads
// by column slice and carries dk / dv (fp32) from one q-block to the next.
// Here a head is a unit of the grid, addressed by base pointer + h * D with
// the packed row stride H*D (a 64-byte slice of a row at D = 32, whole
// 32-byte sectors), and three launches share the work (attention_bwd.cuh):
// row dots delta = rowsum(do o); a grid over (batch, head, 64 key/value
// rows) that loops over the query tiles and writes dk / dv once; a grid over
// (batch, head, 64 query rows) that loops over the key/value tiles and writes
// dq once. No atomics: equal inputs give equal bits.
//
// Bound: operations (10 * Nq * Nk * H * D a batch element against
// 2 * (4 Nq + 4 Nk) * H * D bytes). This version does 14 (scores and dp are
// formed in both grids) with synchronous single-buffered tile loads and
// mma.sync; at D = 32 the exp2 and the fragment packing weigh as much as the
// tensor-core work. Sharing the recomputation, cp.async / TMA and wgmma are
// later work.
#include "attention_bwd.cuh"

template <int D>
__global__ void __launch_bounds__(128)
packed_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int nq, int nk, int heads,
                       int kv_tiles, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kv0 = (blockIdx.x % kv_tiles) * BT;
  const int64_t bh = blockIdx.x / kv_tiles;
  const int h = static_cast<int>(bh % heads);
  const int64_t b = bh / heads;
  const int64_t ld = static_cast<int64_t>(heads) * D;
  const int64_t q_off = b * nq * ld + h * D;
  const int64_t kv_off = (b * nk + kv0) * ld + h * D;
  bwd_dkdv_tile<D>(q + q_off, dout + q_off, ld, k + kv_off, v + kv_off,
                   dk + kv_off, dv + kv_off, ld, lse + bh * nq,
                   delta + bh * nq, nq, nk - kv0, scale, scale_log2, smem_raw);
}

template <int D>
__global__ void __launch_bounds__(128)
packed_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int nq, int nk, int heads, int q_tiles, float scale,
                     float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = (blockIdx.x % q_tiles) * BT;
  const int64_t bh = blockIdx.x / q_tiles;
  const int h = static_cast<int>(bh % heads);
  const int64_t b = bh / heads;
  const int64_t ld = static_cast<int64_t>(heads) * D;
  const int64_t q_off = (b * nq + q0) * ld + h * D;
  const int64_t kv_off = b * nk * ld + h * D;
  bwd_dq_tile<D>(q + q_off, dout + q_off, dq + q_off, ld, k + kv_off,
                 v + kv_off, ld, lse + bh * nq + q0, delta + bh * nq + q0,
                 nq - q0, nk, scale, scale_log2, smem_raw);
}

template <int D>
static int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                  const bf16* dout, const float* lse, float* delta, bf16* dq,
                  bf16* dk, bf16* dv, int b, int nq, int nk, int heads,
                  float scale, cudaStream_t stream) {
  const int smem = bwd_smem_bytes<D>();
  auto dkdv = packed_bwd_dkdv_kernel<D>;
  auto dqk = packed_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * 1.4426950408889634f;
  const int64_t rows = static_cast<int64_t>(b) * heads * nq;
  bwd_delta_kernel<D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                        stream>>>(o, dout, delta, nq, heads, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles = (nk + BT - 1) / BT;
  dkdv<<<b * heads * kv_tiles, 128, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, nq, nk, heads, kv_tiles, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + BT - 1) / BT;
  dqk<<<b * heads * q_tiles, 128, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, nq, nk, heads, q_tiles, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// delta is [B, H, Nq] fp32 scratch. Returns cudaGetLastError() of the first
// launch that failed (0 = all launched), or -1 for a head width this file
// has no instantiation for.
extern "C" int dsml_flash_attention_bwd_packed(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int nq, int nk, int heads, int d, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (d) {
    case 32:
      return launch<32>(c(q), c(k), c(v), c(o), c(dout), l, dl, m(dq), m(dk),
                        m(dv), b, nq, nk, heads, scale, s);
    case 64:
      return launch<64>(c(q), c(k), c(v), c(o), c(dout), l, dl, m(dq), m(dk),
                        m(dv), b, nq, nk, heads, scale, s);
    default:
      return -1;
  }
}
