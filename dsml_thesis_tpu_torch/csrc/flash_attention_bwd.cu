// flash_attention_bwd: (dq, dk, dv) of exact-softmax attention on split heads,
//   q / o / do [BH, Nq, D], k / v [BH, Nk, D], lse [BH, Nq] fp32 (the forward
//   kernel's row log-sum-exp) -> dq [BH, Nq, D], dk / dv [BH, Nk, D], bf16.
//
// Replaces the TPU kernel dsml_thesis_tpu/ops/attention.py:_flash_bwd_kernel
// (flash_attention_bwd). That kernel keeps a head's whole K / V and a
// [block_q, Nk] score matrix in fast memory, recomputes a row's softmax in
// one pass and carries dk / dv in the output buffer from one q-block of the
// grid to the next. Here nothing carries over between blocks, so three
// launches share the work (attention_bwd.cuh): row dots delta = rowsum(do o),
// then a grid over (head, 64 key/value rows) that loops over the query tiles
// and writes dk / dv once, then a grid over (head, 64 query rows) that loops
// over the key/value tiles and writes dq once. The row statistics come from
// the forward kernel (saved log-sum-exp), not from a second softmax pass.
//
// Bound: operations (10 * Nq * Nk * D a head against 2 * (4 Nq + 4 Nk) * D
// bytes). This version does 14 * Nq * Nk * D (the scores and dp are formed in
// both grids), loads tiles synchronously and single-buffered, and uses
// mma.sync; fusing the two grids' recomputation, cp.async / TMA and wgmma are
// later work. Head widths 32 and 64: at D = 512 a thread's dk and dv
// fragments alone would be 512 registers.
#include "attention_bwd.cuh"

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int nq, int nk, int kv_tiles,
                      float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bh = blockIdx.x / kv_tiles;
  const int kv0 = (blockIdx.x % kv_tiles) * BT;
  const int64_t q_off = bh * nq * D;
  const int64_t kv_off = (bh * nk + kv0) * D;
  bwd_dkdv_tile<D>(q + q_off, dout + q_off, D, k + kv_off, v + kv_off,
                   dk + kv_off, dv + kv_off, D, lse + bh * nq, delta + bh * nq,
                   nq, nk - kv0, scale, scale_log2, smem_raw);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int nq, int nk, int q_tiles, float scale,
                    float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BT;
  const int64_t q_off = (bh * nq + q0) * D;
  const int64_t kv_off = bh * nk * D;
  bwd_dq_tile<D>(q + q_off, dout + q_off, dq + q_off, D, k + kv_off,
                 v + kv_off, D, lse + bh * nq + q0, delta + bh * nq + q0,
                 nq - q0, nk, scale, scale_log2, smem_raw);
}

template <int D>
static int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                  const bf16* dout, const float* lse, float* delta, bf16* dq,
                  bf16* dk, bf16* dv, int bh, int nq, int nk, float scale,
                  cudaStream_t stream) {
  const int smem = bwd_smem_bytes<D>();
  auto dkdv = flash_bwd_dkdv_kernel<D>;
  auto dqk = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * 1.4426950408889634f;
  const int64_t rows = static_cast<int64_t>(bh) * nq;
  bwd_delta_kernel<D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                        stream>>>(o, dout, delta, nq, 1, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles = (nk + BT - 1) / BT;
  dkdv<<<bh * kv_tiles, 128, smem, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                             nq, nk, kv_tiles, scale,
                                             scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + BT - 1) / BT;
  dqk<<<bh * q_tiles, 128, smem, stream>>>(q, k, v, dout, lse, delta, dq, nq,
                                           nk, q_tiles, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// delta is [BH, Nq] fp32 scratch. Returns cudaGetLastError() of the first
// launch that failed (0 = all launched), or -1 for a head width this file
// has no instantiation for.
extern "C" int dsml_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv, int bh, int nq, int nk,
                                        int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (d) {
    case 32:
      return launch<32>(b(q), b(k), b(v), b(o), b(dout), l, dl, m(dq), m(dk),
                        m(dv), bh, nq, nk, scale, s);
    case 64:
      return launch<64>(b(q), b(k), b(v), b(o), b(dout), l, dl, m(dq), m(dk),
                        m(dv), bh, nq, nk, scale, s);
    default:
      return -1;
  }
}
