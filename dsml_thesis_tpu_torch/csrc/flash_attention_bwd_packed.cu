// flash_attention_bwd_packed: (dq, dk, dv) of exact-softmax attention on the
// packed layout,
//   q / o / do [B, Nq, H*D], k / v [B, Nk, H*D], lse [B, H, Nq] fp32 (the
//   forward kernel's row log-sum-exp in the scaled base-2 domain) -> dq
//   [B, Nq, H*D], dk / dv [B, Nk, H*D], bf16, written in place in the packed
//   layout: no head-split copy appears around the backward.
//
// Replaces the TPU kernel
// dsml_thesis_tpu/ops/attention.py:_flash_bwd_kernel_packed
// (flash_attention_bwd_packed). That kernel runs one program per (batch,
// q-block), keeps the batch element's whole K / V resident, walks the heads
// by column slice and carries dk / dv (fp32) from one q-block to the next.
// Blocks of a GPU run in no order and carry nothing over, so the work is
// cut in three launches: row dots delta = rowsum(do o); a grid over (batch,
// head, 128 key/value rows) that streams the query tiles and writes dk / dv
// once; a grid over (batch, head, 128 query rows) that streams the
// key/value tiles and writes dq once. Those are hopper_bwd.cuh's grids,
// which the split-head and streaming backwards (flash_attention_bwd.cu,
// flash_attention_streaming_bwd.cu) launch too; here with the scores
// (q k^T) * scale * log2(e) in fp32, as the packed forward kernel forms them.
// Head widths 32, 64 and 80 (the level-0 heads of
// mead-256-ldm-f4-fullattn-dh64.yaml: 64 + 16 column panels).
//
// Bound on this card: operations (0.22 ms at [8, 4096, 5 x 32] at 989
// TFLOP/s); at D = 32 each score also costs an exp2 in each grid (671 M at
// that shape, 0.18 ms a grid on the special-function units alone).
#include "hopper_bwd.cuh"

// delta is [B, H, Nq] fp32 scratch. Returns cudaGetLastError() of the first
// launch that failed (0 = all launched), or -1 for a shape this file does
// not take (a head width other than 32, 64, 80).
extern "C" int dsml_flash_attention_bwd_packed(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int nq, int nk, int heads, int d, float scale,
    void* stream) {
  if (b < 1 || nq < 1 || nk < 1 || heads < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const float scale_log2 = scale * 1.4426950408889634f;
  switch (d) {
    case 32:
      return hbwd::launch<32, false>(c(q), c(q), c(k), c(v), c(o), c(dout), l,
                                     dl, m(dq), m(dk), m(dv), b, nq, nk,
                                     heads, scale, scale_log2, s);
    case 64:
      return hbwd::launch<64, false>(c(q), c(q), c(k), c(v), c(o), c(dout), l,
                                     dl, m(dq), m(dk), m(dv), b, nq, nk,
                                     heads, scale, scale_log2, s);
    case 80:
      return hbwd::launch<80, false>(c(q), c(q), c(k), c(v), c(o), c(dout), l,
                                     dl, m(dq), m(dk), m(dv), b, nq, nk,
                                     heads, scale, scale_log2, s);
    default:
      return -1;
  }
}
