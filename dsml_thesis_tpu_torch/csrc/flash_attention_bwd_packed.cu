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
//
// fp32 at D = 32 (dsml_flash_attention_bwd_packed_f32; mead-128-ldm-f4.yaml's
// fp32 UNet in training): hopper_narrow_f32.cuh on TF32 wgmma, an images
// launch (q, q^T, do, do^T, k, k^T, v rounded to TF32 as tile images in the
// caller's scratch, and delta), a dk/dv grid and a dq grid, one or two
// warpgroups a block against streamed 64-row tiles, dk / dv and dq written
// once in the packed layout. Where Nq and Nk are both at most
// hnarrow_f32::MMA_SYNC_MAX the plan keeps attention_f32_narrow.cuh's three
// TF32 mma.sync launches (delta, dk/dv, dq; the scratch unread). Bound at
// [32, 1024, 5 x 32]: operations on the TF32 tensor cores.
#include "attention_f32_narrow.cuh"
#include "hopper_bwd.cuh"
#include "hopper_narrow_f32.cuh"

namespace {

__global__ void __launch_bounds__(f32narrow::NT)
packed_bwd_dkdv_f32_narrow_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int64_t ld, int nq,
    int nk, int heads, int kv_tiles, float scale_log2, float q_mul,
    float dk_mul) {
  f32narrow::dkdv_block(q, k, v, dout, lse, delta, dk, dv, ld, nq, nk, heads,
                        kv_tiles, scale_log2, q_mul, dk_mul);
}

__global__ void __launch_bounds__(f32narrow::NT)
packed_bwd_dq_f32_narrow_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int64_t ld, int nq, int nk, int heads,
    int q_tiles, float scale_log2, float q_mul, float scale) {
  f32narrow::dq_block(q, k, v, dout, lse, delta, dq, ld, nq, nk, heads,
                      q_tiles, scale_log2, q_mul, scale);
}

__global__ void __launch_bounds__(hnarrow_f32::IMG_NT)
packed_bwd_images_f32_kernel(hnarrow_f32::ImageJobs jobs, int64_t ld,
                             int heads) {
  hnarrow_f32::images(jobs, ld, heads);
}

template <int WGS>
__global__ void __launch_bounds__(WGS * 128, 4 / WGS)
packed_bwd_dkdv_f32_kernel(hnarrow_f32::BwdArgs a) {
  hnarrow_f32::dkdv_block<WGS>(a);
}

template <int WGS>
__global__ void __launch_bounds__(WGS * 128, 4 / WGS)
packed_bwd_dq_f32_kernel(hnarrow_f32::BwdArgs a) {
  hnarrow_f32::dq_block<WGS>(a);
}

struct PackedBwdF32Kernels {
  static auto images() { return packed_bwd_images_f32_kernel; }
  template <int WGS>
  static auto dkdv() {
    return packed_bwd_dkdv_f32_kernel<WGS>;
  }
  template <int WGS>
  static auto dq() {
    return packed_bwd_dq_f32_kernel<WGS>;
  }
};

}  // namespace

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

// The fp32 instantiation (d = 32 only): the same contract on fp32 tensors;
// scratch holds hnarrow_f32::bwd_scratch_floats(b * heads, nq, nk) fp32.
extern "C" int dsml_flash_attention_bwd_packed_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int nq, int nk, int heads, int d, float scale,
    void* scratch, void* stream) {
  if (d != hnarrow_f32::D) return -1;
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  if (hnarrow_f32::keeps_mma_sync(nq, nk))
    return f32narrow::launch_bwd(
        packed_bwd_dkdv_f32_narrow_kernel, packed_bwd_dq_f32_narrow_kernel,
        c(q), c(k), c(v), c(o), c(dout), c(lse), m(delta), m(dq), m(dk),
        m(dv), b, nq, nk, heads, scale * 1.4426950408889634f, 1.f, scale,
        scale, static_cast<cudaStream_t>(stream));
  return hnarrow_f32::launch_bwd<PackedBwdF32Kernels>(
      c(q), c(k), c(v), c(o), c(dout), c(lse), m(delta), m(dq), m(dk), m(dv),
      m(scratch), b, nq, nk, heads, static_cast<int64_t>(heads) * d, scale,
      scale * 1.4426950408889634f, scale, static_cast<cudaStream_t>(stream));
}
