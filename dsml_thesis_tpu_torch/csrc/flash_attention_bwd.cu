// flash_attention_bwd: (dq, dk, dv) of exact-softmax attention on split heads,
//   q / o / do [BH, Nq, D], k / v [BH, Nk, D], lse [BH, Nq] fp32 (the forward
//   kernel's row log-sum-exp) -> dq [BH, Nq, D], dk / dv [BH, Nk, D], bf16.
//
// Replaces the TPU kernel dsml_thesis_tpu/ops/attention.py:_flash_bwd_kernel
// (flash_attention_bwd). That kernel keeps a head's whole K / V and a
// [block_q, Nk] score matrix in fast memory, recomputes a row's softmax in
// one pass and carries dk / dv in the output buffer from one q-block of the
// grid to the next. Here nothing carries over between blocks, so three
// launches share the work: row dots delta = rowsum(do o), then a grid over
// (head, 128 key/value rows) that streams the query tiles and writes dk / dv
// once, then a grid over (head, 128 query rows) that streams the key/value
// tiles and writes dq once. The row statistics come from the forward kernel
// (saved log-sum-exp), not from a second softmax pass.
//
// bf16 at D = 32 / 64 / 80: the packed backward's grids (hopper_bwd.cuh:
// wgmma, cp.async rings on mbarriers; 80-wide heads as 64 + 16 column
// panels) on split heads, which are the packed layout with one head of row
// stride D; the scores (q k^T) * scale * log2(e) in fp32, as the forward
// (flash_attention.cu, on hopper_fwd.cuh) formed them for its log-sum-exp.
// Bound: operations (10 * Nq * Nk * D a head against 2 * (4 Nq + 4 Nk) * D
// bytes); the grids execute 14 (the scores and dp are formed in both).
//
// fp32 at D = 512 (dsml_flash_attention_bwd_f32; first-stage training):
// hopper_wide_f32_bwd.cuh on TF32 wgmma: delta, the q^T / do^T / k^T tile
// images, then a scores grid (S and dP of 128 x 128 tiles, P and dS into
// scratch) and one grid of the three gradient GEMMs a chunk of keys; 10 N^2 D
// operations a head, none formed twice. The scratch is the wrapper's
// (ops/attention.py:wide_f32_bwd_plan).
//
// fp32 at D = 32 (the same entry; mead-128-ldm-f4.yaml's fp32 UNet under
// DSML_ATTN_PACKED=0): the packed fp32 backward's TF32 wgmma design
// (hopper_narrow_f32.cuh) on split heads (heads = 1, row stride 32): an
// images launch writes q, do, k, v rounded to TF32 and q^T, do^T, k^T as
// tile images into the caller's scratch (hnarrow_f32::bwd_scratch_floats)
// and delta, then a dk/dv grid and a dq grid, two warpgroups own 128 rows
// (one where the owned length is at most 64) against streamed 64-row tiles;
// the scores (q k^T) * scale * log2(e) against the forward's base-2 lse.
// Where Nq and Nk are both at most hnarrow_f32::MMA_SYNC_MAX (the N = 64
// level) the packed fp32 backward's three TF32 mma.sync launches
// (attention_f32_narrow.cuh: delta, dk/dv, dq) on one head, no scratch.
// Bound at [32, 5, 1024, 32]: operations on the TF32 tensor cores.
#include "attention_f32_narrow.cuh"
#include "hopper_bwd.cuh"
#include "hopper_narrow_f32.cuh"
#include "hopper_wide_f32_bwd.cuh"

namespace {

__global__ void __launch_bounds__(f32narrow::NT)
flash_bwd_dkdv_f32_narrow_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv, int64_t ld, int nq,
                                 int nk, int heads, int kv_tiles,
                                 float scale_log2, float q_mul,
                                 float dk_mul) {
  f32narrow::dkdv_block(q, k, v, dout, lse, delta, dk, dv, ld, nq, nk, heads,
                        kv_tiles, scale_log2, q_mul, dk_mul);
}

__global__ void __launch_bounds__(f32narrow::NT)
flash_bwd_dq_f32_narrow_kernel(const float* __restrict__ q,
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

__global__ void __launch_bounds__(hwide_f32_bwd::NT)
flash_bwd_wide_f32_images_kernel(
    const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ qt, float* __restrict__ dot, float* __restrict__ kt,
    float* __restrict__ rows, int nq, int nk, int nqp, int nkp, float q_mul) {
  hwide_f32_bwd::images(q, dout, k, v, qt, dot, kt, rows, nq, nk, nqp, nkp,
                        q_mul);
}

__global__ void __launch_bounds__(hwide_f32_bwd::NT, 1)
flash_bwd_wide_f32_scores_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ pt, float* __restrict__ dst, float* __restrict__ ds,
    int nq, int nk, int nqp, int chunk, int c0, float scale_log2) {
  hwide_f32_bwd::scores(q, k, v, dout, lse, delta, pt, dst, ds, nq, nk, nqp,
                        chunk, c0, scale_log2);
}

__global__ void __launch_bounds__(hwide_f32_bwd::NT, 1)
flash_bwd_wide_f32_grads_kernel(
    const float* __restrict__ pt, const float* __restrict__ dst,
    const float* __restrict__ ds, const float* __restrict__ dot,
    const float* __restrict__ qt, const float* __restrict__ kt,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    int nq, int nk, int nqp, int nkp, int chunk, int c0, int cw, float scale,
    float dk_mul) {
  hwide_f32_bwd::grads(pt, dst, ds, dot, qt, kt, dq, dk, dv, nq, nk, nqp, nkp,
                       chunk, c0, cw, scale, dk_mul);
}

// fp32 D = 32 on split heads: hopper_narrow_f32.cuh's images launch and
// backward grids, kernels of their own so that a profile tells row 7 from
// row 8
__global__ void __launch_bounds__(hnarrow_f32::IMG_NT)
split_bwd_images_f32_kernel(hnarrow_f32::ImageJobs jobs, int64_t ld,
                            int heads) {
  hnarrow_f32::images(jobs, ld, heads);
}

template <int WGS>
__global__ void __launch_bounds__(WGS * 128, 4 / WGS)
split_bwd_dkdv_f32_kernel(hnarrow_f32::BwdArgs a) {
  hnarrow_f32::dkdv_block<WGS>(a);
}

template <int WGS>
__global__ void __launch_bounds__(WGS * 128, 4 / WGS)
split_bwd_dq_f32_kernel(hnarrow_f32::BwdArgs a) {
  hnarrow_f32::dq_block<WGS>(a);
}

struct SplitBwdF32Kernels {
  static auto images() { return split_bwd_images_f32_kernel; }
  template <int WGS>
  static auto dkdv() {
    return split_bwd_dkdv_f32_kernel<WGS>;
  }
  template <int WGS>
  static auto dq() {
    return split_bwd_dq_f32_kernel<WGS>;
  }
};

}  // namespace

// delta is [BH, Nq] fp32 scratch. Returns cudaGetLastError() of the first
// launch that failed (0 = all launched), or -1 for a shape this file does
// not take (a head width other than 32, 64, 80).
extern "C" int dsml_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv, int bh, int nq, int nk,
                                        int d, float scale, void* stream) {
  if (bh < 1 || nq < 1 || nk < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const float scale_log2 = scale * 1.4426950408889634f;
  switch (d) {
    case 32:
      return hbwd::launch<32, false>(c(q), c(q), c(k), c(v), c(o), c(dout), l,
                                     dl, m(dq), m(dk), m(dv), bh, nq, nk, 1,
                                     scale, scale_log2, s);
    case 64:
      return hbwd::launch<64, false>(c(q), c(q), c(k), c(v), c(o), c(dout), l,
                                     dl, m(dq), m(dk), m(dv), bh, nq, nk, 1,
                                     scale, scale_log2, s);
    case 80:
      return hbwd::launch<80, false>(c(q), c(q), c(k), c(v), c(o), c(dout), l,
                                     dl, m(dq), m(dk), m(dv), bh, nq, nk, 1,
                                     scale, scale_log2, s);
    default:
      return -1;
  }
}

// The fp32 instantiations (d = 512 and 32): the same contract as
// dsml_flash_attention_bwd on fp32 tensors; at d = 512 scratch holds the
// tile images and a chunk's P^T, dS^T and dS (ops/attention.py:
// wide_f32_bwd_plan), at d = 32 hnarrow_f32::bwd_scratch_floats(bh, nq, nk)
// (narrow_f32_plan; unread where both lengths are at most
// hnarrow_f32::MMA_SYNC_MAX).
extern "C" int dsml_flash_attention_bwd_f32(const void* q, const void* k,
                                            const void* v, const void* o,
                                            const void* dout, const void* lse,
                                            void* delta, void* dq, void* dk,
                                            void* dv, int bh, int nq, int nk,
                                            int d, float scale, void* scratch,
                                            void* stream) {
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  if (d == f32narrow::D && hnarrow_f32::keeps_mma_sync(nq, nk))
    return f32narrow::launch_bwd(
        flash_bwd_dkdv_f32_narrow_kernel, flash_bwd_dq_f32_narrow_kernel,
        c(q), c(k), c(v), c(o), c(dout), c(lse), m(delta), m(dq), m(dk),
        m(dv), bh, nq, nk, 1, scale * 1.4426950408889634f, 1.f, scale, scale,
        static_cast<cudaStream_t>(stream));
  if (d == hnarrow_f32::D)
    return hnarrow_f32::launch_bwd<SplitBwdF32Kernels>(
        c(q), c(k), c(v), c(o), c(dout), c(lse), m(delta), m(dq), m(dk),
        m(dv), m(scratch), bh, nq, nk, 1, d, scale,
        scale * 1.4426950408889634f, scale,
        static_cast<cudaStream_t>(stream));
  if (d != hwide_f32_bwd::D) return -1;
  return hwide_f32_bwd::launch(
      flash_bwd_wide_f32_images_kernel, flash_bwd_wide_f32_scores_kernel,
      flash_bwd_wide_f32_grads_kernel, c(q), c(k), c(v), c(o), c(dout),
      c(lse), m(delta), m(dq), m(dk), m(dv), m(scratch), bh, nq, nk,
      scale * 1.4426950408889634f, 1.f, scale, scale,
      static_cast<cudaStream_t>(stream));
}
