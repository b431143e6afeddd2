// flash_attention: exact-softmax attention on split heads,
//   q [BH, Nq, D], k / v [BH, Nk, D] -> o [BH, Nq, D], bf16, contiguous,
// and, where lse is not null, each row's log-sum-exp [BH, Nq] in fp32 (base 2,
// of the scores times scale * log2(e)) for the backward kernel.
//
// Replaces the TPU kernel dsml_thesis_tpu/ops/attention.py:_flash_kernel
// (flash_attention). That kernel keeps one head's whole K and V in fast
// memory and takes the softmax in a single pass. Here a block has at most
// 227 KB of shared memory and K alone is 4 MB at the first stage's shape
// (N = 4096, D = 512), so K / V stream through shared memory in tiles under
// an online softmax (running row max and row sum in fp32).
//
// bf16 at D = 32 / 64 / 80 (the UNet's heads under DSML_ATTN_PACKED=0; 80 is
// the level-0 head of mead-256-ldm-f4-fullattn-dh64.yaml): the packed
// forward's grid (hopper_fwd.cuh) on one head of row stride D, one
// warpgroup a (head, 64-row q-tile), 128-key K / V tiles through a cp.async
// ring on mbarriers, S and P V on wgmma. Its log-sum-exp,
// m * scale * log2(e) + log2(l), is the domain in which the backward
// (flash_attention_bwd.cu, hopper_bwd.cuh) recomputes p. Bound: operations
// (4 * N * N * D a head against 4 * N * D * 2 bytes), and at D = 32 the exp2
// of every score on the special-function unit as much.
//
// bf16 at D = 512 (the first stage's AttnBlock, one head of 512 over 4096
// tokens at 256 px): hopper_wide.cuh's design, resident. Two warpgroups a
// 64-row q-tile, each owning 256 output columns (the 64 x 512 fp32 tile is
// 128 KB, more than one warpgroup's registers); the scores formed once from
// the two halves of the depth; both products on wgmma; 64-key K / V tiles by
// cp.async on mbarriers. Bound: operations, as above.
//
// fp32 at D = 512 (dsml_flash_attention_f32; the first stage's AttnBlock in
// first-stage training and in mead-128-ldm-f4's frozen encodes and decodes):
// hopper_wide_f32.cuh's design, resident. A launch writes the K and V^T tile
// images (TF32) into the caller's scratch, then a cluster of two blocks a
// 64-row q-tile, each owning 256 depth and output columns, forms the scores
// once from the two halves of the depth (the partials cross by st.async)
// and runs both products on TF32 wgmma over 64-key tiles; the same output
// and row log-sum-exp. Bound at [16, 1, 1024, 512]: operations on the TF32
// tensor cores (4 N^2 D a head against 4 * 4 N D bytes).
//
// fp32 at D = 32 (the same entry; mead-128-ldm-f4.yaml's fp32 UNet under
// DSML_ATTN_PACKED=0): the packed fp32 forward's TF32 wgmma design
// (hopper_narrow_f32.cuh) on split heads (heads = 1, row stride 32): an
// images launch writes K and V^T rounded to TF32 as tile images into the
// caller's scratch (hnarrow_f32::fwd_scratch_floats), then two warpgroups
// a 128-row q-tile (one where Nq <= 64) share a 3-stage ring of 64-key
// tiles, q rounded into shared memory, P in registers; the same row
// log-sum-exp, base 2, which row 7's backward reads. Where Nq and Nk are
// both at most hnarrow_f32::MMA_SYNC_MAX (the N = 64 level) the packed fp32
// forward's TF32 mma.sync grid (attention_f32_narrow.cuh) on one head, one
// launch and no scratch. Bound at [32, 5, 1024, 32]: operations on the
// TF32 tensor cores (4 N^2 D a head against 4 * 4 N D bytes).
#include "attention_f32_narrow.cuh"
#include "hopper_fwd.cuh"
#include "hopper_narrow_f32.cuh"
#include "hopper_wide.cuh"
#include "hopper_wide_f32.cuh"

namespace {

// D = 512: hopper_wide.cuh's design, resident (keys of one split: all)
__global__ void __launch_bounds__(hwide::NT, 1)
flash_attention_kernel_wide(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            float* __restrict__ lse, int nq, int nk,
                            float scale_log2, int q_tiles) {
  hwide::attend<false>(q, k, v, o, lse, nullptr, nullptr, nq, nk, q_tiles,
                       nk, scale_log2);
}

// D = 32 / 64 / 80: hopper_fwd.cuh's grid on split heads (one head of row
// stride D); the blocks an SM it states as the packed forward's kernel does
template <int D>
__global__ void __launch_bounds__(hfwd::NT, hfwd::min_blocks(D))
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int nq, int nk, int heads,
                       int q_tiles, float scale_log2) {
  hfwd::attend_heads<D>(q, k, v, o, lse, nq, nk, heads, q_tiles, scale_log2);
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 = launched), or -1 for a shape
// this file does not take (a head width other than 32, 64, 80, 512).
extern "C" int dsml_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int bh,
                                    int nq, int nk, int d, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return hfwd::launch<32>(flash_attention_kernel<32>, q, k, v, o, lse, bh,
                              nq, nk, 1, scale, s);
    case 64:
      return hfwd::launch<64>(flash_attention_kernel<64>, q, k, v, o, lse, bh,
                              nq, nk, 1, scale, s);
    case 80:
      return hfwd::launch<80>(flash_attention_kernel<80>, q, k, v, o, lse, bh,
                              nq, nk, 1, scale, s);
    case hwide::D:
      if (bh < 1 || nq < 1 || nk < 1) return -1;
      return hwide::launch(flash_attention_kernel_wide, bh, nq, 1, s,
                           static_cast<const bf16*>(q),
                           static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(o),
                           static_cast<float*>(lse), nq, nk,
                           scale * 1.4426950408889634f);
    default:
      return -1;
  }
}

namespace {

// fp32 D = 512: hopper_wide_f32.cuh's design, resident (keys of one split:
// all); the tile images first
__global__ void __launch_bounds__(hwide_f32::PREP_NT)
flash_fwd_f32_prep_kernel(const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ kimg,
                          float* __restrict__ vimg, int nk, int tiles) {
  hwide_f32::prep_tile(k, v, kimg, vimg, nk, tiles);
}

__global__ void __launch_bounds__(hwide_f32::NT, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, float* __restrict__ o,
                     float* __restrict__ lse, int nq, int nk, float scale_log2,
                     const float* __restrict__ kimg,
                     const float* __restrict__ vimg, int tiles, int q_tiles) {
  hwide_f32::attend<false>(q, kimg, vimg, o, lse, nullptr, nullptr, nq, nk, nk,
                           scale_log2, tiles, q_tiles);
}

__global__ void __launch_bounds__(f32narrow::NT)
flash_fwd_f32_narrow_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, int64_t ldq, int64_t ldkv,
                            int64_t ldo, int nq, int nk, int heads,
                            int q_tiles, float scale_log2) {
  f32narrow::fwd_block(q, k, v, o, lse, ldq, ldkv, ldo, nq, nk, heads,
                       q_tiles, scale_log2);
}

// fp32 D = 32 on split heads: hopper_narrow_f32.cuh's images launch and
// forward, kernels of their own so that a profile tells row 2 from row 3
__global__ void __launch_bounds__(hnarrow_f32::IMG_NT)
split_images_f32_kernel(hnarrow_f32::ImageJobs jobs, int64_t ld, int heads) {
  hnarrow_f32::images(jobs, ld, heads);
}

template <int WGS, int KT>
__global__ void __launch_bounds__(WGS * 128, hnarrow_f32::fwd_min_blocks(WGS))
split_attention_f32_kernel(hnarrow_f32::FwdArgs a) {
  hnarrow_f32::attend_block<WGS, KT>(a);
}

struct SplitF32Kernels {
  static auto images() { return split_images_f32_kernel; }
  template <int WGS, int KT>
  static auto fwd() {
    return split_attention_f32_kernel<WGS, KT>;
  }
};

}  // namespace

// The fp32 instantiations (d = 512 and 32): the same contract as
// dsml_flash_attention on fp32 tensors, and scratch for the tile images: at
// d = 512 2 * bh * ceil(nk / 16) * 16 * 512 fp32 values
// (ops/attention.py:wide_f32_plan), at d = 32
// hnarrow_f32::fwd_scratch_floats(bh, nk) (narrow_f32_plan; unread where
// both lengths are at most hnarrow_f32::MMA_SYNC_MAX).
extern "C" int dsml_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        void* scratch, int bh, int nq, int nk,
                                        int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == f32narrow::D && hnarrow_f32::keeps_mma_sync(nq, nk))
    return f32narrow::launch_fwd(
        flash_fwd_f32_narrow_kernel, static_cast<const float*>(q),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), static_cast<float*>(lse), bh, nq, nk, 1, d, d,
        d, scale, s);
  if (d == hnarrow_f32::D)
    return hnarrow_f32::launch_fwd<SplitF32Kernels>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), static_cast<float*>(scratch), bh, nq, nk, 1,
        d, scale, s);
  if (d != hwide_f32::D || bh < 1 || nq < 1 || nk < 1 || scratch == nullptr)
    return -1;
  return hwide_f32::launch(
      flash_fwd_f32_prep_kernel, flash_fwd_f32_kernel,
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(scratch), bh, nq, nk, 1, s,
      static_cast<const float*>(q), static_cast<float*>(o),
      static_cast<float*>(lse), nq, nk, scale * 1.4426950408889634f);
}
