// flash_attention_packed: exact-softmax attention on the packed layout,
//   q [B, Nq, H*D], k / v [B, Nk, H*D] -> o [B, Nq, H*D], bf16, contiguous
// (and, where lse is not null, each row's log-sum-exp [B, H, Nq] in fp32,
// base 2, of the scores times scale * log2(e), for the backward kernel):
// the layout the to_q / to_k / to_v projections produce and to_out consumes,
// so no head-split copy is made on either side. Head widths 32, 64 and 80.
//
// Replaces the TPU kernel
// dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed
// (flash_attention_packed). That kernel runs one program per (batch,
// q-block), keeps the batch element's whole K and V in fast memory and walks
// the heads in sequence. Here a head is a unit of the grid: one warpgroup a
// (batch, 64-row q-tile, head), the heads of a q-tile adjacent in the grid,
// addresses its head's D columns of q, k, v and o by base pointer + head
// offset with the packed row stride H*D. At the model's shape ([16, 4096,
// 160], 5 heads of 32) that is 5,120 blocks.
//
// The grid is hopper_fwd.cuh's, which the bf16 split-head forward
// (flash_attention.cu) launches too, on one head: its arithmetic (scores in
// fp32 times scale * log2(e), fp32 row maximum and sums of the fp32
// probabilities, P cast to bf16 for P V, one cast of o) is the TPU kernel's,
// and its log-sum-exp m * scale * log2(e) + log2(l) is the domain in which
// the packed backward (flash_attention_bwd_packed.cu) recomputes
// p = exp2(s * scale * log2(e) - lse). Its design (a cp.async q-tile, a
// cp.async ring of 128-key K / V tiles on mbarriers, hopper::attend_tiles on
// wgmma; 80-wide heads as 64 + 16 column panels) and shared memory are
// described there.
//
// Bound at that shape: operations (4 * N * N * H * D a batch element against
// 4 * N * H * D * 2 bytes: 0.17 ms at 989 TFLOP/s), and at D = 32 the exp2
// of every score on the special-function unit (16 a cycle an SM) as much.
//
// fp32 at D = 32 (dsml_flash_attention_packed_f32; mead-128-ldm-f4.yaml, whose
// UNet computes in fp32, in training): hopper_narrow_f32.cuh on TF32 wgmma,
// an images launch writing K and V^T rounded to TF32 as tile images into
// the caller's scratch (hnarrow_f32::fwd_scratch_floats), then one or two
// warpgroups a (batch x head, q-tile) over 64-key tiles, the same row
// log-sum-exp. Where Nq and Nk are both at most hnarrow_f32::MMA_SYNC_MAX
// (the N = 64 level) the plan keeps attention_f32_narrow.cuh's TF32
// mma.sync forward, one launch. Bound at [32, 1024, 5 x 32]: operations on
// the TF32 tensor cores (4 N^2 H D a batch element against 4 * 4 N H D
// bytes).
#include "attention_f32_narrow.cuh"
#include "hopper_fwd.cuh"
#include "hopper_narrow_f32.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(hfwd::NT, hfwd::min_blocks(D))
packed_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int nq, int nk, int heads,
                        int q_tiles, float scale_log2) {
  hfwd::attend_heads<D>(q, k, v, o, lse, nq, nk, heads, q_tiles, scale_log2);
}

__global__ void __launch_bounds__(f32narrow::NT)
packed_attention_f32_narrow_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   float* __restrict__ o,
                                   float* __restrict__ lse, int64_t ldq,
                                   int64_t ldkv, int64_t ldo, int nq, int nk,
                                   int heads, int q_tiles, float scale_log2) {
  f32narrow::fwd_block(q, k, v, o, lse, ldq, ldkv, ldo, nq, nk, heads,
                       q_tiles, scale_log2);
}

__global__ void __launch_bounds__(hnarrow_f32::IMG_NT)
packed_images_f32_kernel(hnarrow_f32::ImageJobs jobs, int64_t ld, int heads) {
  hnarrow_f32::images(jobs, ld, heads);
}

template <int WGS, int KT>
__global__ void __launch_bounds__(WGS * 128, hnarrow_f32::fwd_min_blocks(WGS))
packed_attention_f32_kernel(hnarrow_f32::FwdArgs a) {
  hnarrow_f32::attend_block<WGS, KT>(a);
}

struct PackedF32Kernels {
  static auto images() { return packed_images_f32_kernel; }
  template <int WGS, int KT>
  static auto fwd() {
    return packed_attention_f32_kernel<WGS, KT>;
  }
};

}  // namespace

// Returns cudaGetLastError() of the launch (0 = launched), or -1 for a shape
// this file does not take (a head width other than 32, 64, 80).
extern "C" int dsml_flash_attention_packed(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int b, int nq, int nk, int heads,
                                           int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return hfwd::launch<32>(packed_attention_kernel<32>, q, k, v, o, lse, b,
                              nq, nk, heads, scale, s);
    case 64:
      return hfwd::launch<64>(packed_attention_kernel<64>, q, k, v, o, lse, b,
                              nq, nk, heads, scale, s);
    case 80:
      return hfwd::launch<80>(packed_attention_kernel<80>, q, k, v, o, lse, b,
                              nq, nk, heads, scale, s);
    default:
      return -1;
  }
}

// The fp32 instantiation (d = 32 only): the same contract on fp32 tensors;
// scratch holds hnarrow_f32::fwd_scratch_floats(b * heads, nk) fp32.
extern "C" int dsml_flash_attention_packed_f32(const void* q, const void* k,
                                               const void* v, void* o,
                                               void* lse, void* scratch,
                                               int b, int nq, int nk,
                                               int heads, int d, float scale,
                                               void* stream) {
  if (d != hnarrow_f32::D) return -1;
  const int64_t ld = static_cast<int64_t>(heads) * d;
  if (hnarrow_f32::keeps_mma_sync(nq, nk))
    return f32narrow::launch_fwd(
        packed_attention_f32_narrow_kernel, static_cast<const float*>(q),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), static_cast<float*>(lse), b, nq, nk, heads,
        ld, ld, ld, scale, static_cast<cudaStream_t>(stream));
  return hnarrow_f32::launch_fwd<PackedF32Kernels>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<float*>(scratch), b, nq, nk, heads,
      ld, scale, static_cast<cudaStream_t>(stream));
}
