// flash_attention: exact-softmax attention on split heads,
//   q [BH, Nq, D], k / v [BH, Nk, D] -> o [BH, Nq, D], bf16, contiguous,
// and, where lse is not null, each row's log-sum-exp [BH, Nq] in fp32 (base 2,
// of the scores times scale * log2(e)) for the backward kernel.
//
// Replaces the TPU kernel dsml_thesis_tpu/ops/attention.py:_flash_kernel
// (flash_attention). That kernel keeps one head's whole K and V in fast
// memory and takes the softmax in a single pass. Here a block has at most
// 227 KB of shared memory and K alone is 4 MB at the first stage's shape
// (N = 4096, D = 512), so K / V stream through shared memory in tiles of BN
// rows under an online softmax (running row max and row sum in fp32).
//
// Bound at the first stage's shape: operations (4 * N * N * D a head against
// 4 * N * D * 2 bytes). What limits this kernel is registers: the fp32 output
// of a 64 x 512 tile is 128 KB. The design splits D over DSPLIT = 2 warps per
// 16-row group, so a thread holds 128 accumulators; both warps recompute the
// group's scores (1.5x the operations of the function). K / V tiles are
// loaded synchronously and single-buffered; overlapping the loads (cp.async
// or TMA) and wgmma are later work.
//
// fp32 at D = 512 (dsml_flash_attention_f32; the first stage's AttnBlock in
// first-stage training): the TF32 design of attention_f32.cuh, 64 query rows
// a block against K / V tiles of 16 rows, the same output and row
// log-sum-exp. Bound at [16, 1, 1024, 512]: operations on the TF32 tensor
// cores (4 N^2 D a head against 4 * 4 N D bytes).
#include "attention_f32.cuh"
#include "mma_tiles.cuh"

template <int D, int DSPLIT, int BN>
__global__ void __launch_bounds__(128 * DSPLIT)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int nq, int nk, int q_tiles,
                       float scale_log2) {
  constexpr int NTHREADS = 128 * DSPLIT;
  constexpr int DO = D / DSPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * (D + PAD);
  bf16* sV = sK + BN * (D + PAD);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int tid = threadIdx.x;
  q += (static_cast<int64_t>(bh) * nq + q0) * D;
  o += (static_cast<int64_t>(bh) * nq + q0) * D;
  k += static_cast<int64_t>(bh) * nk * D;
  v += static_cast<int64_t>(bh) * nk * D;

  // the ragged last q-tile: rows past nq are zeros and are not written back
  load_tile<D, NTHREADS>(sQ, q, D, BM, nq - q0, tid);

  float acc[DO / 8][4];
  float l0, l1, m0, m1;
  attend_rows<D, DSPLIT, BN, NTHREADS>(sQ, D + PAD, k, v, D, nk, scale_log2,
                                       sK, sV, acc, l0, l1, m0, m1);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = (warp / DSPLIT) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int col0 = (warp % DSPLIT) * DO + 2 * (lane & 3);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  if (lse != nullptr && warp % DSPLIT == 0 && (lane & 3) == 0) {
    float* row_lse = lse + static_cast<int64_t>(bh) * nq + q0;
    if (q0 + r0 < nq) row_lse[r0] = m0 + log2f(l0);
    if (q0 + r1 < nq) row_lse[r1] = m1 + log2f(l1);
  }
#pragma unroll
  for (int dt = 0; dt < DO / 8; ++dt) {
    const int col = col0 + dt * 8;
    if (q0 + r0 < nq)
      *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(r0) * D + col) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (q0 + r1 < nq)
      *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(r1) * D + col) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <int D, int DSPLIT, int BN>
static int launch(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int nq, int nk, float scale,
                  cudaStream_t stream) {
  auto kernel = flash_attention_kernel<D, DSPLIT, BN>;
  const int smem = (BM + 2 * BN) * (D + PAD) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + BM - 1) / BM;
  const float scale_log2 = scale * 1.4426950408889634f;
  kernel<<<bh * q_tiles, 128 * DSPLIT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), nq, nk, q_tiles, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError() of the launch (0 = launched), or -1 for a head
// width this file has no instantiation for.
extern "C" int dsml_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int bh,
                                    int nq, int nk, int d, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32, 1, 64>(q, k, v, o, lse, bh, nq, nk, scale, s);
    case 64:
      return launch<64, 1, 64>(q, k, v, o, lse, bh, nq, nk, scale, s);
    case 512:
      return launch<512, 2, 64>(q, k, v, o, lse, bh, nq, nk, scale, s);
    default:
      return -1;
  }
}

namespace {

__global__ void __launch_bounds__(128 * f32attn::FDSPLIT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int nq, int nk, int q_tiles,
                     float scale_log2) {
  using namespace f32attn;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * FBM;
  const int64_t row_base = bh * nq + q0;
  float acc[D / FDSPLIT / 8][4];
  float m0, m1, l0, l1;
  fwd_rows<false>(q + row_base * D, k + bh * nk * D, v + bh * nk * D, nq - q0,
                  nk, 0, nk, scale_log2,
                  reinterpret_cast<uint32_t*>(smem_raw), acc, m0, m1, l0, l1);
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / FDSPLIT) * 16 + lane_g();
  if (lse != nullptr && warp % FDSPLIT == 0 && lane_t() == 0) {
    if (q0 + r0 < nq) lse[row_base + r0] = m0 + log2f(l0);
    if (q0 + r0 + 8 < nq) lse[row_base + r0 + 8] = m1 + log2f(l1);
  }
  store_fwd_rows(o + row_base * D, nq - q0, acc, 1.f / l0, 1.f / l1);
}

}  // namespace

// The fp32 instantiation (d = 512 only): the same contract as
// dsml_flash_attention on fp32 tensors.
extern "C" int dsml_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int nq, int nk, int d,
                                        float scale, void* stream) {
  using namespace f32attn;
  if (d != D || bh < 1 || nq < 1 || nk < 1) return -1;
  const int smem = fwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + FBM - 1) / FBM;
  flash_fwd_f32_kernel<<<bh * q_tiles, 128 * FDSPLIT, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), nq, nk, q_tiles,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
