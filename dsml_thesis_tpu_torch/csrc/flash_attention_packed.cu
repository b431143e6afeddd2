// flash_attention_packed: exact-softmax attention on the packed layout,
//   q [B, Nq, H*D], k / v [B, Nk, H*D] -> o [B, Nq, H*D], bf16, contiguous
// (and, where lse is not null, each row's log-sum-exp [B, H, Nq] in fp32,
// base 2, of the scores times scale * log2(e), for the backward kernel):
// the layout the to_q / to_k / to_v projections produce and to_out consumes,
// so no head-split copy is made on either side.
//
// Replaces the TPU kernel
// dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed
// (flash_attention_packed). That kernel runs one program per (batch,
// q-block), keeps the batch element's whole K and V in fast memory and walks
// the heads in sequence. Here a head is a unit of the grid: one block per
// (batch, head, 64-row q-tile) addresses its head's D columns of q, k, v and
// o by base pointer + head offset with the packed row stride H*D, streams
// that head's K / V through shared memory in tiles of ABN rows under the
// online softmax of attend_rows, and writes its output columns in place. At
// the model's shape ([16, 4096, 160], 5 heads of 32) that is 5,120 blocks,
// q-tiles of one (batch, head) adjacent in the grid so that they find their
// K / V in the L2 cache.
//
// Bound at that shape: operations (4 * N * N * H * D a batch element against
// 4 * N * H * D * 2 bytes). A head's slice of a row is 2 * D bytes (64 at
// D = 32) of a 2 * H * D byte row, so a tile load is a strided gather of 16
// bytes a thread, 2 * D bytes contiguous: whole 32-byte sectors. Loads are
// synchronous and single-buffered, and at D = 32 the exp2 and the row
// reductions weigh as much as the tensor-core work; cp.async / TMA and wgmma
// are later work.
#include "mma_tiles.cuh"

template <int D>
__global__ void __launch_bounds__(128)
packed_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int nq, int nk, int heads,
                        int q_tiles, float scale_log2) {
  constexpr int NTHREADS = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [64][D + PAD]
  bf16* sK = sQ + BM * (D + PAD);                // [ABN][D + PAD]
  bf16* sV = sK + ABN * (D + PAD);               // [ABN][D + PAD]

  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int bh = blockIdx.x / q_tiles;
  const int h = bh % heads;
  const int b = bh / heads;
  const int64_t ld = static_cast<int64_t>(heads) * D;
  const int tid = threadIdx.x;
  q += (static_cast<int64_t>(b) * nq + q0) * ld + h * D;
  o += (static_cast<int64_t>(b) * nq + q0) * ld + h * D;
  k += static_cast<int64_t>(b) * nk * ld + h * D;
  v += static_cast<int64_t>(b) * nk * ld + h * D;

  // the ragged last q-tile: rows past nq are zeros and are not written back
  load_tile<D, NTHREADS>(sQ, q, ld, BM, nq - q0, tid);

  float acc[D / 8][4];
  float l0, l1, m0, m1;
  attend_rows<D, 1, ABN, NTHREADS>(sQ, D + PAD, k, v, ld, nk, scale_log2, sK,
                                   sV, acc, l0, l1, m0, m1);

  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  if (lse != nullptr && (lane & 3) == 0) {
    float* row_lse = lse + static_cast<int64_t>(bh) * nq + q0;
    if (q0 + r0 < nq) row_lse[r0] = m0 + log2f(l0);
    if (q0 + r1 < nq) row_lse[r1] = m1 + log2f(l1);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * (lane & 3);
    if (q0 + r0 < nq)
      *reinterpret_cast<uint32_t*>(o + r0 * ld + col) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (q0 + r1 < nq)
      *reinterpret_cast<uint32_t*>(o + r1 * ld + col) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  void* lse, int b, int nq, int nk, int heads, float scale,
                  cudaStream_t stream) {
  auto kernel = packed_attention_kernel<D>;
  const int smem = (BM + 2 * ABN) * (D + PAD) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + BM - 1) / BM;
  kernel<<<b * heads * q_tiles, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), nq, nk, heads, q_tiles,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError() of the launch (0 = launched), or -1 for a head
// width this file has no instantiation for.
extern "C" int dsml_flash_attention_packed(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int b, int nq, int nk, int heads,
                                           int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, lse, b, nq, nk, heads, scale, s);
    case 64:
      return launch<64>(q, k, v, o, lse, b, nq, nk, heads, scale, s);
    default:
      return -1;
  }
}
