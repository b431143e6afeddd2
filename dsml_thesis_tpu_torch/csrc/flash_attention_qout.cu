// flash_attention_qout: self-attention with the q projection and to_out
// fused around it, K and V given:
//   out = concat_h softmax(h Wq_h K_h^T * scale) V_h @ Wo^T + bo
//   h [B, N, C], k / v [B, Nk, H*D], Wq [H*D, C], Wo [C, H*D], bo [C]
//   -> out [B, N, C]
// (weights in the [out, in] layout of torch.nn.Linear), bf16, fp32 accumulate.
//
// Replaces the TPU kernel
// dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed_qout
// (flash_attention_qout), the form for sequences of more than one q-block,
// where projecting K and V inside every q-block would repeat that work: K
// and V come from plain linears outside, and q and the attention output
// never reach device memory.
//
// One block per (batch, 64-row tile), 4 warps of 16 rows:
//   (1) the tile of h goes to shared memory and is multiplied by Wq^T on the
//       tensor cores; q, cast to bf16 as the TPU kernel casts it, stays in a
//       [64, H*D] shared-memory tile;
//   (2) the heads are walked in sequence: head h's columns of that tile
//       against its columns of K / V, streamed through shared memory under
//       the online softmax of attend_rows; each head's output, cast to bf16,
//       is parked in a second [64, H*D] tile (which reuses h's room);
//   (3) that tile times Wo^T plus bo is written as [64, C].
//
// Bound at the model's shape ([16, 4096, 160], 5 heads of 32): operations.
// What limits the design is shared memory: two [64, max(C, H*D) + 8] tiles,
// the K / V tiles and a weight panel, 186 KB at C = H*D = 640 with D = 32 and
// 202 KB with D = 64, of the 227 KB a block may use. A wider model does not
// fit and is refused (-1). Loads are synchronous and single-buffered.
#include "mma_tiles.cuh"

static int qout_smem_bytes(int c, int hd, int d) {
  const int wide = c > hd ? c : hd;
  return (BM * (wide + PAD) + BM * (hd + PAD) + 2 * ABN * (d + PAD)) *
         static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(128)
qout_attention_kernel(const bf16* __restrict__ h, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ wq,
                      const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                      bf16* __restrict__ out, int n, int nk, int c, int heads,
                      int q_tiles, float scale_log2) {
  constexpr int NTHREADS = 128;
  const int hd = heads * D;
  const int ldh = c + PAD;
  const int lda = hd + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sH = reinterpret_cast<bf16*>(smem_raw);  // [64][c + PAD], then
  bf16* sAtt = sH;                               // [64][hd + PAD]
  bf16* sQ = sH + BM * ((c > hd ? c : hd) + PAD);  // [64][hd + PAD]
  bf16* sK = sQ + BM * lda;                      // [ABN][D + PAD]
  bf16* sV = sK + ABN * (D + PAD);               // [ABN][D + PAD]
  bf16* sW = sK;  // [EN][EK + PAD] weight panel over the k / v tiles

  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int tid = threadIdx.x;
  h += (static_cast<int64_t>(b) * n + q0) * c;
  out += (static_cast<int64_t>(b) * n + q0) * c;
  k += static_cast<int64_t>(b) * nk * hd;
  v += static_cast<int64_t>(b) * nk * hd;

  // (1) q[64, hd] = h[64, c] @ wq[hd, c]^T; rows past n are zeros
  load_rows<NTHREADS>(sH, ldh, h, c, BM, n - q0, c, tid);
  rows_times_weight<NTHREADS>(
      sH, ldh, wq, hd, c, sW, [&](int col, const float (&acc)[4]) {
        const int lane = tid & 31;
        const int r0 = (tid >> 5) * 16 + (lane >> 2);
        *reinterpret_cast<uint32_t*>(sQ + r0 * lda + col) =
            pack_bf16(acc[0], acc[1]);
        *reinterpret_cast<uint32_t*>(sQ + (r0 + 8) * lda + col) =
            pack_bf16(acc[2], acc[3]);
      });

  // (2) attend_rows' first barrier makes sQ visible and ends the reads of sH
  // and sW before sAtt and the k / v tiles are written over them
  for (int head = 0; head < heads; ++head) {
    float acc[D / 8][4];
    float l0, l1, m0, m1;
    attend_rows<D, 1, ABN, NTHREADS>(sQ + head * D, lda, k + head * D,
                                     v + head * D, hd, nk, scale_log2, sK, sV,
                                     acc, l0, l1, m0, m1);
    park_rows<D>(sAtt, lda, head * D, acc, l0, l1);
  }

  // (3) out[64, c] = sAtt[64, hd] @ wo[c, hd]^T + bo
  rows_times_weight<NTHREADS>(sAtt, lda, wo, c, hd, sW,
                              StoreRowsWithBias{out, c, bo, n - q0});
}

template <int D>
static int launch(const void* h, const void* k, const void* v, const void* wq,
                  const void* wo, const void* bo, void* out, int b, int n,
                  int nk, int c, int heads, float scale, cudaStream_t stream) {
  auto kernel = qout_attention_kernel<D>;
  const int smem = qout_smem_bytes(c, heads * D, D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (n + BM - 1) / BM;
  kernel<<<b * q_tiles, 128, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<bf16*>(out), n, nk, c, heads, q_tiles,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// Needs C % 16 == 0, D in {32, 64} and the tiles above within 227 KB of
// shared memory. Returns cudaGetLastError() of the launch (0 = launched), -1
// for a shape this file does not take.
extern "C" int dsml_flash_attention_qout(
    const void* h, const void* k, const void* v, const void* wq,
    const void* wo, const void* bo, void* out, int b, int n, int nk, int c,
    int heads, int d, float scale, void* stream) {
  if (c % 16 != 0 || (d != 32 && d != 64)) return -1;
  if (qout_smem_bytes(c, heads * d, d) > 232448) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32)
    return launch<32>(h, k, v, wq, wo, bo, out, b, n, nk, c, heads, scale, s);
  return launch<64>(h, k, v, wq, wo, bo, out, b, n, nk, c, heads, scale, s);
}
