// flash_attention_fproj: projection-fused self-attention,
//   out = concat_h softmax(h Wq_h (h Wk_h)^T * scale) h Wv_h @ Wo^T + bo
//   h [B, N, C], Wq / Wk / Wv [H*D, C], Wo [C, H*D], bo [C] -> out [B, N, C]
// (weights in the [out, in] layout of torch.nn.Linear), bf16, fp32 accumulate.
//
// Replaces the TPU kernel
// dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed_fproj
// (flash_attention_fproj). That kernel runs one program per batch element
// with the whole N as its q-block, so it projects K and V once and keeps
// q, k, v and the attention output in fast memory. A Hopper block owns 64
// query rows, and recomputing the K / V projections in each of the N / 64
// blocks would multiply that work by N / 64. So this file has two kernels:
//   (1) qkv_proj_kernel writes q, k, v once, cast to bf16 as the TPU kernel
//       casts them, into a packed [B, N, 3*H*D] scratch (the wrapper
//       allocates it). Cost: one write and N / 64 cached reads of 3*H*D*2
//       bytes a row, which stay in the 50 MB L2 at the model's shapes.
//   (2) fproj_attention_kernel, one block per (batch, 64-row q-tile), walks
//       the heads in sequence as the TPU kernel does, streams each head's
//       K / V tiles of the scratch under an online softmax, parks each
//       head's 64 x D output, cast to bf16, in a [64, H*D] shared-memory
//       tile, then multiplies that tile by Wo^T, adds bo and writes
//       [64, C]. The attention output and the head split never reach device
//       memory. Without its epilogue this is packed attention on
//       [B, N, H*D] (q, k, v are addressed by pointer and row stride).
//
// Bound at the model's shapes ([8, 1024, 320] x 10 heads, [16, 256, 640] x
// 20 heads): operations. D = 32 makes every score product 32 deep, so the
// exp2 and the row reductions weigh as much as the tensor-core work; tiles
// are loaded synchronously and single-buffered. Fusing (1) into (2), async
// copies and wgmma are later work.
#include "mma_tiles.cuh"

// ---------------------------------------------------------------- (1) ---
// out[m, z*hd + n] = sum_k a[m, k] * w_z[n, k]; z = blockIdx.z picks q/k/v.
constexpr int PM = 128;  // rows per block
constexpr int PN = 64;   // output columns per block
constexpr int PK = 32;   // depth per step

__global__ void __launch_bounds__(256)
qkv_proj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wq,
                const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                bf16* __restrict__ out, int m, int c, int hd) {
  __shared__ __align__(16) bf16 sA[PM * (PK + PAD)];
  __shared__ __align__(16) bf16 sB[PN * (PK + PAD)];
  constexpr int LDS = PK + PAD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = (warp >> 1) * 32;  // 4 x 2 warps, 32 x 32 outputs each
  const int wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * PM;
  const int n0 = blockIdx.y * PN;
  const int z = blockIdx.z;
  const bf16* w = z == 0 ? wq : (z == 1 ? wk : wv);
  const LaneOffsets lo(lane);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < c; k0 += PK) {
    __syncthreads();
    load_tile<PK, 256>(sA, a + static_cast<int64_t>(m0) * c + k0, c, PM,
                       m - m0, tid);
    load_tile<PK, 256>(sB, w + static_cast<int64_t>(n0) * c + k0, c, PN,
                       hd - n0, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], sA + (wm + i * 16 + lo.a_row) * LDS + kk + lo.a_col);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, sB + (wn + j * 8 + lo.b_row) * LDS + kk + lo.b_col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], af[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], af[i], b[2], b[3]);
        }
      }
    }
  }

  const int ld_out = 3 * hd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r0 = m0 + wm + i * 16 + (lane >> 2);
    const int r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * (lane & 3);
      if (col >= hd) continue;
      bf16* dst = out + z * hd + col;
      if (r0 < m)
        *reinterpret_cast<uint32_t*>(dst + static_cast<int64_t>(r0) * ld_out) =
            pack_bf16(acc[i][j][0], acc[i][j][1]);
      if (r1 < m)
        *reinterpret_cast<uint32_t*>(dst + static_cast<int64_t>(r1) * ld_out) =
            pack_bf16(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// ---------------------------------------------------------------- (2) ---
template <int D>
__global__ void __launch_bounds__(128)
fproj_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, int64_t ld_qkv,
                       const bf16* __restrict__ wo,
                       const bf16* __restrict__ bo, bf16* __restrict__ out,
                       int n, int heads, int c, int q_tiles,
                       float scale_log2) {
  constexpr int NTHREADS = 128;
  const int hd = heads * D;
  const int lda = hd + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sAtt = reinterpret_cast<bf16*>(smem_raw);  // [64][hd + PAD]
  bf16* sQ = sAtt + BM * lda;                      // [64][D + PAD]
  bf16* sK = sQ + BM * (D + PAD);                  // [ABN][D + PAD]
  bf16* sV = sK + ABN * (D + PAD);                 // [ABN][D + PAD]
  bf16* sW = sQ;  // epilogue: [EN][EK + PAD] over the q / k / v tiles

  const int b = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int tid = threadIdx.x;
  const int64_t batch_off = static_cast<int64_t>(b) * n * ld_qkv;
  q += batch_off + static_cast<int64_t>(q0) * ld_qkv;
  k += batch_off;
  v += batch_off;
  out += (static_cast<int64_t>(b) * n + q0) * c;

  for (int h = 0; h < heads; ++h) {
    __syncthreads();  // every warp is done with the previous head's sQ
    load_tile<D, NTHREADS>(sQ, q + h * D, ld_qkv, BM, n - q0, tid);
    float acc[D / 8][4];
    float l0, l1, m0, m1;
    attend_rows<D, 1, ABN, NTHREADS>(sQ, D + PAD, k + h * D, v + h * D, ld_qkv,
                                     n, scale_log2, sK, sV, acc, l0, l1, m0,
                                     m1);
    park_rows<D>(sAtt, lda, h * D, acc, l0, l1);
  }

  // out[64, c] = sAtt[64, hd] @ wo[c, hd]^T + bo
  rows_times_weight<NTHREADS>(sAtt, lda, wo, c, hd, sW,
                              StoreRowsWithBias{out, c, bo, n - q0});
}

template <int D>
static int launch_attention(const bf16* qkv, const bf16* wo, const bf16* bo,
                            bf16* out, int b, int n, int c, int heads,
                            float scale, cudaStream_t stream) {
  auto kernel = fproj_attention_kernel<D>;
  const int hd = heads * D;
  const int smem = (BM * (hd + PAD) + (BM + 2 * ABN) * (D + PAD)) *
                   static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (n + BM - 1) / BM;
  kernel<<<b * q_tiles, 128, smem, stream>>>(
      qkv, qkv + hd, qkv + 2 * hd, 3 * hd, wo, bo, out, n, heads, c, q_tiles,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// h [B, N, C]; wq / wk / wv [H*D, C]; wo [C, H*D]; bo [C]; qkv is scratch of
// B * N * 3 * H * D bf16; out [B, N, C]. Needs C % 32 == 0 and D in {32, 64}.
// Returns cudaGetLastError() of the launches (0 = launched), -1 for a shape
// this file does not take.
extern "C" int dsml_flash_attention_fproj(
    const void* h, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* bo, void* qkv, void* out, int b, int n, int c,
    int heads, int d, float scale, void* stream) {
  if (c % PK != 0 || (d != 32 && d != 64)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = heads * d;
  const int m = b * n;
  dim3 grid((m + PM - 1) / PM, (hd + PN - 1) / PN, 3);
  qkv_proj_kernel<<<grid, 256, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<bf16*>(qkv), m, c, hd);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (d == 32)
    return launch_attention<32>(static_cast<const bf16*>(qkv),
                                static_cast<const bf16*>(wo),
                                static_cast<const bf16*>(bo),
                                static_cast<bf16*>(out), b, n, c, heads, scale,
                                s);
  return launch_attention<64>(static_cast<const bf16*>(qkv),
                              static_cast<const bf16*>(wo),
                              static_cast<const bf16*>(bo),
                              static_cast<bf16*>(out), b, n, c, heads, scale,
                              s);
}
