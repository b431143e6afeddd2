// flash_attention_streaming: exact-softmax attention on split heads for
// sequences of any length,
//   q [BH, Nq, D], k / v [BH, Nk, D] -> o [BH, Nq, D], bf16, contiguous.
//
// Replaces the TPU kernel
// dsml_thesis_tpu/ops/attention.py:_flash_kernel_streaming
// (flash_attention_streaming). That kernel exists because the TPU's resident
// kernel keeps a head's whole K / V in fast memory and so has a longest Nk;
// it walks the K / V blocks as the innermost, sequential grid axis and
// carries the running row maximum and an fp32 accumulator from one grid step
// to the next. On this card every attention kernel streams K / V through
// shared memory, so what this kernel adds is the long-sequence case: the K / V
// stream of one 64-row query tile may be cut into `splits` contiguous ranges,
// each its own block (grid.y), so that a call with few query tiles (small
// B * H * Nq / 64 against a long Nk) still fills the card. Nothing carries
// over between blocks: a split writes its unnormalised fp32 output, row
// maximum and row sum, and a second launch combines the splits of a row in
// index order (no atomics: equal inputs give equal bits). With splits == 1
// the first launch normalises and writes o itself.
//
// Arithmetic, as the TPU kernel's:
//   * q is multiplied by scale * log2(e) IN BF16 (both the factor and the
//     product are rounded to bf16) before the score product;
//   * keys at or past Nk get the finite score -1e30 and the probability 0,
//     the running maximum starts at -1e30: a tile of nothing but padding
//     leaves maximum, sum and output as they were, with no inf - inf;
//   * P = exp2(s - max) is cast to bf16 for P.V, and the softmax denominator
//     is the sum of those CAST probabilities (there it rides the product as a
//     ones column of V), not of the fp32 ones;
//   * everything else in fp32; one cast of o at the end.
//
// Bound: operations (4 * Nq * Nk * D a head against 2 * (2 Nq + 2 Nk) * D
// bytes). As in flash_attention.cu, D = 512 is split over two warps per
// 16-row group (a thread holds 128 accumulators) and both recompute the
// scores; tiles are loaded synchronously and single-buffered, and the
// products are mma.sync. cp.async / TMA and wgmma are later work.
//
// fp32 at D = 512 (dsml_flash_attention_streaming_f32; first-stage training
// under DSML_FLASH_STREAMING=1): the TF32 design of attention_f32.cuh with
// this kernel's roundings in fp32 (q times scale * log2(e) in fp32, the
// -1e30 mask, the denominator the sum of the probabilities as "cast" to fp32,
// which is the identity), the same splits in 64-key units and the same
// combine launch writing fp32.
#include "attention_f32.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr float MASKED = -1e30f;

template <int D, int DSPLIT, int BN>
__global__ void __launch_bounds__(128 * DSPLIT)
streaming_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ part_o, float* __restrict__ part_ml,
                     int nq, int nk, int q_tiles, int tiles_per_split,
                     float q_scale) {
  constexpr int NTHREADS = 128 * DSPLIT;
  constexpr int LDS = D + PAD;
  constexpr int DO = D / DSPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BM * LDS;
  bf16* sV = sK + BN * LDS;

  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const int split = blockIdx.y;
  const int kv_begin = split * tiles_per_split * BN;
  const int kv_end = min(nk, kv_begin + tiles_per_split * BN);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = (warp / DSPLIT) * 16;
  const int dcol0 = (warp % DSPLIT) * DO;
  const LaneOffsets lo(lane);
  q += (bh * nq + q0) * D;
  k += bh * nk * D;
  v += bh * nk * D;

  // rows past nq are zeros and are not written back
  load_tile_scaled<D, NTHREADS>(sQ, q, D, BM, nq - q0, tid,
                                __float2bfloat16(q_scale));

  float acc[DO / 8][4];
#pragma unroll
  for (int i = 0; i < DO / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BN) {
    __syncthreads();  // the previous tile's readers are done; sQ is visible
    load_tile<D, NTHREADS>(sK, k + static_cast<int64_t>(kv0) * D, D, BN,
                           nk - kv0, tid);
    load_tile<D, NTHREADS>(sV, v + static_cast<int64_t>(kv0) * D, D, BN,
                           nk - kv0, tid);
    __syncthreads();

    // S = (q c) K^T for the warp's 16 rows and the tile's BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (row0 + lo.a_row) * LDS + kk + lo.a_col);
#pragma unroll
      for (int nt = 0; nt < BN / 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, sK + (nt * 8 + lo.b_row) * LDS + kk + lo.b_col);
        mma_bf16(s[nt], a, b[0], b[1]);
        mma_bf16(s[nt + 1], a, b[2], b[3]);
      }
    }

    // mask the keys past nk with the finite score, new row maximum
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kv0 + nt * 8 + 2 * (lane & 3) + (j & 1);
        if (key >= nk) s[nt][j] = MASKED;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int i = 0; i < DO / 8; ++i) {
      acc[i][0] *= alpha0;
      acc[i][1] *= alpha0;
      acc[i][2] *= alpha1;
      acc[i][3] *= alpha1;
    }

    // P = exp2(S - max), explicitly 0 for a masked key, cast to bf16 as the
    // A operand; the row sums add the cast values
    uint32_t p[BN / 8][2];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int key = kv0 + nt * 8 + 2 * (lane & 3);
      const bool ok0 = key < nk;
      const bool ok1 = key + 1 < nk;
      const __nv_bfloat162 p01 = __floats2bfloat162_rn(
          ok0 ? exp2f(s[nt][0] - m0) : 0.f, ok1 ? exp2f(s[nt][1] - m0) : 0.f);
      const __nv_bfloat162 p23 = __floats2bfloat162_rn(
          ok0 ? exp2f(s[nt][2] - m1) : 0.f, ok1 ? exp2f(s[nt][3] - m1) : 0.f);
      const float2 f01 = __bfloat1622float2(p01);
      const float2 f23 = __bfloat1622float2(p23);
      l0 += f01.x + f01.y;
      l1 += f23.x + f23.y;
      p[nt][0] = *reinterpret_cast<const uint32_t*>(&p01);
      p[nt][1] = *reinterpret_cast<const uint32_t*>(&p23);
    }

    // O += P V for the warp's D / DSPLIT columns
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      const uint32_t a[4] = {p[2 * kt][0], p[2 * kt][1], p[2 * kt + 1][0],
                             p[2 * kt + 1][1]};
#pragma unroll
      for (int dt = 0; dt < DO / 8; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, sV + (kt * 16 + lo.a_row) * LDS + dcol0 + dt * 8 + lo.a_col);
        mma_bf16(acc[dt], a, b[0], b[1]);
        mma_bf16(acc[dt + 1], a, b[2], b[3]);
      }
    }
  }

  // each lane summed its own 2 of every 8 columns: finish the row sums
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  const int r0 = row0 + (lane >> 2);
  const int r1 = r0 + 8;
  const int col0 = dcol0 + 2 * (lane & 3);
  const int64_t row_base = bh * nq + q0;  // of this tile's first row
  if (gridDim.y == 1) {
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    o += row_base * D;
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
    return;
  }
  // part_o [splits, BH * Nq, D], part_ml [splits, 2, BH * Nq]
  const int64_t rows = static_cast<int64_t>(gridDim.x / q_tiles) * nq;
  part_o += (split * rows + row_base) * D;
  part_ml += split * 2 * rows + row_base;
  if (warp % DSPLIT == 0 && (lane & 3) == 0) {
    if (q0 + r0 < nq) {
      part_ml[r0] = m0;
      part_ml[rows + r0] = l0;
    }
    if (q0 + r1 < nq) {
      part_ml[r1] = m1;
      part_ml[rows + r1] = l1;
    }
  }
#pragma unroll
  for (int dt = 0; dt < DO / 8; ++dt) {
    const int col = col0 + dt * 8;
    if (q0 + r0 < nq)
      *reinterpret_cast<float2*>(part_o + static_cast<int64_t>(r0) * D + col) =
          make_float2(acc[dt][0], acc[dt][1]);
    if (q0 + r1 < nq)
      *reinterpret_cast<float2*>(part_o + static_cast<int64_t>(r1) * D + col) =
          make_float2(acc[dt][2], acc[dt][3]);
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// o[row] = sum_s 2^(m_s - m) o_s / sum_s 2^(m_s - m) l_s, m = max_s m_s, the
// splits added in index order. One thread per (row, 2 columns).
template <typename T>
__global__ void __launch_bounds__(256)
streaming_combine_kernel(const float* __restrict__ part_o,
                         const float* __restrict__ part_ml,
                         T* __restrict__ o, int64_t rows, int d, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int half = d / 2;
  if (idx >= rows * half) return;
  const int64_t row = idx / half;
  const int col = static_cast<int>(idx % half) * 2;
  float m = MASKED;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_ml[s * 2 * rows + row]);
  float l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = exp2f(part_ml[s * 2 * rows + row] - m);
    l += w * part_ml[(s * 2 + 1) * rows + row];
    const float2 po =
        *reinterpret_cast<const float2*>(part_o + (s * rows + row) * d + col);
    a0 += w * po.x;
    a1 += w * po.y;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  store_pair(o + row * d + col, a0 * inv, a1 * inv);
}

template <int D, int DSPLIT, int BN>
int launch(const void* q, const void* k, const void* v, void* o, void* part_o,
           void* part_ml, int bh, int nq, int nk, int splits, float q_scale,
           cudaStream_t stream) {
  const int kv_tiles = (nk + BN - 1) / BN;
  if (bh < 1 || nq < 1 || nk < 1 || splits < 1 || splits > kv_tiles ||
      splits > 65535 || (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return -1;
  const int tiles_per_split = (kv_tiles + splits - 1) / splits;
  auto kernel = streaming_fwd_kernel<D, DSPLIT, BN>;
  const int smem = (BM + 2 * BN) * (D + PAD) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + BM - 1) / BM;
  kernel<<<dim3(bh * q_tiles, splits), 128 * DSPLIT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), nq, nk,
      q_tiles, tiles_per_split, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(bh) * nq;
  const int64_t threads = rows * (D / 2);
  streaming_combine_kernel<bf16><<<static_cast<unsigned>((threads + 255) / 256),
                                   256, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<bf16*>(o), rows, D, splits);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 forward of one 64-row query tile over one split of the keys.
__global__ void __launch_bounds__(128 * f32attn::FDSPLIT)
streaming_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ part_o,
                         float* __restrict__ part_ml, int nq, int nk,
                         int q_tiles, int kv_per_split, float q_scale) {
  using namespace f32attn;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * FBM;
  const int split = blockIdx.y;
  const int kv_begin = split * kv_per_split;
  const int kv_end = min(nk, kv_begin + kv_per_split);
  const int64_t row_base = bh * nq + q0;
  float acc[D / FDSPLIT / 8][4];
  float m0, m1, l0, l1;
  fwd_rows<true>(q + row_base * D, k + bh * nk * D, v + bh * nk * D, nq - q0,
                 nk, kv_begin, kv_end, q_scale,
                 reinterpret_cast<uint32_t*>(smem_raw), acc, m0, m1, l0, l1);
  if (gridDim.y == 1) {
    store_fwd_rows(o + row_base * D, nq - q0, acc, 1.f / fmaxf(l0, 1e-30f),
                   1.f / fmaxf(l1, 1e-30f));
    return;
  }
  // part_o [splits, BH * Nq, D], part_ml [splits, 2, BH * Nq]
  const int64_t rows = static_cast<int64_t>(gridDim.x / q_tiles) * nq;
  part_ml += split * 2 * rows + row_base;
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp / FDSPLIT) * 16 + lane_g();
  if (warp % FDSPLIT == 0 && lane_t() == 0) {
    if (q0 + r0 < nq) {
      part_ml[r0] = m0;
      part_ml[rows + r0] = l0;
    }
    if (q0 + r0 + 8 < nq) {
      part_ml[r0 + 8] = m1;
      part_ml[rows + r0 + 8] = l1;
    }
  }
  store_fwd_rows(part_o + (split * rows + row_base) * D, nq - q0, acc, 1.f,
                 1.f);
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* part_o, void* part_ml, int bh, int nq, int nk,
               int splits, float q_scale, cudaStream_t stream) {
  using namespace f32attn;
  constexpr int SPLIT_KEYS = 64;  // a split's keys are a multiple of this
  const int chunks = (nk + SPLIT_KEYS - 1) / SPLIT_KEYS;
  if (bh < 1 || nq < 1 || nk < 1 || splits < 1 || splits > chunks ||
      splits > 65535 || (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return -1;
  const int kv_per_split = (chunks + splits - 1) / splits * SPLIT_KEYS;
  const int smem = fwd_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      streaming_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + FBM - 1) / FBM;
  streaming_fwd_f32_kernel<<<dim3(bh * q_tiles, splits), 128 * FDSPLIT, smem,
                             stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), nq, nk,
      q_tiles, kv_per_split, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(bh) * nq;
  const int64_t threads = rows * (D / 2);
  streaming_combine_kernel<float><<<
      static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<float*>(o), rows, D, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fp32 instantiation (d = 512 only): the same contract as
// dsml_flash_attention_streaming on fp32 tensors, q_scale = scale * log2(e)
// in fp32.
extern "C" int dsml_flash_attention_streaming_f32(
    const void* q, const void* k, const void* v, void* o, void* part_o,
    void* part_ml, int bh, int nq, int nk, int d, int splits, float q_scale,
    void* stream) {
  if (d != f32attn::D) return -1;
  return launch_f32(q, k, v, o, part_o, part_ml, bh, nq, nk, splits, q_scale,
                    static_cast<cudaStream_t>(stream));
}

// q_scale is scale * log2(e) as rounded to bf16 by the caller. splits cuts
// the K / V stream of a query tile into that many blocks (at most one per 64
// keys); with splits > 1, part_o is fp32 scratch [splits, BH * Nq, D] and
// part_ml fp32 scratch [splits, 2, BH * Nq]. Returns cudaGetLastError() of the
// launches (0 = launched), or -1 for a shape this file does not take.
extern "C" int dsml_flash_attention_streaming(const void* q, const void* k,
                                              const void* v, void* o,
                                              void* part_o, void* part_ml,
                                              int bh, int nq, int nk, int d,
                                              int splits, float q_scale,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32, 1, 64>(q, k, v, o, part_o, part_ml, bh, nq, nk, splits,
                               q_scale, s);
    case 64:
      return launch<64, 1, 64>(q, k, v, o, part_o, part_ml, bh, nq, nk, splits,
                               q_scale, s);
    case 512:
      return launch<512, 2, 64>(q, k, v, o, part_o, part_ml, bh, nq, nk, splits,
                                q_scale, s);
    default:
      return -1;
  }
}
