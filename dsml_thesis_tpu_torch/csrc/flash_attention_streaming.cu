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
// bytes), and at D = 32 / 64 the exp2 of every score on the special-function
// unit (16 a cycle an SM) more than the tensor cores.
//
// bf16 at D = 32 / 64 / 80 (streaming_wgmma_kernel, hopper_tiles.cuh): one
// warpgroup (64 query rows) a (B*H, q-tile, split). Each thread
// loads its rows of q straight into registers as the A fragment of the
// score product, multiplied by the factor in bf16 on the way. The split's
// keys stream in 128-key K / V tiles (80-wide heads as 64 + 16 column
// panels, hopper::HeadSplit) through a ring of cp.async stages completing
// on mbarriers (hopper::kv_stages: two at D = 80, 82 KB, two blocks an SM);
// hopper::attend_tiles runs S = q K^T and O += P V on wgmma with P packed
// to bf16 in registers, exp2 by ex2.approx, and takes the denominator as
// the TPU kernel does, from the cast probabilities: a product of P with an
// all-ones bf16 tile on the tensor cores (the ones column of V), which also
// keeps that sum off the FMA units. That product reduces over the keys
// (N = 8 columns of ones), so the head width does not enter it.
//
// bf16 at D = 512 (streaming_wide_kernel; the first stage's AttnBlock under
// DSML_FLASH_STREAMING=1, and a 512 px image's under auto): hopper_wide.cuh's
// design with this kernel's roundings (q scaled in bf16 once a block in
// shared memory, the -1e30 mask, the denominator of the cast probabilities
// summed in fp32), two warpgroups a 64-row q-tile each owning 256 output
// columns, the scores formed once from the two halves of the depth, both
// products on wgmma, 64-key K / V tiles of the split's keys by cp.async on
// mbarriers; the same splits in 64-key units and the same combine launch.
//
// fp32 at D = 512 (dsml_flash_attention_streaming_f32; first-stage training
// and mead-128-ldm-f4's frozen first stage under DSML_FLASH_STREAMING=1):
// hopper_wide_f32.cuh's design (the tile images of K and V^T first, then a
// cluster of two blocks a 64-row q-tile splitting D, both products on TF32
// wgmma over 64-key tiles) with this kernel's roundings in fp32 (q times
// scale * log2(e) in fp32 before its TF32 rounding, the -1e30 mask, the
// denominator the sum of the probabilities as "cast" to fp32, which is the
// identity), the same splits in 64-key units and the same combine launch
// writing fp32.
//
// fp32 at D = 32 (the same entry; mead-128-ldm-f4.yaml's fp32 UNet under
// DSML_ATTN_PACKED=0 DSML_FLASH_STREAMING=1): the split-head fp32 forward's
// TF32 wgmma design (hopper_narrow_f32.cuh, attend_block<.., true>) with
// this kernel's roundings in fp32: one images launch writes K and V^T
// rounded to TF32 into the caller's scratch (hnarrow_f32::fwd_scratch_floats),
// then two warpgroups a 128-row q-tile (one where Nq <= 64) and a split of
// the keys (grid.y) run the keys of their split through a 3-stage ring of
// 64-key tiles, q times scale * log2(e) before its TF32 rounding, the -1e30
// mask, the denominator the sum of the probabilities as used in P V; the
// same splits in 64-key units (the host's count, streaming_splits) and the
// same combine launch writing fp32. Where Nq and Nk are both at most
// hnarrow_f32::MMA_SYNC_MAX, attention_f32_narrow.cuh's TF32 mma.sync grid
// with the same roundings (stream_block), one launch and no images. Bound
// at [32, 5, 1024, 32]: operations on the TF32 tensor cores, and the exp2
// of every score.
#include "attention_f32_narrow.cuh"
#include "hopper_narrow_f32.cuh"
#include "hopper_tiles.cuh"
#include "hopper_wide.cuh"
#include "hopper_wide_f32.cuh"

namespace {

constexpr float MASKED = -1e30f;

constexpr int SROWS = 64;           // query rows a block
constexpr int SNT = 128;            // threads a block: one warpgroup
constexpr int SKV = 128;            // key / value rows a streamed tile
constexpr int SPLIT_KEYS = 64;      // a split's keys are a multiple of this

// shared memory of a block: alignment slack, the ring, the ones tile and
// the ring's barriers
__host__ __device__ constexpr int s_smem(int d) {
  return 1024 + hopper::kv_stages(d) * 2 * SKV * 2 * d + 1024 +
         2 * hopper::kv_stages(d) * 8;
}

template <int D>
__global__ void __launch_bounds__(SNT)
streaming_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ part_o, float* __restrict__ part_ml,
                       int nq, int nk, int q_tiles, int keys_per_split,
                       float q_scale) {
  using namespace hopper;
  constexpr int S_STAGES = kv_stages(D);
  constexpr int STAGE = 2 * SKV * 2 * D;   // a K and a V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t ring = cvta(base);
  unsigned char* ones = base + S_STAGES * STAGE;   // 1024 B of bf16 ones
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + 1024);
  uint64_t* empty = full + S_STAGES;

  const int64_t bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * SROWS;
  const int split = blockIdx.y;
  const int kv_begin = split * keys_per_split;
  const int kv_end = min(nk, kv_begin + keys_per_split);
  const int ntiles = (kv_end - kv_begin + SKV - 1) / SKV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // the thread's two rows
  k += bh * nk * D;
  v += bh * nk * D;

  if (tid == 0) {
    for (int s = 0; s < S_STAGES; ++s) {
      mbar_init(&full[s], SNT);
      mbar_init(&empty[s], SNT);
    }
    mbar_fence_init();
  }
  fill_ones<SNT>(ones, tid);
  __syncthreads();  // the barriers and the ones exist before anyone reads them

  int issued = 0;
  auto issue_next = [&]() {  // the keys of tile `issued` into its stage
    const int i = issued++;
    const int s = i % S_STAGES;
    if (i >= S_STAGES) mbar_wait(&empty[s], ((i / S_STAGES) - 1) & 1);
    load_kv_tile_async<D, SKV, SNT>(ring + s * STAGE, k, v, D,
                                    kv_begin + i * SKV, kv_end, tid);
    cp_async_arrive(&full[s]);
  };
  while (issued < S_STAGES && issued < ntiles) issue_next();

  // q times the factor in bf16, as the A fragment of k16 step s: rows r0
  // and r0 + 8, columns 16 s + 2 (lane % 4) + {0, 1} and + 8; rows past nq
  // are zeros
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat162 c2 = __float2bfloat162_rn(q_scale);
    const int64_t row0 = bh * nq + q0 + r0;
    const bool ok0 = q0 + r0 < nq, ok1 = q0 + r0 + 8 < nq;
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (e & 1) ? ok1 : ok0;
        const int64_t row = row0 + ((e & 1) ? 8 : 0);
        const int col = 16 * s + ((e & 2) ? 8 : 0) + 2 * (lane & 3);
        __nv_bfloat162 x = __float2bfloat162_rn(0.f);
        if (ok) x = *reinterpret_cast<const __nv_bfloat162*>(q + row * D + col);
        x = __hmul2(x, c2);
        qa[s][e] = *reinterpret_cast<uint32_t*>(&x);
      }
    }
  }

  int taken = 0;
  auto wait = [&]() {
    const int s = taken % S_STAGES;
    mbar_wait(&full[s], (taken / S_STAGES) & 1);
    fence_async_shared();
    ++taken;
    return ring + s * STAGE;
  };
  auto done = [&]() {  // frees the tile taken last and refills its stage
    mbar_arrive(&empty[(taken - 1) % S_STAGES]);
    if (issued < ntiles) issue_next();
  };
  float acc[D / 2];
  float m0, m1, l0, l1;
  attend_tiles<D, SKV, true>(qa, acc, m0, m1, l0, l1, ntiles, kv_begin,
                             kv_end, 1.f, cvta(ones), lane, wait, done);

  const int r1 = r0 + 8;
  const int col0 = 2 * (lane & 3);
  const int64_t row_base = bh * nq + q0;  // of this tile's first row
  if (gridDim.y == 1) {
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    o += row_base * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = col0 + 8 * j;
      if (q0 + r0 < nq)
        *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(r0) * D + col) =
            pack2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (q0 + r1 < nq)
        *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(r1) * D + col) =
            pack2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    return;
  }
  // part_o [splits, BH * Nq, D], part_ml [splits, 2, BH * Nq]
  const int64_t rows = static_cast<int64_t>(gridDim.x / q_tiles) * nq;
  part_o += (split * rows + row_base) * D;
  part_ml += split * 2 * rows + row_base;
  if ((lane & 3) == 0) {
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
  for (int j = 0; j < D / 8; ++j) {
    const int col = col0 + 8 * j;
    if (q0 + r0 < nq)
      *reinterpret_cast<float2*>(part_o + static_cast<int64_t>(r0) * D + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (q0 + r1 < nq)
      *reinterpret_cast<float2*>(part_o + static_cast<int64_t>(r1) * D + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack2(a, b);
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

// The second launch of a call with splits > 1: o from the splits' parts.
template <typename T>
int launch_combine(const void* part_o, const void* part_ml, void* o,
                   int64_t rows, int d, int splits, cudaStream_t stream) {
  const int64_t threads = rows * (d / 2);
  streaming_combine_kernel<T><<<static_cast<unsigned>((threads + 255) / 256),
                                256, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<T*>(o), rows, d, splits);
  return static_cast<int>(cudaGetLastError());
}

// Whether a split count is one this file takes: at most one split per unit
// keys, none of them empty, and scratch given when it splits.
bool splits_ok(int bh, int nq, int nk, int splits, int unit,
               const void* part_o, const void* part_ml) {
  const int units = (nk + unit - 1) / unit;
  if (bh < 1 || nq < 1 || nk < 1 || splits < 1 || splits > units ||
      splits > 65535 ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return false;
  const int per = (units + splits - 1) / splits;
  return (splits - 1) * per < units;  // no split is empty
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* part_o, void* part_ml, int bh, int nq, int nk,
                 int splits, float q_scale, cudaStream_t stream) {
  if (!splits_ok(bh, nq, nk, splits, SPLIT_KEYS, part_o, part_ml)) return -1;
  const int units = (nk + SPLIT_KEYS - 1) / SPLIT_KEYS;
  const int keys_per_split = (units + splits - 1) / splits * SPLIT_KEYS;
  auto kernel = streaming_wgmma_kernel<D>;
  const int smem = s_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + SROWS - 1) / SROWS;
  kernel<<<dim3(bh * q_tiles, splits), SNT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), nq, nk,
      q_tiles, keys_per_split, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return launch_combine<bf16>(part_o, part_ml, o,
                              static_cast<int64_t>(bh) * nq, D, splits,
                              stream);
}

// D = 512: hopper_wide.cuh's design with this kernel's roundings
__global__ void __launch_bounds__(hwide::NT, 1)
streaming_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ part_o, float* __restrict__ part_ml,
                      int nq, int nk, int keys_per_split, float q_scale,
                      int q_tiles) {
  hwide::attend<true>(q, k, v, o, nullptr, part_o, part_ml, nq, nk, q_tiles,
                      keys_per_split, q_scale);
}

int launch_wide(const void* q, const void* k, const void* v, void* o,
                void* part_o, void* part_ml, int bh, int nq, int nk,
                int splits, float q_scale, cudaStream_t stream) {
  if (!splits_ok(bh, nq, nk, splits, SPLIT_KEYS, part_o, part_ml)) return -1;
  const int units = (nk + SPLIT_KEYS - 1) / SPLIT_KEYS;
  const int keys_per_split = (units + splits - 1) / splits * SPLIT_KEYS;
  const int err = hwide::launch(
      streaming_wide_kernel, bh, nq, splits, stream,
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), nq, nk,
      keys_per_split, q_scale);
  if (err != 0 || splits == 1) return err;
  return launch_combine<bf16>(part_o, part_ml, o,
                              static_cast<int64_t>(bh) * nq, hwide::D, splits,
                              stream);
}

// fp32 D = 512: hopper_wide_f32.cuh's design with this kernel's roundings;
// the tile images first
__global__ void __launch_bounds__(hwide_f32::PREP_NT)
streaming_f32_prep_kernel(const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ kimg,
                          float* __restrict__ vimg, int nk, int tiles) {
  hwide_f32::prep_tile(k, v, kimg, vimg, nk, tiles);
}

__global__ void __launch_bounds__(hwide_f32::NT, 1)
streaming_fwd_f32_kernel(const float* __restrict__ q, float* __restrict__ o,
                         float* __restrict__ part_o,
                         float* __restrict__ part_ml, int nq, int nk,
                         int keys_per_split, float q_scale,
                         const float* __restrict__ kimg,
                         const float* __restrict__ vimg, int tiles,
                         int q_tiles) {
  hwide_f32::attend<true>(q, kimg, vimg, o, nullptr, part_o, part_ml, nq, nk,
                          keys_per_split, q_scale, tiles, q_tiles);
}

__global__ void __launch_bounds__(f32narrow::NT)
streaming_fwd_f32_narrow_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o,
                                float* __restrict__ part_o,
                                float* __restrict__ part_ml, int nq, int nk,
                                int q_tiles, int keys_per_split,
                                float q_scale) {
  f32narrow::stream_block(q, k, v, o, part_o, part_ml, nq, nk, q_tiles,
                          keys_per_split, q_scale);
}

int launch_f32_narrow(const void* q, const void* k, const void* v, void* o,
                      void* part_o, void* part_ml, int bh, int nq, int nk,
                      int splits, float q_scale, cudaStream_t stream) {
  using f32narrow::ROWS;
  if (!splits_ok(bh, nq, nk, splits, SPLIT_KEYS, part_o, part_ml)) return -1;
  const int units = (nk + SPLIT_KEYS - 1) / SPLIT_KEYS;
  const int keys_per_split = (units + splits - 1) / splits * SPLIT_KEYS;
  const int q_tiles = (nq + ROWS - 1) / ROWS;
  streaming_fwd_f32_narrow_kernel<<<dim3(bh * q_tiles, splits), f32narrow::NT,
                                    0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), nq, nk,
      q_tiles, keys_per_split, q_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return launch_combine<float>(part_o, part_ml, o,
                               static_cast<int64_t>(bh) * nq, f32narrow::D,
                               splits, stream);
}

// fp32 D = 32 past the N = 64 level: hopper_narrow_f32.cuh's images launch
// and streaming forward, kernels of their own so that a profile tells row 4
// from rows 2 and 3
__global__ void __launch_bounds__(hnarrow_f32::IMG_NT)
streaming_images_f32_kernel(hnarrow_f32::ImageJobs jobs, int64_t ld,
                            int heads) {
  hnarrow_f32::images(jobs, ld, heads);
}

template <int WGS, int KT>
__global__ void __launch_bounds__(WGS * 128, hnarrow_f32::fwd_min_blocks(WGS))
streaming_attention_f32_kernel(hnarrow_f32::FwdArgs a) {
  hnarrow_f32::attend_block<WGS, KT, true>(a);
}

struct StreamingF32Kernels {
  static auto images() { return streaming_images_f32_kernel; }
  template <int WGS, int KT>
  static auto fwd() {
    return streaming_attention_f32_kernel<WGS, KT>;
  }
};

int launch_f32_hopper(const void* q, const void* k, const void* v, void* o,
                      void* part_o, void* part_ml, void* scratch, int bh,
                      int nq, int nk, int splits, float q_scale,
                      cudaStream_t stream) {
  if (!splits_ok(bh, nq, nk, splits, SPLIT_KEYS, part_o, part_ml)) return -1;
  const int units = (nk + SPLIT_KEYS - 1) / SPLIT_KEYS;
  const int keys_per_split = (units + splits - 1) / splits * SPLIT_KEYS;
  const int err = hnarrow_f32::launch_fwd<StreamingF32Kernels, true>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), nullptr,
      static_cast<float*>(scratch), bh, nq, nk, 1, hnarrow_f32::D, q_scale,
      stream, static_cast<float*>(part_o), static_cast<float*>(part_ml),
      splits, keys_per_split);
  if (err != 0 || splits == 1) return err;
  return launch_combine<float>(part_o, part_ml, o,
                               static_cast<int64_t>(bh) * nq, hnarrow_f32::D,
                               splits, stream);
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* part_o, void* part_ml, void* scratch, int bh, int nq,
               int nk, int splits, float q_scale, cudaStream_t stream) {
  if (!splits_ok(bh, nq, nk, splits, SPLIT_KEYS, part_o, part_ml) ||
      scratch == nullptr)
    return -1;
  const int units = (nk + SPLIT_KEYS - 1) / SPLIT_KEYS;
  const int keys_per_split = (units + splits - 1) / splits * SPLIT_KEYS;
  const int err = hwide_f32::launch(
      streaming_f32_prep_kernel, streaming_fwd_f32_kernel,
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(scratch), bh, nq, nk, splits, stream,
      static_cast<const float*>(q), static_cast<float*>(o),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), nq, nk,
      keys_per_split, q_scale);
  if (err != 0 || splits == 1) return err;
  return launch_combine<float>(part_o, part_ml, o,
                               static_cast<int64_t>(bh) * nq, hwide_f32::D,
                               splits, stream);
}

}  // namespace

// The fp32 instantiations (d = 32 and 512): the same contract as
// dsml_flash_attention_streaming on fp32 tensors, q_scale = scale * log2(e)
// in fp32, and scratch for the tile images: at d = 512
// 2 * bh * ceil(nk / 16) * 16 * 512 fp32 values
// (ops/attention.py:wide_f32_plan), at d = 32
// hnarrow_f32::fwd_scratch_floats(bh, nk) (narrow_f32_plan; unread where
// both lengths are at most hnarrow_f32::MMA_SYNC_MAX).
extern "C" int dsml_flash_attention_streaming_f32(
    const void* q, const void* k, const void* v, void* o, void* part_o,
    void* part_ml, void* scratch, int bh, int nq, int nk, int d, int splits,
    float q_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == f32narrow::D && hnarrow_f32::keeps_mma_sync(nq, nk))
    return launch_f32_narrow(q, k, v, o, part_o, part_ml, bh, nq, nk, splits,
                             q_scale, s);
  if (d == hnarrow_f32::D)
    return launch_f32_hopper(q, k, v, o, part_o, part_ml, scratch, bh, nq, nk,
                             splits, q_scale, s);
  if (d != hwide_f32::D) return -1;
  return launch_f32(q, k, v, o, part_o, part_ml, scratch, bh, nq, nk, splits,
                    q_scale, s);
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
      return launch_wgmma<32>(q, k, v, o, part_o, part_ml, bh, nq, nk, splits,
                              q_scale, s);
    case 64:
      return launch_wgmma<64>(q, k, v, o, part_o, part_ml, bh, nq, nk, splits,
                              q_scale, s);
    case 80:
      return launch_wgmma<80>(q, k, v, o, part_o, part_ml, bh, nq, nk, splits,
                              q_scale, s);
    case hwide::D:
      return launch_wide(q, k, v, o, part_o, part_ml, bh, nq, nk, splits,
                         q_scale, s);
    default:
      return -1;
  }
}
