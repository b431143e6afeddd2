// conv_stats: a K x K (K = 1 or 3) SAME stride-1 convolution on channel-last
// tensors with the GroupNorm statistics of its output taken in its epilogue,
// and optionally the GroupNorm(+SiLU) of its INPUT applied on the way in:
//   x [B, H, W, Cin] T, w [K, K, Cin, Cout] T, bias [B, Cout] fp32 (the conv
//   bias plus any per-batch vector), skip [B, H, W, Cout] T or null,
//   in_sum / in_sq [B, Cin] fp32 with gamma / beta [Cin] fp32 or null
//   -> y [B, H, W, Cout] T = cast(conv(norm(x)) + bias + skip), and the
//      per (batch, channel) sum and sum of squares of y AS STORED, fp32, as
//      sums [2, B, Cout].
// T is bf16 (the UNet; the first stage in sampling: conv_stats.cu) or fp32
// (first-stage training, mead-128-ldm-f4's UNet: conv_stats_f32.cu). Four
// designs, chosen a call by ops/conv_gn.py:conv_plan and dispatched at the
// end of this file: pixel patches on mma.sync (design 0, this file: the
// stems, and the normed 3 x 3 convs of wide images) and the implicit GEMM on
// wgmma over flattened pixels (designs 1-3, conv_igemm.cuh, with its note on
// each). One kernel template a design serves both types; the type decides
// the tensor-core step and what is rounded where, the same in every design:
//   bf16  bf16 operands, fp32 accumulation (design 0: mma.sync m16n8k16
//         through ldmatrix; 1-3: wgmma m64nNk16); the normalised input is
//         rounded to bf16 where it is stored in shared memory; y is rounded
//         to bf16 once, and its sums are of the rounded values.
//   fp32  TF32 products with fp32 accumulation (design 0: mma.sync m16n8k8;
//         1-3: wgmma m64nNk8; the card's TF32 rate is 7.4x its fp32 rate
//         outside the tensor cores): x (after the input norm, in fp32) and w
//         are rounded to TF32 (cvt.rna, 10 of fp32's 23 mantissa bits) once
//         each, where they are stored in shared memory. (Design 0: TF32 has
//         no transposing ldmatrix, so fragments are 32-bit shared-memory
//         loads, and rows are padded so that every fragment load hits 32
//         distinct banks: x rows by 4 words, weight rows by 8.) Bias, skip,
//         the sums and y stay fp32: y is the fp32 accumulator plus bias
//         plus skip, stored as is. The plain version,
//         ops/conv_gn.py:conv_stats_reference, runs cuDNN under the caller's
//         TF32 setting; held to it with TF32 off, the kernel differs by its
//         operands' TF32 rounding alone.
//
// Replaces the TPU kernel dsml_thesis_tpu/ops/conv_gn.py:_conv_kernel
// (conv_stats_pallas). That kernel takes one whole image a grid step: the
// image, its zero-padded copy, the weights and an fp32 accumulator all sit
// in fast memory, the conv is K * K shifted [H*W, Cin] x [Cin, Cout]
// products, and the statistics are column sums of the finished image. None
// of that fits a block here (227 KB), and one block an image would leave the
// card idle. Design 0 (this file; w [K, K, Cin, Cout]) is an implicit GEMM
// on mma.sync over pixel patches: a block owns a
// 16 x 16 (or, for K = 1 and for images of up to 8 rows, 8 x 16) patch of
// output pixels of one image and 64 output channels, a warp two patch rows,
// and walks Cin in chunks of KC (32 in bf16, 16 in fp32). For a chunk it
// loads the patch with its one-pixel halo once into shared memory and the
// chunk's weights of all K * K taps; a tap is then the same tile read at
// shifted pixel rows (a fragment load takes a row address per lane, so the
// shift costs nothing), never a gathered copy.
//   * The input's GroupNorm(+SiLU) is applied while the halo tile is loaded:
//     once a block, the channel sums are folded into the groups' mean and
//     rstd (variance max(E[x^2] - E[x]^2, 0), eps inside the root) and from
//     those, gamma and beta into one fp32 scale and shift per channel, so an
//     element costs one fma, the SiLU and the rounding to the stored type.
//     The zero border is applied AFTER the norm: a tap outside the image
//     reads 0, not norm(0).
//   * The statistics are of the values as stored, the ones a later
//     normalisation will read. A block reduces its patch per channel (warp
//     shuffles, then the block's warps in index order) into
//     partial [B, tiles, 2, Cout]; a second launch adds an image's tiles in
//     index order. No atomics: equal inputs give equal bits.
//   * Cin that is not a multiple of one 16-byte load (VEC = 8 bf16 or 4 fp32
//     channels; the stem's Cin = 3) is read channel by channel.
//
// Bound: operations (2 * B * H * W * K * K * Cin * Cout against the bytes of
// x, w, skip and y once each) for every shape of the UNet and the first
// stage; the 1 x 1 convs at small Cin and the stem are close to or on the
// bytes side. Shared memory a block, K = 3, 16 x 16 patch: 67,392 bytes in
// either type, plus 2 Cin floats with the norm. Design 0 loads synchronously
// and single-buffered, re-reads the input patch once per 64 output channels
// and masks a last, partly empty channel tile (Cout = 160 wastes a sixth),
// but normalises each halo element once for all nine taps: at the first
// stage's 64 x 64 and wider normed 3 x 3 convs that still beats the
// wgmma designs (the A/B in PERF.md's kernel table), which is where the
// plan keeps it, with the stems (Cin = 3 or 9, which 16-byte copies do not
// take).
#pragma once

#include "attention_f32.cuh"
#include "conv_igemm.cuh"
#include "mma_tiles.cuh"

// Internal linkage: each translation unit that includes this header (one a
// type) keeps its own copy of the non-template finish kernel.
namespace conv {
namespace {

constexpr int TW = 16;          // output columns: one m16 tile a patch row
constexpr int BNC = 64;         // output channels of a block
constexpr int MAX_GROUPS = 64;  // of the input GroupNorm

// What the activation type decides: the shared-memory element (bf16, or the
// TF32 bits of an fp32 value), the input channels of a chunk, channels of a
// 16-byte load, the tensor-core step's depth and the rows' padding in
// elements.
template <typename T>
struct Traits;

template <>
struct Traits<bf16> {
  using S = bf16;
  static constexpr int KC = 32;  // input channels of a chunk
  static constexpr int VEC = 8;
  static constexpr int KSTEP = 16;
  static constexpr int PADX = PAD;
  static constexpr int PADW = PAD;
};

template <>
struct Traits<float> {
  using S = uint32_t;
  // 16 input channels a chunk: a K = 3 block takes 67,392 bytes of shared
  // memory and 126 registers a thread, so two blocks share an SM and one's
  // loads overlap the other's products (32 channels: one block an SM,
  // 1.5-1.7x slower on an H100 at the first stage's K = 3 shapes)
  static constexpr int KC = 16;
  static constexpr int VEC = 4;
  static constexpr int KSTEP = 8;
  static constexpr int PADX = 4;  // x rows of KC + 4 words: 4 banks apart
  static constexpr int PADW = 8;  // weight rows of 72 words: 8 banks apart
};

// Bytes of shared memory of the tiles of a block with TH patch rows: the halo
// tile and the weights of a chunk. With the input norm, a scale and a shift
// per input channel (fp32) follow them.
template <typename T, int KS, int TH>
constexpr int tile_bytes() {
  using Tr = Traits<T>;
  return ((TH + KS - 1) * (TW + KS - 1) * (Tr::KC + Tr::PADX) +
          KS * KS * Tr::KC * (BNC + Tr::PADW)) *
         static_cast<int>(sizeof(typename Tr::S));
}

// One 16-byte vector of VEC input channels starting at channel ch of a pixel
// (channels past Cin read as 0), normalised when GN and rounded to the stored
// type, as it goes to shared memory.
template <bool GN>
__device__ __forceinline__ uint4 halo_vector(const bf16* src, int ch, int cin,
                                             bool vec, const float* sScale,
                                             const float* sShift, int silu) {
  if (!GN && vec) return *reinterpret_cast<const uint4*>(src);
  float f[8];
  if (vec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(p[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = ch + j < cin ? __bfloat162float(src[j]) : 0.f;
  }
  if (GN) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (ch + j >= cin) continue;
      float t = fmaf(f[j], sScale[ch + j], sShift[ch + j]);
      if (silu) t = __fdividef(t, 1.f + __expf(-t));
      f[j] = t;
    }
  }
  uint4 v;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return v;
}

template <bool GN>
__device__ __forceinline__ uint4 halo_vector(const float* src, int ch, int cin,
                                             bool vec, const float* sScale,
                                             const float* sShift, int silu) {
  float f[4];
  if (vec) {
    const float4 raw = *reinterpret_cast<const float4*>(src);
    f[0] = raw.x;
    f[1] = raw.y;
    f[2] = raw.z;
    f[3] = raw.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = ch + j < cin ? src[j] : 0.f;
  }
  if (GN) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ch + j >= cin) continue;
      float t = fmaf(f[j], sScale[ch + j], sShift[ch + j]);
      if (silu) t = __fdividef(t, 1.f + __expf(-t));
      f[j] = t;
    }
  }
  using f32attn::to_tf32;
  return make_uint4(to_tf32(f[0]), to_tf32(f[1]), to_tf32(f[2]),
                    to_tf32(f[3]));
}

// A 16-byte vector of weights as it goes to shared memory.
__device__ __forceinline__ uint4 weight_vector(const bf16* src) {
  return *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ uint4 weight_vector(const float* src) {
  using f32attn::to_tf32;
  const float4 v = *reinterpret_cast<const float4*>(src);
  return make_uint4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
}

// One depth step of a tap (dy, dx) for a warp's two patch rows and BNC
// channels: acc[t][nt] += x[patch row 2 warp + t, shifted by the tap] .
// w[tap, kk.., nt].
template <int HALO_W, int KC, int LDX, int LDW>
__device__ __forceinline__ void mma_step(float (&acc)[2][BNC / 8][4],
                                         const bf16* sX, const bf16* sW,
                                         int warp, int tap, int dy, int dx,
                                         int kk, const LaneOffsets& lo) {
  uint32_t a[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
    ldmatrix_x4(a[t], sX + ((2 * warp + t + dy) * HALO_W + lo.a_row + dx) *
                               LDX +
                           kk + lo.a_col);
#pragma unroll
  for (int nt = 0; nt < BNC / 8; nt += 2) {
    uint32_t bw[4];
    ldmatrix_x4_trans(
        bw, sW + (tap * KC + kk + lo.a_row) * LDW + nt * 8 + lo.a_col);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      mma_bf16(acc[t][nt], a[t], bw[0], bw[1]);
      mma_bf16(acc[t][nt + 1], a[t], bw[2], bw[3]);
    }
  }
}

// The same in TF32 (lane = 4 g + q): A [16 x 8] holds (g, q), (g + 8, q),
// (g, q + 4), (g + 8, q + 4) of (pixel, depth); B [8 x 8] holds (q, g),
// (q + 4, g) of (depth, channel). A's rows are 16 pixels of one patch row, B
// is read from the [depth][channel] weight tile as loaded.
template <int HALO_W, int KC, int LDX, int LDW>
__device__ __forceinline__ void mma_step(float (&acc)[2][BNC / 8][4],
                                         const uint32_t* sX,
                                         const uint32_t* sW, int warp,
                                         int tap, int dy, int dx, int kk,
                                         const LaneOffsets&) {
  const int g = f32attn::lane_g();
  const int q = f32attn::lane_t();
  uint32_t a[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const uint32_t* p = sX + ((2 * warp + t + dy) * HALO_W + g + dx) * LDX +
                        kk + q;
    a[t][0] = p[0];
    a[t][1] = p[8 * LDX];
    a[t][2] = p[4];
    a[t][3] = p[8 * LDX + 4];
  }
#pragma unroll
  for (int nt = 0; nt < BNC / 8; ++nt) {
    const uint32_t* p = sW + (tap * KC + kk + q) * LDW + nt * 8 + g;
    const uint32_t b0 = p[0];
    const uint32_t b1 = p[4 * LDW];
#pragma unroll
    for (int t = 0; t < 2; ++t) f32attn::mma_tf32(acc[t][nt], a[t], b0, b1);
  }
}

// Two neighbouring output values: + skip, then stored; returns them as
// stored.
__device__ __forceinline__ void add_skip(float& v0, float& v1,
                                         const bf16* skip) {
  const float2 sk =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(skip));
  v0 += sk.x;
  v1 += sk.y;
}

__device__ __forceinline__ void add_skip(float& v0, float& v1,
                                         const float* skip) {
  const float2 sk = *reinterpret_cast<const float2*>(skip);
  v0 += sk.x;
  v1 += sk.y;
}

__device__ __forceinline__ float2 store_pair(bf16* y, float v0, float v1) {
  const __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(y) = out;
  return __bfloat1622float2(out);
}

__device__ __forceinline__ float2 store_pair(float* y, float v0, float v1) {
  const float2 out = make_float2(v0, v1);
  *reinterpret_cast<float2*>(y) = out;
  return out;
}

// TH output rows of a block's patch; TH / 2 warps, warp w owns patch rows
// 2 w and 2 w + 1.
template <typename T, int KS, bool GN, int TH>
__global__ void __launch_bounds__(TH * 16)
conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, const T* __restrict__ skip,
                  const float* __restrict__ in_sum,
                  const float* __restrict__ in_sq,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ partial, int hh, int ww, int cin,
                  int cout, int tiles_w, int tiles, int groups,
                  float inv_count, float eps, int silu) {
  using Tr = Traits<T>;
  using S = typename Tr::S;
  constexpr int KC = Tr::KC;
  constexpr int VEC = Tr::VEC;
  constexpr int NTHREADS = TH * 16;
  constexpr int HALO_H = TH + KS - 1;
  constexpr int HALO_W = TW + KS - 1;
  constexpr int BORDER = (KS - 1) / 2;
  constexpr int LDX = KC + Tr::PADX;
  constexpr int LDW = BNC + Tr::PADW;
  static_assert(KC % Tr::KSTEP == 0 && KC % VEC == 0, "chunk of whole steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sX = reinterpret_cast<S*>(smem_raw);  // [HALO_H * HALO_W][LDX]
  S* sW = sX + HALO_H * HALO_W * LDX;      // [KS * KS][KC][LDW]
  // [Cin rounded up to 8] scale, then as many shift, of the input norm
  float* sScale = reinterpret_cast<float*>(sW + KS * KS * KC * LDW);
  float* sShift = sScale + (cin + 7) / 8 * 8;
  __shared__ float sG[2 * MAX_GROUPS];           // group mean, group rstd
  __shared__ float sRed[NTHREADS / 32][2][BNC];  // the warps' column sums

  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int h0 = (tile / tiles_w) * TH;
  const int w0 = (tile % tiles_w) * TW;
  const int n0 = blockIdx.y * BNC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const LaneOffsets lo(lane);
  const T* xb = x + static_cast<int64_t>(b) * hh * ww * cin;
  const bool vec = cin % VEC == 0;  // 16-byte loads of x need aligned pixels

  if (GN) {
    const int cg = cin / groups;
    const float* ch_sum = in_sum + static_cast<int64_t>(b) * cin;
    const float* ch_sq = in_sq + static_cast<int64_t>(b) * cin;
    for (int g = tid; g < groups; g += NTHREADS) {
      float s = 0.f, q = 0.f;
      for (int j = 0; j < cg; ++j) {
        s += ch_sum[g * cg + j];
        q += ch_sq[g * cg + j];
      }
      const float mean = s * inv_count;
      const float var = fmaxf(q * inv_count - mean * mean, 0.f);
      sG[g] = mean;
      sG[groups + g] = 1.f / sqrtf(var + eps);
    }
    __syncthreads();
    // (x - mean) * rstd * gamma + beta as x * scale + shift
    for (int c = tid; c < cin; c += NTHREADS) {
      const float scale = sG[groups + c / cg] * gamma[c];
      sScale[c] = scale;
      sShift[c] = beta[c] - sG[c / cg] * scale;
    }
    // (the first barrier of the chunk loop makes the tables visible)
  }

  float acc[2][BNC / 8][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BNC / 8; ++i)
      acc[t][i][0] = acc[t][i][1] = acc[t][i][2] = acc[t][i][3] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += KC) {
    __syncthreads();  // the previous chunk's readers are done
    // the patch with its halo, channels c0 .. c0 + KC - 1, normalised on the
    // way; pixels outside the image and channels past Cin are zeros
    for (int i = tid; i < HALO_H * HALO_W * (KC / VEC); i += NTHREADS) {
      const int pix = i / (KC / VEC);
      const int cc = (i % (KC / VEC)) * VEC;
      const int gh = h0 + pix / HALO_W - BORDER;
      const int gw = w0 + pix % HALO_W - BORDER;
      const int ch = c0 + cc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gh >= 0 && gh < hh && gw >= 0 && gw < ww && ch < cin)
        v = halo_vector<GN>(
            xb + (static_cast<int64_t>(gh) * ww + gw) * cin + ch, ch, cin, vec,
            sScale, sShift, silu);
      *reinterpret_cast<uint4*>(sX + pix * LDX + cc) = v;
    }
    // the chunk's weights of every tap, output channels n0 .. n0 + BNC - 1
    for (int i = tid; i < KS * KS * KC * (BNC / VEC); i += NTHREADS) {
      const int row = i / (BNC / VEC);  // tap * KC + depth within the chunk
      const int cc = (i % (BNC / VEC)) * VEC;
      const int tap = row / KC;
      const int kr = row % KC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + kr < cin && n0 + cc < cout)
        v = weight_vector(w + (static_cast<int64_t>(tap) * cin + c0 + kr) *
                                  cout + n0 + cc);
      *reinterpret_cast<uint4*>(sW + row * LDW + cc) = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < KS * KS; ++tap) {
      const int dy = tap / KS;
      const int dx = tap % KS;
#pragma unroll
      for (int kk = 0; kk < KC; kk += Tr::KSTEP) {
        if (c0 + kk >= cin) break;  // a depth step of nothing but padding
        mma_step<HALO_W, KC, LDX, LDW>(acc, sX, sW, warp, tap, dy, dx, kk, lo);
      }
    }
  }

  // epilogue: + bias (+ skip), one rounding to the stored type, the store,
  // and the column sums of the stored values over this block's pixels inside
  // the image
  const float* bias_b = bias + static_cast<int64_t>(b) * cout;
  float csum[BNC / 8][2], csq[BNC / 8][2];
#pragma unroll
  for (int nt = 0; nt < BNC / 8; ++nt)
    csum[nt][0] = csum[nt][1] = csq[nt][0] = csq[nt][1] = 0.f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int gh = h0 + 2 * warp + t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gw = w0 + (lane >> 2) + 8 * half;
      if (gh >= hh || gw >= ww) continue;
      const int64_t pix = (static_cast<int64_t>(b) * hh + gh) * ww + gw;
#pragma unroll
      for (int nt = 0; nt < BNC / 8; ++nt) {
        const int col = n0 + nt * 8 + 2 * (lane & 3);
        if (col >= cout) continue;
        float v0 = acc[t][nt][2 * half] + bias_b[col];
        float v1 = acc[t][nt][2 * half + 1] + bias_b[col + 1];
        if (skip != nullptr) add_skip(v0, v1, skip + pix * cout + col);
        const float2 f = store_pair(y + pix * cout + col, v0, v1);
        csum[nt][0] += f.x;
        csum[nt][1] += f.y;
        csq[nt][0] += f.x * f.x;
        csq[nt][1] += f.y * f.y;
      }
    }
  }
  // lanes with equal lane % 4 hold the same columns: add them, in a fixed
  // order, into lanes 0 .. 3
#pragma unroll
  for (int nt = 0; nt < BNC / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        csum[nt][j] += __shfl_xor_sync(0xffffffffu, csum[nt][j], off);
        csq[nt][j] += __shfl_xor_sync(0xffffffffu, csq[nt][j], off);
      }
      if (lane < 4) {
        sRed[warp][0][nt * 8 + 2 * lane + j] = csum[nt][j];
        sRed[warp][1][nt * 8 + 2 * lane + j] = csq[nt][j];
      }
    }
  __syncthreads();
  if (tid < 2 * BNC) {
    const int which = tid / BNC;
    const int c = tid % BNC;
    if (n0 + c < cout) {
      float t = 0.f;
#pragma unroll
      for (int wi = 0; wi < NTHREADS / 32; ++wi) t += sRed[wi][which][c];
      partial[((static_cast<int64_t>(b) * tiles + tile) * 2 + which) * cout +
              n0 + c] = t;
    }
  }
}

// sums[which, b, c] = the tiles' partial sums of image b, added in index order
__global__ void __launch_bounds__(256)
conv_stats_finish_kernel(const float* __restrict__ partial,
                         float* __restrict__ sums, int batch, int cout,
                         int tiles) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= 2 * cout) return;
  const float* src = partial + static_cast<int64_t>(b) * tiles * 2 * cout + i;
  float t = 0.f;
  for (int k = 0; k < tiles; ++k) t += src[static_cast<int64_t>(k) * 2 * cout];
  const int which = i / cout;
  sums[(static_cast<int64_t>(which) * batch + b) * cout + i % cout] = t;
}

template <typename T, int KS, bool GN, int TH>
int launch(const T* x, const T* w, const float* bias, const T* skip,
           const float* in_sum, const float* in_sq, const float* gamma,
           const float* beta, T* y, float* partial, float* sums, int b, int hh,
           int ww, int cin, int cout, int groups, float eps, int silu,
           cudaStream_t stream) {
  auto kernel = conv_stats_kernel<T, KS, GN, TH>;
  const int smem = tile_bytes<T, KS, TH>() +
                   (GN ? 2 * ((cin + 7) / 8 * 8) * static_cast<int>(sizeof(float))
                       : 0);
  if (smem > 232448) return -1;  // what a block may use
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (ww + TW - 1) / TW;
  const int tiles = tiles_w * ((hh + TH - 1) / TH);
  const float inv_count =
      GN ? 1.f / (static_cast<float>(hh) * static_cast<float>(ww) *
                  static_cast<float>(cin / groups))
         : 0.f;
  kernel<<<dim3(b * tiles, (cout + BNC - 1) / BNC), TH * 16, smem, stream>>>(
      x, w, bias, skip, in_sum, in_sq, gamma, beta, y, partial, hh, ww, cin,
      cout, tiles_w, tiles, groups, inv_count, eps, silu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_stats_finish_kernel<<<dim3((2 * cout + 255) / 256, b), 256, 0, stream>>>(
      partial, sums, b, cout, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The C entry points' common body: the shape checks, then design 1 (the
// implicit GEMM of conv_igemm.cuh; w [Cout, K, K, Cin]) or design 0 (pixel
// patches, this file; w [K, K, Cin, Cout]) as the caller's plan says.
template <typename T>
int dispatch(const void* x, const void* w, const void* bias, const void* skip,
             const void* in_sum, const void* in_sq, const void* gamma,
             const void* beta, void* y, void* partial, void* sums, int b,
             int hh, int ww, int cin, int cout, int ksize, int design,
             int tile_rows, int block_n, int splits, int groups, float eps,
             int silu, void* stream) {
  const bool gn = in_sum != nullptr;
  if (b < 1 || b > 65535 || hh < 1 || ww < 1 || cin < 1 || cout < 8 ||
      cout % 8 != 0 || (ksize != 1 && ksize != 3) ||
      design < 0 || design > 3)
    return -1;
  if (gn && (in_sq == nullptr || gamma == nullptr || beta == nullptr ||
             groups < 1 || groups > MAX_GROUPS || cin % groups != 0))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto ct = [](const void* p) { return static_cast<const T*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  T* yo = static_cast<T*>(y);
  float* pa = static_cast<float*>(partial);
  float* su = static_cast<float*>(sums);
  if (design > 0)
    return ig_dispatch<T>(ct(x), ct(w), cf(bias), ct(skip), cf(in_sum),
                          cf(in_sq), cf(gamma), cf(beta), yo, pa, su, b, hh,
                          ww, cin, cout, ksize, block_n, splits, groups, eps,
                          silu, design >= 2 ? design - 1 : 0, s);
  if (tile_rows != 8 && !(tile_rows == 16 && ksize == 3)) return -1;
#define DSML_CONV_LAUNCH(KS, GN, TH)                                    \
  launch<T, KS, GN, TH>(ct(x), ct(w), cf(bias), ct(skip), cf(in_sum),   \
                        cf(in_sq), cf(gamma), cf(beta), yo, pa, su, b, hh, \
                        ww, cin, cout, groups, eps, silu, s)
#define DSML_CONV_ROWS(KS, GN)                                                \
  (tile_rows == 8 ? DSML_CONV_LAUNCH(KS, GN, 8) : DSML_CONV_LAUNCH(KS, GN, 16))
  if (ksize == 1)
    return gn ? DSML_CONV_LAUNCH(1, true, 8) : DSML_CONV_LAUNCH(1, false, 8);
  return gn ? DSML_CONV_ROWS(3, true) : DSML_CONV_ROWS(3, false);
#undef DSML_CONV_ROWS
#undef DSML_CONV_LAUNCH
}

}  // namespace
}  // namespace conv
