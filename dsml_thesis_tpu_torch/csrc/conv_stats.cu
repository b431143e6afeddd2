// conv_stats: a K x K (K = 1 or 3) SAME stride-1 convolution on channel-last
// tensors with the GroupNorm statistics of its output taken in its epilogue,
// and optionally the GroupNorm(+SiLU) of its INPUT applied on the way in:
//   x [B, H, W, Cin] bf16, w [K, K, Cin, Cout] bf16, bias [B, Cout] fp32
//   (the conv bias plus any per-batch vector), skip [B, H, W, Cout] bf16 or
//   null, in_sum / in_sq [B, Cin] fp32 with gamma / beta [Cin] fp32 or null
//   -> y [B, H, W, Cout] bf16 = cast(conv(norm(x)) + bias + skip), and the
//      per (batch, channel) sum and sum of squares of y AS STORED, fp32, as
//      sums [2, B, Cout].
//
// Replaces the TPU kernel dsml_thesis_tpu/ops/conv_gn.py:_conv_kernel
// (conv_stats_pallas). That kernel takes one whole image a grid step: the
// image, its zero-padded copy, the weights and an fp32 accumulator all sit
// in fast memory, the conv is K * K shifted [H*W, Cin] x [Cin, Cout]
// products, and the statistics are column sums of the finished image. None
// of that fits a block here (227 KB), and one block an image would leave the
// card idle. Here the conv is an implicit GEMM on mma.sync (bf16 operands,
// fp32 accumulate): a block owns a 16 x 16 (or, for K = 1 and for images of
// up to 8 rows, 8 x 16) patch of output pixels of one image and 64 output
// channels, a warp
// two patch rows, and walks Cin in chunks of 32. For a chunk it loads the
// patch with its one-pixel halo once into shared memory and the chunk's
// weights of all K * K taps; a tap is then the same tile read at shifted
// pixel rows (ldmatrix takes a row address per lane, so the shift costs
// nothing), never a gathered copy.
//   * The input's GroupNorm(+SiLU) is applied while the halo tile is loaded:
//     once a block, the channel sums are folded into the groups' mean and
//     rstd (variance max(E[x^2] - E[x]^2, 0), eps inside the root) and from
//     those, gamma and beta into one fp32 scale and shift per channel, so an
//     element costs one fma, the SiLU and the cast to bf16. The zero border
//     is applied AFTER the norm: a tap outside the image reads 0, not
//     norm(0).
//   * The statistics are of the values as rounded to bf16, the ones a later
//     normalisation will read. A block reduces its patch per channel (warp
//     shuffles, then the block's warps in index order) into
//     partial [B, tiles, 2, Cout]; a second launch adds an image's tiles in
//     index order. No atomics: equal inputs give equal bits.
//
// Bound: operations (2 * B * H * W * K * K * Cin * Cout against the bytes of
// x, w, skip and y once each) for every shape of the UNet and the first
// stage; the 1 x 1 convs at small Cin are close to the bytes side. This
// first version loads synchronously and single-buffered, re-reads the input
// patch once per 64 output channels and masks a last, partly empty channel
// tile (Cout = 160 wastes a sixth); cp.async / TMA pipelining, wgmma and a
// channel tile that divides Cout are later work.
#include "mma_tiles.cuh"

namespace {

constexpr int TW = 16;          // output columns: one m16 tile a patch row
constexpr int BNC = 64;         // output channels of a block
constexpr int KC = 32;          // input channels of a chunk
constexpr int MAX_GROUPS = 64;  // of the input GroupNorm

// Bytes of shared memory of the tiles of a block with TH patch rows: the halo
// tile and the weights of a chunk. With the input norm, a scale and a shift
// per input channel (fp32) follow them.
template <int KS, int TH>
constexpr int conv_tile_bytes() {
  return ((TH + KS - 1) * (TW + KS - 1) * (KC + PAD) +
          KS * KS * KC * (BNC + PAD)) *
         static_cast<int>(sizeof(bf16));
}

// TH output rows of a block's patch; TH / 2 warps, warp w owns patch rows
// 2 w and 2 w + 1.
template <int KS, bool GN, int TH>
__global__ void __launch_bounds__(TH * 16)
conv_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ bias, const bf16* __restrict__ skip,
                  const float* __restrict__ in_sum,
                  const float* __restrict__ in_sq,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, bf16* __restrict__ y,
                  float* __restrict__ partial, int hh, int ww, int cin,
                  int cout, int tiles_w, int tiles, int groups,
                  float inv_count, float eps, int silu) {
  constexpr int NTHREADS = TH * 16;
  constexpr int HALO_H = TH + KS - 1;
  constexpr int HALO_W = TW + KS - 1;
  constexpr int BORDER = (KS - 1) / 2;
  constexpr int LDX = KC + PAD;
  constexpr int LDW = BNC + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);  // [HALO_H * HALO_W][LDX]
  bf16* sW = sX + HALO_H * HALO_W * LDX;         // [KS * KS][KC][LDW]
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
  const bf16* xb = x + static_cast<int64_t>(b) * hh * ww * cin;
  const bool vec = cin % 8 == 0;  // 16-byte loads of x need aligned pixels

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
    for (int i = tid; i < HALO_H * HALO_W * (KC / 8); i += NTHREADS) {
      const int pix = i / (KC / 8);
      const int cc = (i % (KC / 8)) * 8;
      const int gh = h0 + pix / HALO_W - BORDER;
      const int gw = w0 + pix % HALO_W - BORDER;
      const int ch = c0 + cc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gh >= 0 && gh < hh && gw >= 0 && gw < ww && ch < cin) {
        const bf16* src = xb + (static_cast<int64_t>(gh) * ww + gw) * cin + ch;
        if (!GN && vec) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          float f[8];
          if (vec) {
            const uint4 raw = *reinterpret_cast<const uint4*>(src);
            const __nv_bfloat162* p =
                reinterpret_cast<const __nv_bfloat162*>(&raw);
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
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
        }
      }
      *reinterpret_cast<uint4*>(sX + pix * LDX + cc) = v;
    }
    // the chunk's weights of every tap, output channels n0 .. n0 + BNC - 1
    for (int i = tid; i < KS * KS * KC * (BNC / 8); i += NTHREADS) {
      const int row = i / (BNC / 8);  // tap * KC + depth within the chunk
      const int cc = (i % (BNC / 8)) * 8;
      const int tap = row / KC;
      const int kr = row % KC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + kr < cin && n0 + cc < cout)
        v = *reinterpret_cast<const uint4*>(
            w + (static_cast<int64_t>(tap) * cin + c0 + kr) * cout + n0 + cc);
      *reinterpret_cast<uint4*>(sW + row * LDW + cc) = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < KS * KS; ++tap) {
      const int dy = tap / KS;
      const int dx = tap % KS;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        if (c0 + kk >= cin) break;  // a depth step of nothing but padding
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
    }
  }

  // epilogue: + bias (+ skip), one cast, the store, and the column sums of
  // the stored values over this block's pixels inside the image
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
        if (skip != nullptr) {
          const float2 sk = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(skip + pix * cout + col));
          v0 += sk.x;
          v1 += sk.y;
        }
        const __nv_bfloat162 out = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(y + pix * cout + col) = out;
        const float2 f = __bfloat1622float2(out);
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

template <int KS, bool GN, int TH>
int launch(const bf16* x, const bf16* w, const float* bias, const bf16* skip,
           const float* in_sum, const float* in_sq, const float* gamma,
           const float* beta, bf16* y, float* partial, float* sums, int b,
           int hh, int ww, int cin, int cout, int groups, float eps, int silu,
           cudaStream_t stream) {
  auto kernel = conv_stats_kernel<KS, GN, TH>;
  const int smem = conv_tile_bytes<KS, TH>() +
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

}  // namespace

// skip may be null; in_sum, in_sq, gamma, beta are all null (no input norm)
// or all given. tile_rows is the rows of a block's patch: 8, or 16 (K = 3
// only: a 1 x 1 conv does too little work a chunk to keep eight warps between
// its barriers busy); partial is
// fp32 scratch [B, tiles, 2, Cout] with
// tiles = ceil(H / tile_rows) * ceil(W / 16); sums is [2, B, Cout]. Needs
// Cout % 8 == 0 and, with the input norm, Cin % groups == 0 and groups <= 64.
// Returns cudaGetLastError() of the launches (0 = launched), or -1 for a
// shape this file does not take.
extern "C" int dsml_conv_stats(const void* x, const void* w, const void* bias,
                               const void* skip, const void* in_sum,
                               const void* in_sq, const void* gamma,
                               const void* beta, void* y, void* partial,
                               void* sums, int b, int hh, int ww, int cin,
                               int cout, int ksize, int tile_rows, int groups,
                               float eps, int silu, void* stream) {
  const bool gn = in_sum != nullptr;
  if (b < 1 || b > 65535 || hh < 1 || ww < 1 || cin < 1 || cout < 8 ||
      cout % 8 != 0 || (ksize != 1 && ksize != 3) ||
      (tile_rows != 8 && !(tile_rows == 16 && ksize == 3)))
    return -1;
  if (gn && (in_sq == nullptr || gamma == nullptr || beta == nullptr ||
             groups < 1 || groups > MAX_GROUPS || cin % groups != 0))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto cb = [](const void* p) { return static_cast<const bf16*>(p); };
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  bf16* yo = static_cast<bf16*>(y);
  float* pa = static_cast<float*>(partial);
  float* su = static_cast<float*>(sums);
#define DSML_CONV_LAUNCH(KS, GN, TH)                                          \
  launch<KS, GN, TH>(cb(x), cb(w), cf(bias), cb(skip), cf(in_sum), cf(in_sq), \
                     cf(gamma), cf(beta), yo, pa, su, b, hh, ww, cin, cout,   \
                     groups, eps, silu, s)
#define DSML_CONV_ROWS(KS, GN)                                                \
  (tile_rows == 8 ? DSML_CONV_LAUNCH(KS, GN, 8) : DSML_CONV_LAUNCH(KS, GN, 16))
  if (ksize == 1)
    return gn ? DSML_CONV_LAUNCH(1, true, 8) : DSML_CONV_LAUNCH(1, false, 8);
  return gn ? DSML_CONV_ROWS(3, true) : DSML_CONV_ROWS(3, false);
#undef DSML_CONV_ROWS
#undef DSML_CONV_LAUNCH
}
