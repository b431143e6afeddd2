// conv_stats in bf16: the UNet's convs, and the first stage's in sampling.
// The kernel, its design and what is rounded where: conv_stats.cuh.
#include "conv_stats.cuh"

// x, w, skip, y bf16; skip may be null; in_sum, in_sq, gamma, beta (fp32)
// are all null (no input norm) or all given. The plan (ops/conv_gn.py:
// conv_plan) names the design:
//   design 1, the implicit GEMM: w [Cout, K, K, Cin]; block_n output channels
//     a block (64, 128 or 160), splits k-ranges a tile (1, 2, 4 or 8, one a
//     block of a cluster); partial is fp32 scratch [slices, imgs, 2, Cout]
//     with slices = ceil(B * H * W / 128) * splits and imgs the images 128 /
//     splits consecutive pixels can touch (conv_igemm.cuh:ig_images); needs
//     Cin a multiple of 8 and 16-byte aligned x, w, skip, y;
//   design 0, pixel patches: w [K, K, Cin, Cout]; tile_rows the rows of a
//     block's patch, 8 or 16 (K = 3 only); partial [B, tiles, 2, Cout] with
//     tiles = ceil(H / tile_rows) * ceil(W / 16).
// sums is [2, B, Cout]. Needs Cout % 8 == 0 and, with the input norm,
// Cin % groups == 0 and groups <= 64. Returns cudaGetLastError() of the
// launches (0 = launched), or -1 for a shape this file does not take.
extern "C" int dsml_conv_stats(const void* x, const void* w, const void* bias,
                               const void* skip, const void* in_sum,
                               const void* in_sq, const void* gamma,
                               const void* beta, void* y, void* partial,
                               void* sums, int b, int hh, int ww, int cin,
                               int cout, int ksize, int design, int tile_rows,
                               int block_n, int splits, int groups,
                               float eps, int silu, void* stream) {
  return conv::dispatch<bf16>(x, w, bias, skip, in_sum, in_sq, gamma, beta, y,
                              partial, sums, b, hh, ww, cin, cout, ksize,
                              design, tile_rows, block_n, splits, groups,
                              eps, silu, stream);
}
