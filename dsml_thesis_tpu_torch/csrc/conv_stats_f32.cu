// conv_stats in fp32 (TF32 products, fp32 accumulation): the first stage's
// convs in training. The kernel, its design and what is rounded where:
// conv_stats.cuh.
#include "conv_stats.cuh"

// As dsml_conv_stats (conv_stats.cu) with x, w, skip, y fp32. Returns
// cudaGetLastError() of the launches (0 = launched), or -1 for a shape this
// file does not take.
extern "C" int dsml_conv_stats_f32(const void* x, const void* w,
                                   const void* bias, const void* skip,
                                   const void* in_sum, const void* in_sq,
                                   const void* gamma, const void* beta,
                                   void* y, void* partial, void* sums, int b,
                                   int hh, int ww, int cin, int cout,
                                   int ksize, int design, int tile_rows,
                                   int block_n, int splits, int groups,
                                   float eps, int silu, void* stream) {
  return conv::dispatch<float>(x, w, bias, skip, in_sum, in_sq, gamma, beta, y,
                               partial, sums, b, hh, ww, cin, cout, ksize,
                               design, tile_rows, block_n, splits, groups,
                               eps, silu, stream);
}
