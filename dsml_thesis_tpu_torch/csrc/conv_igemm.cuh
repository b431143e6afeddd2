// conv_stats on wgmma, for Hopper: designs 1-3 of the plan
// (ops/conv_gn.py:conv_plan; conv_stats.cuh holds design 0, pixel patches on
// mma.sync, and the dispatch). All three are the K x K conv as an implicit
// GEMM over flattened output pixels:
//   M = B * H * W output pixels (batch, row, column flattened, so an 8 x 8
//       image fills a tile as well as a 64 x 64 one), N = Cout, K = taps x Cin
//       (a k-tile is KC channels of one tap, a 128-byte row of A and of B).
//   A row = the NHWC input pixel that tap (dy, dx) of an output pixel reads:
//       Cin is contiguous, so A is K-major; a tap outside the image, a pixel
//       past M and a channel past Cin are zeros.
//   B = the weight as [Cout][tap][Cin] (a Conv2d weight's own channels_last
//       order), K-major too: TF32 wgmma takes K-major shared-memory operands
//       only, and bf16 reads the same layout.
// A block is two warpgroups over BM = 128 pixels (64 each) and BN output
// channels (160, 128 or 64: the widest that divides Cout, else 64 with a
// masked last tile), m64nBNk16 bf16 or m64nBNk8 TF32 wgmma with fp32
// accumulators in registers, both operands from 128-byte-swizzled shared
// memory, fed by cp.async 16-byte copies in a ring; one __syncthreads a
// k-tile, each warpgroup's product waited for at once (ptxas of CUDA 12.8
// crashes on this kernel with shared-memory work placed between a product
// and its wait; the overlap comes from a second block an SM where one fits).
//   * Design 1 (tap-major k-tiles): A and B straight from device memory into
//     a ring of IG_STAGES stages, two blocks an SM. The input GroupNorm(+SiLU)
//     and, in fp32, the TF32 rounding (cvt.rna) of A and B are a pass in
//     shared memory over the chunks each thread copied, after they land and
//     before the product: one fma with the channel's scale and shift (the
//     group's mean and rstd folded with gamma / beta), the SiLU, the
//     rounding; a zero-filled tap stays 0 (the border is applied after the
//     norm). A pass, not registers: the norm runs once a chunk for both
//     warpgroups, and TF32 wgmma's A from registers would need 32-bit
//     fragment loads. The norm is recomputed for every tap and every N tile
//     (K x K x Cout / BN times an input element), so design 1 is the plan's
//     choice where A needs no norm: the 1 x 1 convs and the unnormed 3 x 3.
//   * Designs 2 and 3, the strip (chunk-major k-tiles, 3 x 3 only): for
//     chunk c the block copies the input rows its nine taps can read,
//     flattened pixels m0 - W - 1 .. m0 + BM + W, into a strip, runs the
//     pass over it once, and builds each tap's A tile from the strip rows
//     shifted by the tap (zeros where the tap leaves the image), a 16-byte
//     shared-memory copy a chunk: the norm runs (BM + 2 W + 2) / BM times an
//     input element a chunk and N tile instead of nine. Design 2 is one block
//     an SM with four B stages and two A tiles, design 3 two blocks an SM
//     with two B stages and one A tile (one more barrier a k-tile).
//   * Split over K: where the output tiles cannot fill the SMs' blocks, a
//     tile's k-tiles (in 2 and 3, whole chunks) are cut into `splits` (1, 2,
//     4 or 8) ranges, one a block of a thread-block cluster along K. Each
//     block parks its fp32 accumulator in its shared memory; rank r then
//     sums rows r * BM / splits .. of every rank's tile in rank order
//     through distributed shared memory and runs the epilogue on them. No
//     atomics: equal inputs give equal bits.
//   * Epilogue: + bias (+ skip) in fp32, one rounding to the stored type, the
//     store (16 or 8 bytes a thread, coalesced along Cout), and the stored
//     values back into shared memory; then a thread a column adds its slice's
//     rows in order, image by image (a slice may hold the end of one image
//     and the start of the next), into partial [slices, imgs, 2, Cout]; a
//     second launch adds an image's slices in index order.
// Bound: operations at every UNet and first-stage shape but the narrowest
// 1 x 1 convs. What holds the designs back (ablations by tools/variants.py,
// H100 SXM at 700 W, PERF.md): each k-tile runs its copies, pass,
// barrier and product one after another, so removing any one of them (the
// products included) moves the time by a fifth or less; the products alone
// are a sixth of the time at [16,8,8,1280->640] in fp32.
#pragma once

#include "hopper_tf32.cuh"
#include "hopper_tiles.cuh"

namespace conv {
namespace {

constexpr int IG_BM = 128;       // output pixels of a block
constexpr int IG_THREADS = 256;  // two warpgroups
constexpr int IG_STAGES = 3;     // k-tiles of the ring
constexpr int IG_ROWB = 128;     // bytes of a tile row: one k-tile's depth
constexpr int IG_CH = IG_ROWB / 16;  // 16-byte chunks of a row
constexpr int IG_MAX_SPLITS = 8;     // ranks of a cluster along K

template <typename T>
struct IgTraits;
template <>
struct IgTraits<bf16> {
  static constexpr int KC = 64;  // channels of a k-tile
  static constexpr int VEC = 8;  // channels of a 16-byte chunk
};
template <>
struct IgTraits<float> {
  static constexpr int KC = 32;
  static constexpr int VEC = 4;
};

// Shared memory of a block: the ring (which the epilogue's fp32 tile of
// IG_BM x (BN + 4) floats reuses), and 1024 bytes of alignment slack.
__host__ __device__ constexpr int ig_smem_bytes(int bn) {
  return IG_STAGES * (IG_BM + bn) * IG_ROWB + 1024;
}

// Images a slice of `sl` consecutive pixels can touch: the partial sums a
// slice writes for each column.
__host__ __device__ inline int ig_images(int sl, int hw, int batch) {
  const int n = (sl - 2 + hw) / hw + 1;
  return n < batch ? n : batch;
}

// d[64 x 64] += A[64 x 16] B, both K-major in shared memory (bf16)
__device__ __forceinline__ void mma_bf16_n64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B, both K-major in shared memory (bf16)
__device__ __forceinline__ void mma_bf16_n128(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 160] += A[64 x 16] B, both K-major in shared memory (bf16)
__device__ __forceinline__ void mma_bf16_n160(float (&d)[80], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

template <typename T, int BN>
__device__ __forceinline__ void ig_mma(float (&d)[BN / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (BN == 64) mma_bf16_n64(d, da, db);
    if constexpr (BN == 128) mma_bf16_n128(d, da, db);
    if constexpr (BN == 160) mma_bf16_n160(d, da, db);
  } else {
    hopper::wgmma_tf32_ss<BN>(d, da, db, 1);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ig_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// SiLU as the patch design computes it (conv_stats.cuh:halo_vector)
__device__ __forceinline__ float ig_silu(float t) {
  return __fdividef(t, 1.f + __expf(-t));
}

// One 16-byte chunk of A in shared memory, in place: normalised with the
// channels' scale and shift (GN), SiLU'd, rounded to the stored type (bf16)
// or to TF32 (fp32).
template <bool GN>
__device__ __forceinline__ void ig_prepare_a(bf16* p, const float* sc,
                                             const float* sh, int silu) {
  if (!GN) return;
  uint4 raw = *reinterpret_cast<uint4*>(p);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    float t0 = fmaf(f.x, sc[2 * j], sh[2 * j]);
    float t1 = fmaf(f.y, sc[2 * j + 1], sh[2 * j + 1]);
    if (silu) {
      t0 = ig_silu(t0);
      t1 = ig_silu(t1);
    }
    h[j] = __floats2bfloat162_rn(t0, t1);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

template <bool GN>
__device__ __forceinline__ void ig_prepare_a(float* p, const float* sc,
                                             const float* sh, int silu) {
  float4 v = *reinterpret_cast<float4*>(p);
  float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float t = f[j];
    if (GN) {
      t = fmaf(t, sc[j], sh[j]);
      if (silu) t = ig_silu(t);
    }
    f[j] = __uint_as_float(ig_tf32(t));
  }
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// Four neighbouring outputs of one pixel: + skip, the store, and the values
// as stored.
__device__ __forceinline__ float4 ig_store(bf16* y, const bf16* skip,
                                           float4 v) {
  if (skip != nullptr) {
    const uint2 raw = *reinterpret_cast<const uint2*>(skip);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v.x += a.x;
    v.y += a.y;
    v.z += b.x;
    v.w += b.y;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 out;
  out.x = *reinterpret_cast<const uint32_t*>(&lo);
  out.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(y) = out;
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 ig_store(float* y, const float* skip,
                                           float4 v) {
  if (skip != nullptr) {
    const float4 s = *reinterpret_cast<const float4*>(skip);
    v.x += s.x;
    v.y += s.y;
    v.z += s.z;
    v.w += s.w;
  }
  *reinterpret_cast<float4*>(y) = v;
  return v;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  const uint4 u = hopper::ld_cluster16(addr);
  return make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                     __uint_as_float(u.z), __uint_as_float(u.w));
}

// The epilogue of both kernels, after the products: the accumulator parked
// in sC (the ring), the split ranks' sums in rank order through distributed
// shared memory, + bias (+ skip), the store, and the slice's column sums.
template <typename T, int BN>
__device__ __forceinline__ void ig_epilogue(
    const float (&acc)[BN / 2], float* sC, const float* __restrict__ bias,
    const T* __restrict__ skip, T* __restrict__ y, float* __restrict__ partial,
    int m0, int n0, int hw, int m_total, int cout, int rank, int splits,
    int imgs) {
  constexpr int LDC = BN + 4;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  {
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row = wg * 64 + 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(sC + row * LDC + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(sC + (row + 8) * LDC + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  if (splits > 1) {
    hopper::cluster_arrive();
    hopper::cluster_wait();  // every rank's accumulator is parked
  } else {
    __syncthreads();
  }
  // this rank's slice of the tile's rows: the ranks' sums in rank order, +
  // bias (+ skip), the store, the values as stored back into sC
  const int sl = IG_BM / splits;
  const int rs = rank * sl;
  constexpr int CV = BN / 4;
  for (int idx = tid; idx < sl * CV; idx += IG_THREADS) {
    const int row = rs + idx / CV;
    const int q = idx % CV;
    float* at = sC + row * LDC + 4 * q;
    float4 v = *reinterpret_cast<float4*>(at);
    if (splits > 1) {
      // every rank's partial first (the loads in flight together), then
      // their sum in rank order
      const uint32_t addr = hopper::cvta(at);
      float4 u[IG_MAX_SPLITS];
#pragma unroll
      for (int k = 0; k < IG_MAX_SPLITS; ++k)
        if (k < splits) u[k] = ld_cluster_f4(hopper::map_rank(addr, k));
      v = u[0];
#pragma unroll
      for (int k = 1; k < IG_MAX_SPLITS; ++k)
        if (k < splits) {
          v.x += u[k].x;
          v.y += u[k].y;
          v.z += u[k].z;
          v.w += u[k].w;
        }
    }
    const int m = m0 + row;
    const int col = n0 + 4 * q;
    if (m < m_total && col < cout) {
      const float* bb = bias + static_cast<int64_t>(m / hw) * cout + col;
      v.x += bb[0];
      v.y += bb[1];
      v.z += bb[2];
      v.w += bb[3];
      const int64_t o = static_cast<int64_t>(m) * cout + col;
      v = ig_store(y + o, skip == nullptr ? nullptr : skip + o, v);
    }
    *reinterpret_cast<float4*>(at) = v;
  }
  if (splits > 1) hopper::cluster_arrive();  // done reading the other ranks
  __syncthreads();
  // the slice's column sums of the stored values, image by image, in row
  // order
  const int g0 = m0 + rs;
  const int g1 = min(g0 + sl, m_total);
  if (tid < BN && n0 + tid < cout && g0 < g1) {
    const int slice = g0 / sl;
    const int first = g0 / hw;
    for (int bi = first; bi * hw < g1; ++bi) {
      const int lo = max(g0, bi * hw), hi = min(g1, (bi + 1) * hw);
      float su = 0.f, sq = 0.f;
      for (int r = lo; r < hi; ++r) {
        const float v = sC[(r - m0) * LDC + tid];
        su += v;
        sq += v * v;
      }
      float* dst = partial +
                   ((static_cast<int64_t>(slice) * imgs + (bi - first)) * 2) *
                       cout +
                   n0 + tid;
      dst[0] = su;
      dst[cout] = sq;
    }
  }
  if (splits > 1) hopper::cluster_wait();  // no rank leaves while read
}

// Grid: tiles x splits blocks (clusters of `splits` along x when splits > 1);
// tile = m tile x n_tiles + n tile.
template <typename T, int KS, bool GN, int BN>
__global__ void __launch_bounds__(IG_THREADS, 2)
conv_igemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, const T* __restrict__ skip,
                  const float* __restrict__ in_sum,
                  const float* __restrict__ in_sq,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ partial, int hh, int ww, int m_total,
                  int cin, int cout, int n_tiles, int splits, int imgs,
                  int groups, float inv_count, float eps, int silu) {
  using Tr = IgTraits<T>;
  constexpr int KC = Tr::KC;
  constexpr int VEC = Tr::VEC;
  constexpr int BORDER = (KS - 1) / 2;
  constexpr int ROWS_A = IG_THREADS / IG_CH;  // rows a round of copies covers
  constexpr int A_PER = IG_BM / ROWS_A;       // A chunks a thread
  constexpr int B_PER = BN / ROWS_A;          // B chunks a thread
  constexpr int A_BYTES = IG_BM * IG_ROWB;
  constexpr int STAGE = (IG_BM + BN) * IG_ROWB;
  constexpr int LDC = BN + 4;
  static_assert(BN % ROWS_A == 0 && IG_BM % ROWS_A == 0, "whole rounds");
  static_assert(IG_BM * LDC * 4 <= IG_STAGES * STAGE, "epilogue in the ring");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align_smem(smem_raw, 1024);
  float* sC = reinterpret_cast<float*>(ring);  // [IG_BM][LDC], after the loop

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int rank = blockIdx.x % splits;
  const int tile = blockIdx.x / splits;
  const int m0 = (tile / n_tiles) * IG_BM;
  const int n0 = (tile % n_tiles) * BN;
  const int hw = hh * ww;
  const int cpt = (cin + KC - 1) / KC;  // k-tiles a tap
  const int kt_all = KS * KS * cpt;
  const int kt0 =
      static_cast<int>(static_cast<int64_t>(rank) * kt_all / splits);
  const int nk =
      static_cast<int>(static_cast<int64_t>(rank + 1) * kt_all / splits) - kt0;
  const int cc = tid % IG_CH;  // this thread's chunk of every row it copies
  const int r_first = tid / IG_CH;

  const int first_img = m0 / hw;
  // the output pixels of this thread's A rows: h, w and the slot of the
  // image among the tile's (h = a large negative number past M, so that
  // every tap of it reads zeros)
  int ph[A_PER], pw[A_PER], pimg[A_PER];
#pragma unroll
  for (int j = 0; j < A_PER; ++j) {
    const int m = m0 + r_first + j * ROWS_A;
    const int rem = m % hw;
    ph[j] = m < m_total ? rem / ww : -(1 << 20);
    pw[j] = rem % ww;
    pimg[j] = m / hw - first_img;
  }
  // group mean and rstd of each image the tile touches, from the input's
  // channel sums: variance max(E[x^2] - E[x]^2, 0), eps inside the root
  float* sG = reinterpret_cast<float*>(ring + IG_STAGES * STAGE);
  if (GN) {
    const int cg = cin / groups;
    const int last_img = (min(m0 + IG_BM, m_total) - 1) / hw;
    for (int i = tid; i < (last_img - first_img + 1) * groups;
         i += IG_THREADS) {
      const int s = i / groups, g = i % groups;
      const float* ch_sum =
          in_sum + static_cast<int64_t>(first_img + s) * cin + g * cg;
      const float* ch_sq =
          in_sq + static_cast<int64_t>(first_img + s) * cin + g * cg;
      float su = 0.f, sq = 0.f;
      for (int j = 0; j < cg; ++j) {
        su += ch_sum[j];
        sq += ch_sq[j];
      }
      const float mean = su * inv_count;
      const float var = fmaxf(sq * inv_count - mean * mean, 0.f);
      sG[2 * groups * s + g] = mean;
      sG[2 * groups * s + groups + g] = 1.f / sqrtf(var + eps);
    }
    __syncthreads();
  }

  // the tap and channel of k-tile kt
  auto tap_of = [&](int kt, int& dy, int& dx, int& ch) {
    const int tap = kt / cpt;
    dy = tap / KS - BORDER;
    dx = tap % KS - BORDER;
    ch = (kt % cpt) * KC + cc * VEC;
    return tap;
  };
  auto inside = [&](int j, int dy, int dx) {
    const int ih = ph[j] + dy, iw = pw[j] + dx;
    return ih >= 0 && ih < hh && iw >= 0 && iw < ww;
  };
  auto load = [&](int kt, int stage) {
    int dy, dx, ch;
    const int tap = tap_of(kt, dy, dx, ch);
    const bool ch_ok = ch < cin;
    const uint32_t sa = hopper::cvta(ring + stage * STAGE);
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int r = r_first + j * ROWS_A;
      const bool ok = ch_ok && inside(j, dy, dx);
      const T* src =
          ok ? x + (static_cast<int64_t>(m0 + r) + dy * ww + dx) * cin + ch : x;
      hopper::cp_async16(sa + hopper::Swz<IG_ROWB>::at(r, cc), src, ok);
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int n = r_first + j * ROWS_A;
      const bool ok = ch_ok && n0 + n < cout;
      const T* src =
          ok ? w + (static_cast<int64_t>(n0 + n) * (KS * KS) + tap) * cin + ch
             : w;
      hopper::cp_async16(sa + A_BYTES + hopper::Swz<IG_ROWB>::at(n, cc), src,
                         ok);
    }
  };
  // the pass over the chunks this thread copied of k-tile kt
  auto prepare = [&](int kt, int stage) {
    int dy, dx, ch;
    tap_of(kt, dy, dx, ch);
    if (ch >= cin) return;  // zeros, in either type
    unsigned char* sa = ring + stage * STAGE;
    float ga[VEC], be[VEC];
    if (GN) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        ga[v] = gamma[ch + v];
        be[v] = beta[ch + v];
      }
    }
    const int cg = GN ? cin / groups : 1;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      if (!inside(j, dy, dx)) continue;
      float sc[VEC], sh[VEC];
      if (GN) {
        const float* g_stats = sG + 2 * groups * pimg[j];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int g = (ch + v) / cg;
          sc[v] = g_stats[groups + g] * ga[v];
          sh[v] = be[v] - g_stats[g] * sc[v];
        }
      }
      const int r = r_first + j * ROWS_A;
      ig_prepare_a<GN>(
          reinterpret_cast<T*>(sa + hopper::Swz<IG_ROWB>::at(r, cc)), sc, sh,
          silu);
    }
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < B_PER; ++j) {
        const int n = r_first + j * ROWS_A;
        if (n0 + n >= cout) continue;
        float* p = reinterpret_cast<float*>(sa + A_BYTES +
                                            hopper::Swz<IG_ROWB>::at(n, cc));
        const float4 v = *reinterpret_cast<float4*>(p);
        *reinterpret_cast<float4*>(p) = make_float4(
            __uint_as_float(ig_tf32(v.x)), __uint_as_float(ig_tf32(v.y)),
            __uint_as_float(ig_tf32(v.z)), __uint_as_float(ig_tf32(v.w)));
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // the ring: k-tiles kt0 + i land in stage i % IG_STAGES, IG_STAGES - 1 of
  // them in flight (an empty group where a split has fewer k-tiles)
#pragma unroll
  for (int i = 0; i < IG_STAGES - 1; ++i) {
    if (i < nk) load(kt0 + i, i);
    cp_async_commit_group();
  }
  constexpr bool PASS = GN || sizeof(T) == 4;
  for (int i = 0; i < nk; ++i) {
    const int stage = i % IG_STAGES;
    cp_async_wait<IG_STAGES - 2>();  // this thread's copies of k-tile i
    if (PASS) prepare(kt0 + i, stage);
    hopper::fence_async_shared();
    // every thread's copies and pass of k-tile i are in; every warpgroup's
    // product of k-tile i - 1 is done, so its stage takes k-tile i + 2
    __syncthreads();
    if (i + IG_STAGES - 1 < nk)
      load(kt0 + i + IG_STAGES - 1, (i + IG_STAGES - 1) % IG_STAGES);
    cp_async_commit_group();
    const uint32_t sa = hopper::cvta(ring + stage * STAGE);
    const uint32_t a = sa + wg * 64 * IG_ROWB;
    const uint32_t b = sa + A_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < IG_ROWB / 32; ++k)
      ig_mma<T, BN>(acc, hopper::desc_k<IG_ROWB>(a + 32 * k),
                    hopper::desc_k<IG_ROWB>(b + 32 * k));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: park the accumulator in it
  ig_epilogue<T, BN>(acc, sC, bias, skip, y, partial, m0, n0, hw, m_total,
                     cout, rank, splits, imgs);
}

// Designs 2 and 3 (see the note at the top): the strip's occupancies, one
// block an SM with a ring of four B tiles and two A tiles, or two blocks an
// SM with two B tiles and one A tile.
template <bool TWO>
struct StripShape {
  static constexpr int STAGES = TWO ? 2 : 4;  // B tiles of the ring
  static constexpr int ABUF = TWO ? 1 : 2;    // A tiles
  static constexpr int BLOCKS = TWO ? 2 : 1;  // blocks an SM
};

__host__ __device__ inline int ig_strip_rows(int ww) {
  return IG_BM + 2 * ww + 2;
}

__host__ __device__ inline int ig_strip_bytes(int ww) {
  return (ig_strip_rows(ww) * IG_ROWB + 1023) / 1024 * 1024;
}

template <typename T, bool GN, int BN, bool TWO>
__global__ void __launch_bounds__(IG_THREADS, StripShape<TWO>::BLOCKS)
conv_strip_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, const T* __restrict__ skip,
                  const float* __restrict__ in_sum,
                  const float* __restrict__ in_sq,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ partial, int hh, int ww, int m_total,
                  int cin, int cout, int n_tiles, int splits, int imgs,
                  int groups, float inv_count, float eps, int silu) {
  using Tr = IgTraits<T>;
  constexpr int KC = Tr::KC;
  constexpr int VEC = Tr::VEC;
  constexpr int SB = StripShape<TWO>::STAGES;
  constexpr int ROWS_A = IG_THREADS / IG_CH;
  constexpr int A_PER = IG_BM / ROWS_A;
  constexpr int B_PER = BN / ROWS_A;
  constexpr int A_BYTES = IG_BM * IG_ROWB;
  constexpr int B_BYTES = BN * IG_ROWB;
  constexpr int AB = StripShape<TWO>::ABUF;
  static_assert(IG_BM * (BN + 4) * 4 <= SB * B_BYTES + AB * A_BYTES +
                                            2 * 17 * 1024,
                "epilogue in the ring and the strips");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align_smem(smem_raw, 1024);
  unsigned char* sB = ring;                 // [SB][BN] rows, swizzled
  unsigned char* sA = sB + SB * B_BYTES;    // [AB][IG_BM] rows, swizzled
  unsigned char* sS = sA + AB * A_BYTES;    // [2][strip rows], plain
  const int strip_rows = ig_strip_rows(ww);
  const int strip_bytes = ig_strip_bytes(ww);
  float* sG = reinterpret_cast<float*>(sS + 2 * strip_bytes);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int rank = blockIdx.x % splits;
  const int tile = blockIdx.x / splits;
  const int m0 = (tile / n_tiles) * IG_BM;
  const int n0 = (tile % n_tiles) * BN;
  const int hw = hh * ww;
  const int cpt = (cin + KC - 1) / KC;
  const int c_lo = static_cast<int>(static_cast<int64_t>(rank) * cpt / splits);
  const int c_hi =
      static_cast<int>(static_cast<int64_t>(rank + 1) * cpt / splits);
  const int nk = (c_hi - c_lo) * 9;
  const int cc = tid % IG_CH;
  const int r_first = tid / IG_CH;
  const int s0 = m0 - ww - 1;  // flattened pixel of strip row 0

  int ph[A_PER], pw[A_PER];
#pragma unroll
  for (int j = 0; j < A_PER; ++j) {
    const int m = m0 + r_first + j * ROWS_A;
    const int rem = m % hw;
    ph[j] = m < m_total ? rem / ww : -(1 << 20);
    pw[j] = rem % ww;
  }
  // group mean and rstd of each image the strip touches
  const int first_img = max(s0, 0) / hw;
  if (GN) {
    const int cg = cin / groups;
    const int last_img = (min(s0 + strip_rows, m_total) - 1) / hw;
    for (int i = tid; i < (last_img - first_img + 1) * groups;
         i += IG_THREADS) {
      const int sl = i / groups, g = i % groups;
      const float* ch_sum =
          in_sum + static_cast<int64_t>(first_img + sl) * cin + g * cg;
      const float* ch_sq =
          in_sq + static_cast<int64_t>(first_img + sl) * cin + g * cg;
      float su = 0.f, sq = 0.f;
      for (int j = 0; j < cg; ++j) {
        su += ch_sum[j];
        sq += ch_sq[j];
      }
      const float mean = su * inv_count;
      const float var = fmaxf(sq * inv_count - mean * mean, 0.f);
      sG[2 * groups * sl + g] = mean;
      sG[2 * groups * sl + groups + g] = 1.f / sqrtf(var + eps);
    }
  }
  __syncthreads();

  // the strip of chunk c: this thread copies chunk cc of rows tid / 8 + 32 k
  auto load_strip = [&](int c, int buf) {
    const int ch = c * KC + cc * VEC;
    const bool ch_ok = ch < cin;
    const uint32_t dst = hopper::cvta(sS + buf * strip_bytes) + cc * 16;
    for (int r = r_first; r < strip_rows; r += ROWS_A) {
      const int g = s0 + r;
      const bool ok = ch_ok && g >= 0 && g < m_total;
      hopper::cp_async16(dst + r * IG_ROWB,
                         ok ? x + static_cast<int64_t>(g) * cin + ch : x, ok);
    }
  };
  // the pass over the strip chunks this thread copied: norm, SiLU, rounding
  auto pass_strip = [&](int c, int buf) {
    const int ch = c * KC + cc * VEC;
    if (ch >= cin) return;
    unsigned char* base = sS + buf * strip_bytes + cc * 16;
    float ga[VEC], be[VEC];
    int gi[VEC];
    if (GN) {
      const int cg = cin / groups;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        ga[v] = gamma[ch + v];
        be[v] = beta[ch + v];
        gi[v] = (ch + v) / cg;
      }
    }
    int slot = -1;
    float sc[VEC], sh[VEC];
    for (int r = r_first; r < strip_rows; r += ROWS_A) {
      const int g = s0 + r;
      if (g < 0 || g >= m_total) continue;
      if (GN && g / hw - first_img != slot) {
        slot = g / hw - first_img;
        const float* st = sG + 2 * groups * slot;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          sc[v] = st[groups + gi[v]] * ga[v];
          sh[v] = be[v] - st[gi[v]] * sc[v];
        }
      }
      ig_prepare_a<GN>(reinterpret_cast<T*>(base + r * IG_ROWB), sc, sh,
                       silu);
    }
  };
  auto load_b = [&](int i, int stage) {
    const int tap = i % 9;
    const int ch = (c_lo + i / 9) * KC + cc * VEC;
    const bool ch_ok = ch < cin;
    const uint32_t dst = hopper::cvta(sB + stage * B_BYTES);
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int n = r_first + j * ROWS_A;
      const bool ok = ch_ok && n0 + n < cout;
      hopper::cp_async16(
          dst + hopper::Swz<IG_ROWB>::at(n, cc),
          ok ? w + (static_cast<int64_t>(n0 + n) * 9 + tap) * cin + ch : w,
          ok);
    }
  };
  auto round_b = [&](int i, int stage) {
    const int ch = (c_lo + i / 9) * KC + cc * VEC;
    if (ch >= cin) return;
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int n = r_first + j * ROWS_A;
      if (n0 + n >= cout) continue;
      float* p = reinterpret_cast<float*>(sB + stage * B_BYTES +
                                          hopper::Swz<IG_ROWB>::at(n, cc));
      const float4 v = *reinterpret_cast<float4*>(p);
      *reinterpret_cast<float4*>(p) = make_float4(
          __uint_as_float(ig_tf32(v.x)), __uint_as_float(ig_tf32(v.y)),
          __uint_as_float(ig_tf32(v.z)), __uint_as_float(ig_tf32(v.w)));
    }
  };
  // A of a tap: strip row r + W + 1 + dy W + dx for output row r, or zeros
  auto build_a = [&](int tap, int sbuf, int abuf) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const unsigned char* src =
        sS + sbuf * strip_bytes + (ww + 1 + dy * ww + dx) * IG_ROWB + cc * 16;
    unsigned char* dst = sA + abuf * A_BYTES;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const int r = r_first + j * ROWS_A;
      const int ih = ph[j] + dy, iw = pw[j] + dx;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ih >= 0 && ih < hh && iw >= 0 && iw < ww)
        v = *reinterpret_cast<const uint4*>(src + r * IG_ROWB);
      *reinterpret_cast<uint4*>(dst + hopper::Swz<IG_ROWB>::at(r, cc)) = v;
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // groups: the first strip with B of iteration 0, then one a k-tile, each
  // with the B of k-tile i + SB - 1 and, at a chunk's first tap, the next
  // chunk's strip (nine k-tiles ahead)
  if (nk > 0) load_strip(c_lo, 0);
#pragma unroll
  for (int i = 0; i < SB - 1; ++i) {
    if (i < nk) load_b(i, i);
    cp_async_commit_group();
  }
  for (int i = 0; i < nk; ++i) {
    const int tap = i % 9;
    const int cl = i / 9;
    const int sbuf = cl & 1;
    cp_async_wait<SB - 2>();  // B of k-tile i; at tap 0 the strip too
    if (tap == 0) {
      pass_strip(c_lo + cl, sbuf);
      __syncthreads();  // the strip is ready; the other one is free
      if (c_lo + cl + 1 < c_hi) load_strip(c_lo + cl + 1, sbuf ^ 1);
    }
    if (AB == 1) __syncthreads();  // the product of k-tile i - 1 is done
    build_a(tap, sbuf, i % AB);
    if constexpr (sizeof(T) == 4) round_b(i, i % SB);
    hopper::fence_async_shared();
    __syncthreads();  // A and B of k-tile i are in; k-tile i - 1 is done
    if (i + SB - 1 < nk) load_b(i + SB - 1, (i + SB - 1) % SB);
    cp_async_commit_group();
    const uint32_t a =
        hopper::cvta(sA + (i % AB) * A_BYTES) + wg * 64 * IG_ROWB;
    const uint32_t b = hopper::cvta(sB + (i % SB) * B_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < IG_ROWB / 32; ++k)
      ig_mma<T, BN>(acc, hopper::desc_k<IG_ROWB>(a + 32 * k),
                    hopper::desc_k<IG_ROWB>(b + 32 * k));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  ig_epilogue<T, BN>(acc, reinterpret_cast<float*>(ring), bias, skip, y,
                     partial, m0, n0, hw, m_total, cout, rank, splits, imgs);
}

// sums[which, b, c] = the slices' partial sums of image b, in slice order
__global__ void __launch_bounds__(256)
conv_igemm_finish_kernel(const float* __restrict__ partial,
                         float* __restrict__ sums, int batch, int cout,
                         int hw, int sl, int imgs) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= 2 * cout) return;
  const int which = i / cout;
  const int c = i % cout;
  const int64_t lo = static_cast<int64_t>(b) * hw / sl;
  const int64_t hi = (static_cast<int64_t>(b + 1) * hw - 1) / sl;
  float t = 0.f;
  for (int64_t j = lo; j <= hi; ++j) {
    const int64_t first = j * sl / hw;
    t += partial[((j * imgs + (b - first)) * 2 + which) * cout + c];
  }
  sums[(static_cast<int64_t>(which) * batch + b) * cout + c] = t;
}

// Shared memory of a block with the input norm's group statistics: the
// ring (design 2: the B ring, two A tiles and two strips) and 2 * groups
// floats for each image a tile (a strip) touches.
inline int ig_smem_total(int bn, bool gn, int strip, int ww, int hw,
                         int batch, int groups) {
  if (strip)
    return (strip == 2 ? StripShape<true>::STAGES : StripShape<false>::STAGES) *
               bn * IG_ROWB +
           (strip == 2 ? StripShape<true>::ABUF : StripShape<false>::ABUF) *
               IG_BM * IG_ROWB +
           2 * ig_strip_bytes(ww) + 1024 +
           (gn ? ig_images(ig_strip_rows(ww), hw, batch) * 2 * groups * 4
               : 0);
  return ig_smem_bytes(bn) +
         (gn ? ig_images(IG_BM, hw, batch) * 2 * groups * 4 : 0);
}

template <typename T, int KS, bool GN, int BN>
int ig_launch(const T* x, const T* w, const float* bias, const T* skip,
              const float* in_sum, const float* in_sq, const float* gamma,
              const float* beta, T* y, float* partial, float* sums, int b,
              int hh, int ww, int cin, int cout, int splits, int groups,
              float eps, int silu, int strip, cudaStream_t stream) {
  auto kernel = conv_igemm_kernel<T, KS, GN, BN>;
  if (strip) {
    if (KS != 3 || splits > (cin + IgTraits<T>::KC - 1) / IgTraits<T>::KC)
      return -1;
    kernel = strip == 2 ? conv_strip_kernel<T, GN, BN, true>
                        : conv_strip_kernel<T, GN, BN, false>;
  }
  const int hw = hh * ww;
  const int smem = ig_smem_total(BN, GN, strip, ww, hw, b, groups);
  if (smem > 232448) return -1;
  const int m_total = b * hw;
  const int m_tiles = (m_total + IG_BM - 1) / IG_BM;
  const int n_tiles = (cout + BN - 1) / BN;
  const int sl = IG_BM / splits;
  const int imgs = ig_images(sl, hw, b);
  const float inv_count =
      GN ? 1.f / (static_cast<float>(hh) * static_cast<float>(ww) *
                  static_cast<float>(cin / groups))
         : 0.f;
  const int err = hopper::launch_cluster_grid(
      kernel, m_tiles * n_tiles * splits, IG_THREADS, smem, splits, stream,
      x, w, bias, skip, in_sum, in_sq, gamma, beta, y, partial, hh, ww,
      m_total, cin, cout, n_tiles, splits, imgs, groups, inv_count, eps, silu);
  if (err != 0) return err;
  conv_igemm_finish_kernel<<<dim3((2 * cout + 255) / 256, b), 256, 0,
                             stream>>>(partial, sums, b, cout, hw, sl, imgs);
  return static_cast<int>(cudaGetLastError());
}

// Design 1's instantiation for (K, input norm, BN).
template <typename T>
int ig_dispatch(const T* x, const T* w, const float* bias, const T* skip,
                const float* in_sum, const float* in_sq, const float* gamma,
                const float* beta, T* y, float* partial, float* sums, int b,
                int hh, int ww, int cin, int cout, int ksize, int block_n,
                int splits, int groups, float eps, int silu, int strip,
                cudaStream_t stream) {
  const bool gn = in_sum != nullptr;
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (cin % IgTraits<T>::VEC != 0 || misaligned(x) || misaligned(w) ||
      misaligned(y) || misaligned(skip) ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      static_cast<int64_t>(b) * hh * ww >= (int64_t(1) << 31) / 2)
    return -1;
#define DSML_IG(KS, GN, BN)                                                  \
  ig_launch<T, KS, GN, BN>(x, w, bias, skip, in_sum, in_sq, gamma, beta, y, \
                           partial, sums, b, hh, ww, cin, cout, splits,     \
                           groups, eps, silu, strip, stream)
#define DSML_IG_BN(KS, GN)                                          \
  (block_n == 160 ? DSML_IG(KS, GN, 160)                            \
                  : block_n == 128 ? DSML_IG(KS, GN, 128)           \
                                   : block_n == 64 ? DSML_IG(KS, GN, 64) : -1)
  if (ksize == 1) return gn ? DSML_IG_BN(1, true) : DSML_IG_BN(1, false);
  return gn ? DSML_IG_BN(3, true) : DSML_IG_BN(3, false);
#undef DSML_IG_BN
#undef DSML_IG
}

}  // namespace
}  // namespace conv
