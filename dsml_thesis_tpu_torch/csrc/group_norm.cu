// GroupNorm(+SiLU) on channel-last tensors, and its channel statistics, for
// activations in bf16 (the UNet, the first stage in sampling) or fp32 (the
// first stage in training):
//   dsml_group_norm_silu[_f32]   x [B, N, C] -> y [B, N, C] of x's type,
//       fp32 mean / rstd per (batch, group) over N x C/G elements, variance
//       max(E[x^2] - E[x]^2, 0) with eps inside the root, fp32 affine,
//       optional SiLU, one cast to x's type (none in fp32);
//   dsml_gn_channel_stats[_f32]  x [B, N, C] -> per (batch, channel) sum and
//       sum of squares, fp32, as sums [2, B, C].
// Both types run the same kernels: templates on the activation type T.
//
// Replace the TPU kernels dsml_thesis_tpu/ops/groupnorm.py:_gn_kernel
// (group_norm_silu_pallas) and :_gn_stats_kernel (_gn_channel_stats_pallas).
// The first keeps a whole batch row in fast memory (and so refuses rows over
// 8 MB) and folds channels into groups with an indicator matrix product; the
// second carries its sums from one grid step to the next. Neither carries
// over: a Hopper block holds 227 KB, blocks run in no order, and a batch row
// (up to 16 MB in the first stage in bf16, 8 MB at 128 px in fp32) is one
// reduction across many blocks.
//
// Both are bound by bytes: x read once, y written once (or 2 * B * C floats).
// The design reduces per channel, never per group: C/G is 5 at C = 160, so a
// group is 10 bytes of each 320-byte row, while channels-last rows read as
// 16 bytes a thread (VEC = 8 bf16 or 4 fp32 channels) coalesce whatever C/G
// is.
//
// The statistics op is one launch (gn_stats_cluster_kernel): a
// thread-block cluster of k blocks (up to 16, ops/groupnorm.py:stats_plan:
// B x k within the 132 SMs) takes a batch row; each block streams its
// contiguous rows with eight independent 16-byte loads in flight a thread
// (512 threads: C / VEC column vectors x row lanes), adds its row lanes in
// lane order in shared memory, and the ranks add the cluster's partial sums
// in rank order through distributed shared memory and write sums
// [2, B, C] once. No scratch, no second launch, no atomics.
//
// The whole-row op's three passes, a block cvb x rl threads (cvb =
// min(C / VEC, 256) column vectors, rl = 256 / cvb row lanes; a thread keeps
// its VEC channels for all its rows):
//   partial  grid (chunks, B, slabs): sums of a chunk of rows, reduced over
//            the row lanes in shared memory, to partial [B, chunks, 2, C];
//   finish   one thread per (batch, channel): adds the chunks' partial sums
//            in index order into sums [2, B, C];
//   apply    same grid as partial: folds the channel sums into the groups'
//            mean and rstd (C floats, cheap to repeat in every block),
//            normalises, scales, shifts, applies SiLU and writes y.
// No floating-point atomics anywhere: every sum has a fixed order, so equal
// inputs give equal bits. The statistics pass and the apply pass both read x
// from device memory; at the UNet's shapes (up to 63 MB a tensor) the second
// read mostly finds x in the 50 MB L2 cache, at the first stage's fp32 shapes
// (up to 134 MB) much of it does not.
//
// The whole-row op has a second design for small rows: the cluster
// (gn_cluster_kernel, chosen by ops/groupnorm.py:gn_plan for rows of up to
// 192 Ki elements that eight blocks' shared memory holds). One launch
// instead of three, no scratch, x read once: a thread-block cluster of 8
// serves one batch element, each block copies its rows into shared memory
// (cp.async), sums them per channel, the blocks add the cluster's partial
// sums in rank order through distributed shared memory, fold them into the
// groups exactly as the apply kernel does and normalise their rows from
// shared memory. Its phases run one after another in one block an SM, so at
// the device it only matches the three passes at the rows it takes (0.0146
// against 0.0166 ms at [16,1024,160] fp32, 0.0168 against 0.0150 at
// [16,64,1280]) and loses past them (0.0291 against 0.0216 at [16,256,960];
// tools/variants.py, H100 SXM at 700 W); its gain is the host's: one launch
// and no allocation a call where the three passes issue three and two.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

constexpr int GN_THREADS = 256;

// 16 bytes of activations as floats: VEC channels, loaded and stored whole.
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* p, float (&f)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <int VEC>
struct GnBlock {
  int cvb;  // column vectors (VEC channels each) of a block
  int rl;   // row lanes
  int cv;   // this thread's column vector of the row, or -1 if it has none
  int lane; // this thread's row lane
  __device__ __forceinline__ GnBlock(int c) {
    const int cvs = c / VEC;
    cvb = cvs < GN_THREADS ? cvs : GN_THREADS;
    rl = GN_THREADS / cvb;
    lane = threadIdx.x / cvb;
    cv = blockIdx.z * cvb + threadIdx.x % cvb;
    if (lane >= rl || cv >= cvs) cv = -1;
  }
};

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                  int n, int c, int rows_per_chunk) {
  constexpr int VEC = Vec<T>::N;
  // [2][rl][cvb * VEC] floats: at most 2 * 256 * 8
  __shared__ float red[2 * GN_THREADS * 8];
  const GnBlock<VEC> blk(c);
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int width = blk.cvb * VEC;  // channels of this block's slab
  float s[VEC], sq[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = sq[j] = 0.f;
  if (blk.cv >= 0) {
    const int r_end = min(n, (chunk + 1) * rows_per_chunk);
    const T* xb = x + static_cast<int64_t>(b) * n * c + blk.cv * VEC;
    for (int r = chunk * rows_per_chunk + blk.lane; r < r_end; r += blk.rl) {
      float f[VEC];
      Vec<T>::load(xb + static_cast<int64_t>(r) * c, f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] += f[j];
        sq[j] += f[j] * f[j];
      }
    }
  }
  if (blk.lane < blk.rl) {
    float* rs = red + blk.lane * width + (threadIdx.x % blk.cvb) * VEC;
    float* rq = rs + blk.rl * width;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      rs[j] = s[j];
      rq[j] = sq[j];
    }
  }
  __syncthreads();
  // the row lanes' sums of one channel, added in lane order
  const int c0 = blockIdx.z * width;
  float* dst = partial + (static_cast<int64_t>(b) * gridDim.x + chunk) * 2 * c;
  for (int i = threadIdx.x; i < 2 * width; i += GN_THREADS) {
    const int which = i / width;
    const int ch = i % width;
    if (c0 + ch >= c) continue;
    const float* src = red + which * blk.rl * width + ch;
    float t = 0.f;
    for (int l = 0; l < blk.rl; ++l) t += src[l * width];
    dst[which * c + c0 + ch] = t;
  }
}

__global__ void __launch_bounds__(GN_THREADS)
gn_finish_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                 int batch, int c, int chunks) {
  const int i = blockIdx.x * GN_THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= 2 * c) return;
  const float* src = partial + static_cast<int64_t>(b) * chunks * 2 * c + i;
  float t = 0.f;
  for (int k = 0; k < chunks; ++k) t += src[static_cast<int64_t>(k) * 2 * c];
  const int which = i / c;
  sums[(static_cast<int64_t>(which) * batch + b) * c + i % c] = t;
}

template <bool PARAMS_BF16>
__device__ __forceinline__ float param(const void* p, int i) {
  if (PARAMS_BF16) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <typename T, bool PARAMS_BF16, bool SILU>
__global__ void __launch_bounds__(GN_THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ sums,
                const void* __restrict__ gamma, const void* __restrict__ beta,
                T* __restrict__ y, int batch, int n, int c, int groups,
                int rows_per_chunk, float inv_count, float eps) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float g_stats[];  // [groups] mean, [groups] rstd
  const GnBlock<VEC> blk(c);
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int cg = c / groups;
  const float* ch_sum = sums + static_cast<int64_t>(b) * c;
  const float* ch_sq = ch_sum + static_cast<int64_t>(batch) * c;
  for (int g = threadIdx.x; g < groups; g += GN_THREADS) {
    float s = 0.f, q = 0.f;
    for (int j = 0; j < cg; ++j) {
      s += ch_sum[g * cg + j];
      q += ch_sq[g * cg + j];
    }
    const float mean = s * inv_count;
    const float var = fmaxf(q * inv_count - mean * mean, 0.f);
    g_stats[g] = mean;
    g_stats[groups + g] = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  if (blk.cv < 0) return;

  float mean[VEC], rstd[VEC], ga[VEC], be[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int ch = blk.cv * VEC + j;
    mean[j] = g_stats[ch / cg];
    rstd[j] = g_stats[groups + ch / cg];
    ga[j] = param<PARAMS_BF16>(gamma, ch);
    be[j] = param<PARAMS_BF16>(beta, ch);
  }
  const int r_end = min(n, (chunk + 1) * rows_per_chunk);
  const int64_t base = static_cast<int64_t>(b) * n * c + blk.cv * VEC;
  for (int r = chunk * rows_per_chunk + blk.lane; r < r_end; r += blk.rl) {
    const int64_t off = base + static_cast<int64_t>(r) * c;
    float f[VEC];
    Vec<T>::load(x + off, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float t = (f[j] - mean[j]) * rstd[j] * ga[j] + be[j];
      if (SILU) t = t / (1.f + expf(-t));
      f[j] = t;
    }
    Vec<T>::store(y + off, f);
  }
}

// The cluster design (see the note at the top): a cluster of `cluster`
// blocks serves one batch element; block `rank` holds rows rank * rpb ..
// (rpb = rows_per_block) of it in shared memory from one cp.async pass, sums
// them per channel (row lanes in shared memory, added in lane order), the
// blocks add the cluster's partial sums in rank order through distributed
// shared memory (every block the same sums in the same order), fold them
// into the groups' mean and rstd as gn_apply_kernel does, and each block
// normalises its rows from shared memory and writes them.
constexpr int GNC_THREADS = 512;  // threads of a cluster block

template <typename T>
__host__ __device__ constexpr int gn_cluster_smem(int rpb, int c, int groups) {
  // rows, then fp32: partial [2][c], sums [2][c], per channel mean, rstd,
  // gamma, beta [4][c], group mean and rstd [2][groups] (rounded up to 16
  // bytes), row-lane sums [2][rl][c]
  return rpb * c * static_cast<int>(sizeof(T)) +
         4 * (8 * c + (2 * groups + 3) / 4 * 4 +
              2 * (GNC_THREADS / (c / Vec<T>::N < GNC_THREADS
                                      ? c / Vec<T>::N
                                      : GNC_THREADS)) * c);
}

template <typename T, bool PARAMS_BF16, bool SILU>
__global__ void __launch_bounds__(GNC_THREADS)
gn_cluster_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                  const void* __restrict__ beta, T* __restrict__ y, int n,
                  int c, int groups, int cluster, int rpb, float inv_count,
                  float eps) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % cluster;
  const int b = blockIdx.x / cluster;
  const int r0 = min(n, rank * rpb);
  const int rows = min(n, r0 + rpb) - r0;
  const int cvs = c / VEC;
  const int nvec = rows * cvs;
  T* sx = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(smem + static_cast<int64_t>(rpb) *
                                                    c * sizeof(T));
  float* tot = part + 2 * c;
  float* chan = tot + 2 * c;  // mean, rstd, gamma, beta of each channel
  float* g_stats = chan + 4 * c;
  float* red = g_stats + (2 * groups + 3) / 4 * 4;
  const int64_t base = (static_cast<int64_t>(b) * n + r0) * c;

  for (int i = tid; i < nvec; i += GNC_THREADS)
    hopper::cp_async16(hopper::cvta(sx + static_cast<int64_t>(i) * VEC),
                       x + base + static_cast<int64_t>(i) * VEC, true);
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  for (int ch = tid; ch < c; ch += GNC_THREADS) {
    chan[2 * c + ch] = param<PARAMS_BF16>(gamma, ch);
    chan[3 * c + ch] = param<PARAMS_BF16>(beta, ch);
  }
  __syncthreads();

  // a thread's column vector and row lane, in the sums and in the apply:
  // cvb column vectors (VEC channels each) x rl row lanes (a thread walks
  // several column vectors only where there are more of them than threads,
  // and then rl = 1)
  const int cvb = cvs < GNC_THREADS ? cvs : GNC_THREADS;
  const int rl = GNC_THREADS / cvb;
  const int lane = tid / cvb;
  if (lane < rl) {
    for (int cv = tid % cvb; cv < cvs; cv += cvb) {
      float s[VEC], sq[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[j] = sq[j] = 0.f;
      for (int r = lane; r < rows; r += rl) {
        float f[VEC];
        Vec<T>::load(sx + static_cast<int64_t>(r) * c + cv * VEC, f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[j] += f[j];
          sq[j] += f[j] * f[j];
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        *reinterpret_cast<float4*>(red + lane * c + cv * VEC + j) =
            make_float4(s[j], s[j + 1], s[j + 2], s[j + 3]);
        *reinterpret_cast<float4*>(red + (rl + lane) * c + cv * VEC + j) =
            make_float4(sq[j], sq[j + 1], sq[j + 2], sq[j + 3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * c; i += GNC_THREADS) {
    const float* src = red + (i / c) * rl * c + i % c;
    float t = 0.f;
    for (int l = 0; l < rl; ++l) t += src[l * c];
    part[i] = t;
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();  // every block's partial sums are in
  for (int i = tid; i < c / 2; i += GNC_THREADS) {  // float4s of [2][c]
    const uint32_t addr = hopper::cvta(part + 4 * i);
    uint4 u = hopper::ld_cluster16(hopper::map_rank(addr, 0));
    float4 t = make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                           __uint_as_float(u.z), __uint_as_float(u.w));
    for (int k = 1; k < cluster; ++k) {
      u = hopper::ld_cluster16(hopper::map_rank(addr, k));
      t.x += __uint_as_float(u.x);
      t.y += __uint_as_float(u.y);
      t.z += __uint_as_float(u.z);
      t.w += __uint_as_float(u.w);
    }
    *reinterpret_cast<float4*>(tot + 4 * i) = t;
  }
  hopper::cluster_arrive();  // done reading the other blocks (waited at exit)
  __syncthreads();
  const int cg = c / groups;
  for (int g = tid; g < groups; g += GNC_THREADS) {
    float s = 0.f, q = 0.f;
    for (int j = 0; j < cg; ++j) {
      s += tot[g * cg + j];
      q += tot[c + g * cg + j];
    }
    const float mean = s * inv_count;
    const float var = fmaxf(q * inv_count - mean * mean, 0.f);
    g_stats[g] = mean;
    g_stats[groups + g] = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += GNC_THREADS) {
    chan[ch] = g_stats[ch / cg];
    chan[c + ch] = g_stats[groups + ch / cg];
  }
  __syncthreads();

  if (lane < rl) {
    for (int cv = tid % cvb; cv < cvs; cv += cvb) {
      float mean[VEC], rstd[VEC], ga[VEC], be[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ch = cv * VEC + j;
        mean[j] = chan[ch];
        rstd[j] = chan[c + ch];
        ga[j] = chan[2 * c + ch];
        be[j] = chan[3 * c + ch];
      }
      for (int r = lane; r < rows; r += rl) {
        const int64_t off = static_cast<int64_t>(r) * c + cv * VEC;
        float f[VEC];
        Vec<T>::load(sx + off, f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float t = (f[j] - mean[j]) * rstd[j] * ga[j] + be[j];
          if (SILU) t = t / (1.f + expf(-t));
          f[j] = t;
        }
        Vec<T>::store(y + base + off, f);
      }
    }
  }
  hopper::cluster_wait();
}

// The whole-row op's statistics pass: partial sums, then the fixed-order
// finish.
template <typename T>
static int launch_stats(const T* x, float* partial, float* sums, int b, int n,
                        int c, int chunks, dim3* grid, int* rows_per_chunk,
                        cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  if (b < 1 || n < 1 || c < VEC || c % VEC != 0 || chunks < 1 || chunks > n ||
      b > 65535)
    return -1;
  *rows_per_chunk = (n + chunks - 1) / chunks;
  const int cvs = c / VEC;
  const int cvb = cvs < GN_THREADS ? cvs : GN_THREADS;
  *grid = dim3(chunks, b, (cvs + cvb - 1) / cvb);
  gn_partial_kernel<T><<<*grid, GN_THREADS, 0, stream>>>(x, partial, n, c,
                                                         *rows_per_chunk);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  gn_finish_kernel<<<dim3((2 * c + GN_THREADS - 1) / GN_THREADS, b), GN_THREADS,
                     0, stream>>>(partial, sums, b, c, chunks);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- channel statistics ---
// The statistics op (row 10) in one launch: `cluster` blocks of a
// thread-block cluster a batch row (ops/groupnorm.py:stats_plan), each over
// its contiguous rows with ST_LOADS independent 16-byte loads in flight a
// thread; the ranks add the cluster's partial sums in rank order through
// distributed shared memory and write the result once (see the note at the
// top).
constexpr int ST_THREADS = 512;
constexpr int ST_LOADS = 8;

// 16 bytes of x into sums and sums of squares of its VEC channels
__device__ __forceinline__ void stats_add(uint4 v, float (&s)[8],
                                          float (&q)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    s[2 * i] += t.x;
    q[2 * i] = fmaf(t.x, t.x, q[2 * i]);
    s[2 * i + 1] += t.y;
    q[2 * i + 1] = fmaf(t.y, t.y, q[2 * i + 1]);
  }
}
__device__ __forceinline__ void stats_add(uint4 v, float (&s)[4],
                                          float (&q)[4]) {
  const float f[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                      __uint_as_float(v.z), __uint_as_float(v.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] += f[j];
    q[j] = fmaf(f[j], f[j], q[j]);
  }
}

// Shared-memory floats of a statistics block: row-lane sums [2][rl][c],
// then the block's partial sums [2][c].
__host__ __device__ constexpr int stats_lanes(int cvs) {
  return cvs < ST_THREADS ? ST_THREADS / cvs : 1;
}
template <typename T>
__host__ __device__ constexpr int stats_smem(int c) {
  return 4 * (2 * stats_lanes(c / Vec<T>::N) * c + 2 * c);
}

// The block's per-channel sums over rows [r0, r1) of the batch row at xb
// into part [2][c] (shared memory), in a fixed order: a thread adds its
// rows in order (a column vector of VEC channels, every rl-th row), then the
// row lanes are added in lane order. Ends with part visible to the block.
template <typename T>
__device__ __forceinline__ void block_stats(const T* __restrict__ xb, int r0,
                                            int r1, int c, float* red,
                                            float* part) {
  constexpr int VEC = Vec<T>::N;
  const int tid = threadIdx.x;
  const int cvs = c / VEC;
  const int cvb = cvs < ST_THREADS ? cvs : ST_THREADS;
  const int rl = stats_lanes(cvs);
  const int lane = tid / cvb;
  if (lane < rl) {
    for (int cv = tid % cvb; cv < cvs; cv += cvb) {
      float s[VEC], q[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
      const T* p = xb + cv * VEC;
      int r = r0 + lane;
      for (; r + (ST_LOADS - 1) * rl < r1; r += ST_LOADS * rl) {
        uint4 v[ST_LOADS];
#pragma unroll
        for (int u = 0; u < ST_LOADS; ++u)
          v[u] = *reinterpret_cast<const uint4*>(
              p + static_cast<int64_t>(r + u * rl) * c);
#pragma unroll
        for (int u = 0; u < ST_LOADS; ++u) stats_add(v[u], s, q);
      }
      for (; r < r1; r += rl)
        stats_add(*reinterpret_cast<const uint4*>(
                      p + static_cast<int64_t>(r) * c),
                  s, q);
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        *reinterpret_cast<float4*>(red + lane * c + cv * VEC + j) =
            make_float4(s[j], s[j + 1], s[j + 2], s[j + 3]);
        *reinterpret_cast<float4*>(red + (rl + lane) * c + cv * VEC + j) =
            make_float4(q[j], q[j + 1], q[j + 2], q[j + 3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * c; i += ST_THREADS) {
    const float* src = red + (i / c) * rl * c + i % c;
    float t = 0.f;
    for (int l = 0; l < rl; ++l) t += src[l * c];
    part[i] = t;
  }
  __syncthreads();
}

// Design 0: block rank of cluster b takes rows rank * rpb .. (rpb = rows a
// block); rank r then adds float4 i = r, r + cluster * ST_THREADS, .. of
// every rank's [2][c] partial sums in rank order and writes it to sums.
template <typename T>
__global__ void __launch_bounds__(ST_THREADS)
gn_stats_cluster_kernel(const T* __restrict__ x, float* __restrict__ sums,
                        int batch, int n, int c, int cluster, int rpb) {
  extern __shared__ __align__(16) float st_smem[];
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % cluster;
  const int b = blockIdx.x / cluster;
  const int r0 = min(n, rank * rpb);
  float* part = st_smem;
  block_stats<T>(x + static_cast<int64_t>(b) * n * c, r0, min(n, r0 + rpb), c,
                 part + 2 * c, part);
  hopper::cluster_arrive();
  hopper::cluster_wait();  // every rank's partial sums are in
  for (int i = rank * ST_THREADS + tid; i < c / 2; i += cluster * ST_THREADS) {
    const uint32_t addr = hopper::cvta(part + 4 * i);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < cluster; ++k) {
      const uint4 u = hopper::ld_cluster16(hopper::map_rank(addr, k));
      t.x += __uint_as_float(u.x);
      t.y += __uint_as_float(u.y);
      t.z += __uint_as_float(u.z);
      t.w += __uint_as_float(u.w);
    }
    const int which = 4 * i / c, ch = 4 * i % c;
    *reinterpret_cast<float4*>(
        sums + (static_cast<int64_t>(which) * batch + b) * c + ch) = t;
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();  // no block leaves while another may read it
}

// One launch of gn_stats_cluster_kernel: `blocks` blocks (1-16) of a
// cluster a batch row. The kernel's attributes (dynamic shared memory up to
// the limit, clusters past 8 blocks) are set once a process.
template <typename T>
static int channel_stats(const void* x, void* sums, int b, int n, int c,
                         int blocks, void* stream) {
  if (b < 1 || n < 1 || c < Vec<T>::N || c % Vec<T>::N != 0 || blocks < 1 ||
      blocks > 16 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(sums) % 16 != 0)
    return -1;
  const int smem = stats_smem<T>(c);
  if (smem > 232448) return -1;
  static const int set = [] {
    int err = static_cast<int>(cudaFuncSetAttribute(
        gn_stats_cluster_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 232448));
    if (err == 0)
      err = static_cast<int>(cudaFuncSetAttribute(
          gn_stats_cluster_kernel<T>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    return err;
  }();
  if (set != 0) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * blocks));
  cfg.blockDim = dim3(ST_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_stats_cluster_kernel<T>, static_cast<const T*>(x),
      static_cast<float*>(sums), b, n, c, blocks, (n + blocks - 1) / blocks);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
static int group_norm_silu(const void* x, const void* gamma, const void* beta,
                           void* partial, void* sums, void* y, int b, int n,
                           int c, int groups, int chunks, int cluster,
                           float eps, int silu, int params_bf16,
                           void* stream) {
  if (groups < 1 || c % groups != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_count =
      1.f / (static_cast<float>(n) * static_cast<float>(c / groups));
  if (cluster > 0) {
    const int rpb = (n + cluster - 1) / cluster;
    const int smem = gn_cluster_smem<T>(rpb, c, groups);
    if (cluster > 8 || b < 1 || c < Vec<T>::N || c % Vec<T>::N != 0 ||
        smem > 232448 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0)
      return -1;
    auto kernel = silu ? gn_cluster_kernel<T, false, true>
                       : gn_cluster_kernel<T, false, false>;
    if (params_bf16)
      kernel = silu ? gn_cluster_kernel<T, true, true>
                    : gn_cluster_kernel<T, true, false>;
    return hopper::launch_cluster_grid(
        kernel, b * cluster, GNC_THREADS, smem, cluster, s,
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), n, c,
        groups, cluster, rpb, inv_count, eps);
  }
  dim3 grid;
  int rows_per_chunk;
  int err = launch_stats(static_cast<const T*>(x),
                         static_cast<float*>(partial),
                         static_cast<float*>(sums), b, n, c, chunks, &grid,
                         &rows_per_chunk, s);
  if (err != 0) return err;
  // bf16 parameters: a model cast for sampling, beside either activation
  // type (an fp32 UNet's sampling casts its parameters too)
  auto kernel = silu ? gn_apply_kernel<T, false, true>
                     : gn_apply_kernel<T, false, false>;
  if (params_bf16)
    kernel = silu ? gn_apply_kernel<T, true, true>
                  : gn_apply_kernel<T, true, false>;
  kernel<<<grid, GN_THREADS, 2 * groups * sizeof(float), s>>>(
      static_cast<const T*>(x), static_cast<const float*>(sums), gamma, beta,
      static_cast<T*>(y), b, n, c, groups, rows_per_chunk, inv_count, eps);
  return static_cast<int>(cudaGetLastError());
}

// x [B, N, C] bf16 (the _f32 entry: fp32); sums [2, B, C] floats (sum, then
// sum of squares); `blocks` blocks (1-16) of a cluster a batch row
// (ops/groupnorm.py:stats_plan). Needs C % VEC == 0 (VEC = 8 bf16, 4
// fp32). Returns cudaGetLastError() of the launch (0 = launched), -1 for a
// shape this file does not take.
extern "C" int dsml_gn_channel_stats(const void* x, void* sums, int b, int n,
                                     int c, int blocks, void* stream) {
  return channel_stats<bf16>(x, sums, b, n, c, blocks, stream);
}

extern "C" int dsml_gn_channel_stats_f32(const void* x, void* sums, int b,
                                         int n, int c, int blocks,
                                         void* stream) {
  return channel_stats<float>(x, sums, b, n, c, blocks, stream);
}

// x, y [B, N, C] bf16 (the _f32 entry: fp32); gamma, beta [C], bf16 if
// params_bf16 else fp32. cluster > 0 (ops/groupnorm.py:gn_plan): the
// cluster design, `cluster` blocks (at most 8) a batch row, partial and sums
// unused; cluster = 0: the three passes, with partial and sums as above
// (scratch). Also needs C % groups == 0.
extern "C" int dsml_group_norm_silu(const void* x, const void* gamma,
                                    const void* beta, void* partial, void* sums,
                                    void* y, int b, int n, int c, int groups,
                                    int chunks, int cluster, float eps,
                                    int silu, int params_bf16, void* stream) {
  return group_norm_silu<bf16>(x, gamma, beta, partial, sums, y, b, n, c,
                               groups, chunks, cluster, eps, silu, params_bf16,
                               stream);
}

extern "C" int dsml_group_norm_silu_f32(const void* x, const void* gamma,
                                        const void* beta, void* partial,
                                        void* sums, void* y, int b, int n,
                                        int c, int groups, int chunks,
                                        int cluster, float eps, int silu,
                                        int params_bf16, void* stream) {
  return group_norm_silu<float>(x, gamma, beta, partial, sums, y, b, n, c,
                                groups, chunks, cluster, eps, silu,
                                params_bf16, stream);
}
