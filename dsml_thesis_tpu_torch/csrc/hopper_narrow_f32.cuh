// The Hopper design of fp32 attention at head width 32 on TF32 wgmma: the
// packed forward (flash_attention_packed.cu, row 3) and the packed backward
// (flash_attention_bwd_packed.cu, row 8) of mead-128-ldm-f4.yaml's UNet,
// which computes in fp32 with 32-wide heads at N = 1024, 256 and 64, and
// the same grids on split heads, mead-128's flag routes: the split-head
// forward (flash_attention.cu, row 2) and backward (flash_attention_bwd.cu,
// row 7) and, with the streaming kernel's roundings, the streaming forward
// (flash_attention_streaming.cu, row 4: its cut of the keys,
// attend_block<.., STREAM>) and backward
// (flash_attention_streaming_bwd.cu, row 5: q times the folded scale in its
// images, its own log-sum-exp grid, lse_block).
//
// Layout: rows of `heads` heads of 32 columns at the row stride ld (heads *
// 32 on packed rows; heads = 1, ld = 32 on split heads), a head addressed by
// base pointer + h * 32, so no head-split copy exists.
//
// What shapes the design. A fp32 row of 32 is 128 bytes, one row of the
// 128-byte swizzle, so a tile of rows as it lies is a K-major wgmma operand
// for the products over the head's columns (S = q k^T, S^T = k q^T,
// dP = do v^T, dP^T = v do^T). TF32 wgmma reads K-major operands only
// (hopper_tf32.cuh), so the products whose contraction runs over keys or
// queries (O = P V, dV = P^T do, dK = dS^T q, dQ = dS k) need v, do, q and k
// transposed, their rows permuted inside each 8 so that P and dS go from
// their accumulators to the A operand in registers as they are
// (hopper_tf32.cuh). And wgmma truncates what is not rounded to TF32, so
// every operand is rounded (tf32_rna) once where it is stored.
// Both the rounding and the transposes come from one images launch that
// writes each operand once, rounded, as the swizzled tile images the rings
// copy into shared memory as they are (a row image [BH][np][32]; a
// transposed image [BH][np / 32] panels of 32 columns x 32 rows, the rows
// of a panel permuted inside each 8), np the length padded to PAD rows with
// zeros. Rounding the streamed tiles in shared memory instead costs a read
// and a write of every byte the tensor cores then read, the pattern that
// paced the D = 512 backward's scores grid by shared memory
// (hopper_wide_f32_bwd.cuh); the images cost one pass over the operands in
// device memory.
//
// Launches, in stream order:
//   images   (images) the row and transposed images each grid reads,
//            each operand times its job's multiplier in fp32 before the
//            rounding (1 but for row 5's q), and in the backward delta =
//            rowsum(do o) (one launch);
//   lse      row 5 only (lse_block): block (batch x head, 64 WGS queries),
//            its q rows (the image of q times scale * log2(e)) as the A
//            operand from shared memory, the K row images through the
//            forward's ring of 64-key tiles; S = q K^T on wgmma, then the
//            streaming kernel's online maximum and fp32 sum of the
//            probabilities (keys past nk at -1e30 with probability 0, the
//            maximum starting there): lse = m + log2(max(l, 1e-30)), base 2,
//            from exactly the bits the gradient grids form their scores of;
//   forward  block (batch x head, q-tile of 64 WGS query rows): q rounded
//            once into a shared-memory tile, the head's K and V^T tile
//            images in KT-key tiles through a ring of FWD_STAGES cp.async
//            stages on mbarriers that the block's warpgroups share; three
//            blocks an SM; S = q K^T and
//            O += P V on wgmma, the online softmax in the base-2 domain in
//            fp32 with exp2 on the special-function unit alone, P kept in
//            its accumulator's registers as the A operand of P V. The row
//            log-sum-exp is m + log2(l) of s * scale * log2(e), which the
//            backward reads. Streaming (row 4): q times q_scale (scale *
//            log2(e) in fp32) before its rounding, so the scores are base-2
//            as formed; keys past the split's end at the finite -1e30 with
//            probability 0 and the maximum starting there; the denominator
//            the sum of the fp32 probabilities P V uses (the streaming
//            kernel's cast to v's type is the identity in fp32); the keys
//            [blockIdx.y keys_per_split, min(nk, ..)) of the one images
//            launch; with one split o / max(l, 1e-30), with more the
//            unnormalised output, maximum and sum for the combine launch;
//   dk / dv  block (batch x head, 64 WGS keys): its k and v rows as the A
//            operands from shared memory, q, do, q^T, do^T and the rows'
//            lse and delta through a ring of DKDV_STAGES stages; S^T = k q^T
//            and dP^T = v do^T, P^T = exp2(S^T scale_log2 - lse),
//            dS^T = P^T (dP^T - delta), then dV += P^T do and dK += dS^T q
//            from registers; dk and dv written once;
//   dq       block (batch x head, 64 WGS queries): its q and do rows as the
//            A operands, k, v and k^T through a ring of DQ_STAGES stages;
//            S = q k^T, dP = do v^T, dS, then dQ += dS k; dq written once.
// The scores and dP are formed in both backward grids (14 N^2 D operations
// a head against the function's 10): keeping P and dS of a call in scratch
// instead would write and read three [N, N] fp32 arrays, several times the
// bytes the call moves at mead-128's shapes. No atomics, every sum in a
// fixed order: equal inputs give equal bits. No branch sits between a
// wgmma and its wait; loads past an image are issued with zero size.
//
// Bound on the H100: operations on the TF32 tensor cores (4 N^2 D a head
// forward, 10 N^2 D backward, against 16 N D and 32 N D bytes); at D = 32
// each score also costs an exp2 on the special-function unit (16 a cycle an
// SM), once in the forward and once in each backward grid (row 5's
// log-sum-exp grid a third time: 2 N^2 D products, N^2 exp2).
//
// Arithmetic, as the plain versions' (ops/attention.py packed_reference,
// packed_bwd_reference) in fp32 with TF32 products: scores in fp32 times
// scale * log2(e), the row maximum and the sums of the fp32 probabilities
// in fp32, P rounded to TF32 for P V, dS = P (dP - delta) in fp32 rounded
// for its products, dk times scale and dq times scale once at the end.
#pragma once

#include "hopper_tf32.cuh"
#include "hopper_tiles.cuh"

namespace {
namespace hnarrow_f32 {

using namespace hopper;

constexpr int D = 32;               // the head width: one 128-byte row
constexpr int ROWB = 128;           // bytes of a tile row
constexpr int PAD = 64;             // rows an image's length is padded to
constexpr int WG_ROWS = 64;         // rows of a warpgroup's tile
constexpr int PANEL = 32 * ROWB;    // a transposed panel: 32 x 32 fp32
constexpr int IMG_ROWS = 32;        // rows of an images block
constexpr int IMG_NT = 256;         // its threads: one 16-byte chunk each
constexpr int FWD_STAGES = 3;       // forward: K / V^T tiles of the ring
constexpr int DKDV_STAGES = 2;      // dk/dv: q, do, q^T, do^T, lse, delta
constexpr int DQ_STAGES = 3;        // dq: k, v, k^T
constexpr int STR = 64;             // rows of a streamed backward tile
constexpr int STR_TILE = STR * ROWB;
constexpr int DKDV_STAGE = 4 * STR_TILE + 1024;   // + lse, delta (512 B)
constexpr int DQ_STAGE = 3 * STR_TILE;
// The plan: one warpgroup a block where the owned length is one tile, two
// (sharing the ring) otherwise; the forward's key tile FWD_KEYS (128 keys
// spilled at two blocks an SM and lost to 64 at every timed shape:
// tools/variants.py --f32-packed, PERF.md). Where both lengths are at most
// MMA_SYNC_MAX (mead-128's N = 64 level) the entries keep
// attention_f32_narrow.cuh's mma.sync grids, which need no images launch
// and were faster there by the same A/B.
constexpr int FWD_KEYS = 64;
constexpr int MMA_SYNC_MAX = 64;
// Warpgroups an SM the forward asks for (__launch_bounds__): six, three
// blocks of two at 85 registers a thread, which q as a shared-memory
// operand leaves room for (q in registers: 118 registers, two blocks; 6-8%
// slower by the same A/B). A block of one warpgroup asks for no more blocks
// than its shared memory lets in, three (six capped it at 80 registers,
// which spilled).
constexpr int FWD_WG_PER_SM = 6;
constexpr int SM_SHARED = 233472;   // bytes an SM, 1 KB of it a block's

__host__ __device__ constexpr int pad_rows(int n) {
  return (n + PAD - 1) / PAD * PAD;
}
__host__ __device__ constexpr int wgs_for(int n) { return n > WG_ROWS ? 2 : 1; }
__host__ __device__ constexpr bool keeps_mma_sync(int nq, int nk) {
  return nq <= MMA_SYNC_MAX && nk <= MMA_SYNC_MAX;
}
__host__ __device__ constexpr int fwd_smem(int kt, int wgs) {
  return 1024 + FWD_STAGES * 2 * kt * ROWB + wgs * WG_ROWS * ROWB +
         2 * FWD_STAGES * 8;
}
__host__ __device__ constexpr int fwd_min_blocks(int wgs) {
  const int by_smem = SM_SHARED / (fwd_smem(FWD_KEYS, wgs) + 1024);
  return FWD_WG_PER_SM / wgs < by_smem ? FWD_WG_PER_SM / wgs : by_smem;
}
// the log-sum-exp grid: the forward's ring of K tiles (no V^T), the owned q
// rows, the ring's barriers and the q copy's; as many warpgroups an SM as
// the forward (no P V: fewer registers still; eight were no faster by the
// A/B of tools/variants.py --f32-split-bwd, PERF.md)
__host__ __device__ constexpr int lse_smem(int wgs) {
  return 1024 + FWD_STAGES * FWD_KEYS * ROWB + wgs * WG_ROWS * ROWB +
         (2 * FWD_STAGES + 1) * 8;
}
__host__ __device__ constexpr int lse_min_blocks(int wgs) {
  const int by_smem = SM_SHARED / (lse_smem(wgs) + 1024);
  return FWD_WG_PER_SM / wgs < by_smem ? FWD_WG_PER_SM / wgs : by_smem;
}
__host__ __device__ constexpr int dkdv_smem(int wgs) {
  return 1024 + 2 * wgs * WG_ROWS * ROWB + DKDV_STAGES * DKDV_STAGE +
         (2 * DKDV_STAGES + 1) * 8;
}
__host__ __device__ constexpr int dq_smem(int wgs) {
  return 1024 + 2 * wgs * WG_ROWS * ROWB + DQ_STAGES * DQ_STAGE +
         (2 * DQ_STAGES + 1) * 8;
}
// fp32 scratch of a call: the forward's K and V^T images; the backward's q,
// q^T, do, do^T images at the padded Nq and k, k^T, v at the padded Nk
inline int64_t fwd_scratch_floats(int64_t bh, int nk) {
  return 2 * bh * pad_rows(nk) * D;
}
inline int64_t bwd_scratch_floats(int64_t bh, int nq, int nk) {
  return bh * D * (4 * static_cast<int64_t>(pad_rows(nq)) + 3 * pad_rows(nk));
}

// ------------------------------------------------------------- images ---
// One operand of the images launch: rows [B][n][heads * 32] at src (row
// stride ld) -> its row image and / or transposed image (null: not
// written), each [BH][np * 32] fp32 of tf32(src * mul) (the product in
// fp32; mul = 1 is exact); with o, also delta[bh * n + i] =
// sum_c src[i, c] o[i, c] (src = do).
struct ImageJob {
  const float* src;
  float* rows;
  float* cols;
  const float* o;
  float* delta;
  int n, np;
  float mul;
};
struct ImageJobs {
  ImageJob job[4];
};

// block (IMG_ROWS rows, batch x head, job): each thread loads one 16-byte
// chunk of a row, rounds it and stores it at its swizzled place in the row
// image; the transposed image goes through a shared-memory tile, a thread
// writing 16 bytes of a panel row: the positions 4c .. 4c + 3 of 32 hold
// the rows 8 (c / 2) + 2 e + (c & 1), e = 0 .. 3 (perm8 of hopper_tf32.cuh).
__device__ __forceinline__ void images(const ImageJobs& jobs, int64_t ld,
                                       int heads) {
  __shared__ float tile[IMG_ROWS][IMG_ROWS + 1];
  const ImageJob& job = jobs.job[blockIdx.z];
  const int n0 = blockIdx.x * IMG_ROWS;
  if (n0 >= job.np) return;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / heads;
  const int h = static_cast<int>(bh % heads);
  const int t = threadIdx.x, r = t >> 3, c = t & 7;
  const int n = n0 + r;
  const bool ok = n < job.n;
  const int64_t at = (b * job.n + (ok ? n : 0)) * ld + h * D + 4 * c;
  const float4 x = ok ? *reinterpret_cast<const float4*>(job.src + at)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  const float mul = job.mul;
  const uint4 u = make_uint4(tf32_rna(x.x * mul), tf32_rna(x.y * mul),
                             tf32_rna(x.z * mul), tf32_rna(x.w * mul));
  const int64_t img = bh * job.np * D;
  if (job.rows != nullptr)
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(
        job.rows + img) + Swz<128>::at(n, c)) = u;
  if (job.o != nullptr) {   // delta: this row's 32 products in a fixed order
    const float4 y = ok ? *reinterpret_cast<const float4*>(job.o + at)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    float s = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (c == 0 && ok) job.delta[bh * job.n + n] = s;
  }
  if (job.cols == nullptr) return;
  tile[r][4 * c] = __uint_as_float(u.x);
  tile[r][4 * c + 1] = __uint_as_float(u.y);
  tile[r][4 * c + 2] = __uint_as_float(u.z);
  tile[r][4 * c + 3] = __uint_as_float(u.w);
  __syncthreads();
  // thread (column d = t / 8 of the head, chunk c of its panel row)
  const int d = t >> 3, row0 = 8 * (c >> 1) + (c & 1);
  const uint4 v = make_uint4(
      __float_as_uint(tile[row0][d]), __float_as_uint(tile[row0 + 2][d]),
      __float_as_uint(tile[row0 + 4][d]), __float_as_uint(tile[row0 + 6][d]));
  *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(
      job.cols + img + (n0 / IMG_ROWS) * (PANEL / 4)) + Swz<128>::at(d, c)) = v;
}

inline int launch_images(void (*kernel)(ImageJobs, int64_t, int),
                         const ImageJobs& jobs, int njobs, int np, int64_t bh,
                         int64_t ld, int heads, cudaStream_t stream) {
  kernel<<<dim3(np / IMG_ROWS, static_cast<unsigned>(bh), njobs), IMG_NT, 0,
           stream>>>(jobs, ld, heads);
  return static_cast<int>(cudaGetLastError());
}

// Copies CHUNKS 16-byte chunks of an image from src into the shared memory
// at dst, the NT threads of the block in a loop of fixed trip count; chunk
// i lies in image row i / 8, and rows at or past `valid` are zeros (nothing
// read).
template <int CHUNKS, int NT>
__device__ __forceinline__ void copy_image(uint32_t dst, const float* src,
                                           int valid, int t) {
  static_assert(CHUNKS % NT == 0, "chunks a thread");
#pragma unroll
  for (int x = 0; x < CHUNKS / NT; ++x) {
    const int i = t + x * NT;
    const bool ok = (i >> 3) < valid;
    cp_async16(dst + 16 * i, src + (ok ? 4 * i : 0), ok);
  }
}

// The TF32 A operand of k8 step j from an accumulator whose columns become
// the reduction of the next product (columns 8 j + 2 t and + 1 are the
// fragment's depth t and t + 4; hopper_tf32.cuh).
template <int N>
__device__ __forceinline__ void acc_to_tf32(uint32_t (&a)[N / 8][4],
                                            const float (&d)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[j][0] = tf32_rna(d[4 * j]);
    a[j][1] = tf32_rna(d[4 * j + 2]);
    a[j][2] = tf32_rna(d[4 * j + 1]);
    a[j][3] = tf32_rna(d[4 * j + 3]);
  }
}

// The B operand of k8 step kt of a transposed image tile at sb: panel
// kt / 4, 32 bytes a step inside it.
__device__ __forceinline__ uint64_t panel_step(uint32_t sb, int kt) {
  return desc_k<128>(sb + (kt / 4) * PANEL + 32 * (kt % 4));
}

// acc[64 x 32] += A[64 x N] B, A in registers (acc_to_tf32), B the
// transposed image tile of N rows at sb (N / 32 panels).
template <int N>
__device__ __forceinline__ void frag_times_panels(float (&acc)[16],
                                                  const uint32_t (&a)[N / 8][4],
                                                  uint32_t sb) {
#pragma unroll
  for (int kt = 0; kt < N / 8; ++kt)
    wgmma_tf32_rs<32>(acc, a[kt], panel_step(sb, kt), 1);
}

// The same for two products, their steps in turns (two accumulation
// chains, not one twice as long): acc0 += a0 B0 and acc1 += a1 B1.
template <int N>
__device__ __forceinline__ void frags_times_panels2(
    float (&acc0)[16], const uint32_t (&a0)[N / 8][4], uint32_t sb0,
    float (&acc1)[16], const uint32_t (&a1)[N / 8][4], uint32_t sb1) {
#pragma unroll
  for (int kt = 0; kt < N / 8; ++kt) {
    wgmma_tf32_rs<32>(acc0, a0[kt], panel_step(sb0, kt), 1);
    wgmma_tf32_rs<32>(acc1, a1[kt], panel_step(sb1, kt), 1);
  }
}

// acc0 += the even steps of A B, acc1 += the odd ones (A, B as in
// frag_times_panels): two accumulation chains, summed by the caller.
template <int N>
__device__ __forceinline__ void frag_times_panels_split(
    float (&acc0)[16], float (&acc1)[16], const uint32_t (&a)[N / 8][4],
    uint32_t sb) {
#pragma unroll
  for (int kt = 0; kt < N / 8; kt += 2) {
    wgmma_tf32_rs<32>(acc0, a[kt], panel_step(sb, kt), 1);
    wgmma_tf32_rs<32>(acc1, a[kt + 1], panel_step(sb, kt + 1), 1);
  }
}

// acc[64 x N] = A B^T over the head's 32 columns, A the 64 rows at sa and B
// the N rows at sb, both row image tiles in shared memory.
template <int N>
__device__ __forceinline__ void rows_times_rows(float (&acc)[N / 2],
                                                uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss<N>(acc, desc_k<128>(sa + 32 * kk), desc_k<128>(sb + 32 * kk),
                     kk > 0);
}

// Stores a warpgroup's [64 x 32] accumulator times mul to rows below valid
// (rows counted from the warpgroup's first, at g) of row stride ld.
__device__ __forceinline__ void store_rows(float* g, int64_t ld, int valid,
                                           const float (&acc)[16], float mul0,
                                           float mul1) {
  const int wt = threadIdx.x & 127;
  const int r0 = (wt >> 5) * 16 + ((wt & 31) >> 2);
  const int c = 2 * (wt & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 < valid)
      *reinterpret_cast<float2*>(g + r0 * ld + 8 * j + c) =
          make_float2(acc[4 * j] * mul0, acc[4 * j + 1] * mul0);
    if (r0 + 8 < valid)
      *reinterpret_cast<float2*>(g + (r0 + 8) * ld + 8 * j + c) =
          make_float2(acc[4 * j + 2] * mul1, acc[4 * j + 3] * mul1);
  }
}

// ------------------------------------------------------------ forward ---
struct FwdArgs {
  const float* q;       // [B, nq, ld] (head h at + h * 32)
  const float* kimg;    // the K row images [BH][npk * 32]
  const float* vimg;    // the V transposed images [BH][npk * 32]
  float* o;             // [B, nq, ld]
  float* lse;           // [BH, nq] or null (resident)
  float* part_o;        // streaming with splits: [splits, BH * nq, 32]
  float* part_ml;       //   and [splits, 2, BH * nq] (maximum, sum)
  int64_t ld;
  int nq, nk, npk, heads, q_tiles;
  int keys_per_split;   // streaming: keys of a split (a multiple of 64)
  float scale_log2;     // resident: the scores' factor, scale * log2(e)
  float q_scale;        // streaming: q's factor, scale * log2(e) in fp32
};

// Block (batch x head, q-tile): WGS warpgroups of 64 query rows attend all
// nk keys of the head in KT-key tiles (see the file's note); STREAM: the
// keys of split blockIdx.y, with the streaming kernel's roundings.
template <int WGS, int KT, bool STREAM = false>
__device__ __forceinline__ void attend_block(const FwdArgs& a) {
  constexpr int NT = WGS * 128;
  constexpr int TILE = KT * ROWB;        // bytes of a K (or V^T) tile
  constexpr int STAGE = 2 * TILE;
  constexpr int S = FWD_STAGES;
  constexpr int QTILE = WGS * WG_ROWS * ROWB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t ring = cvta(base);
  const uint32_t sq = ring + S * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * STAGE + QTILE);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int64_t bh = blockIdx.x / a.q_tiles;
  const int q0 = (blockIdx.x % a.q_tiles) * WGS * WG_ROWS;
  const int64_t b = bh / a.heads;
  const int h = static_cast<int>(bh % a.heads);
  const float* kh = a.kimg + bh * a.npk * D;
  const float* vh = a.vimg + bh * a.npk * D;
  const int kv_begin = STREAM ? blockIdx.y * a.keys_per_split : 0;
  const int kv_end = STREAM ? min(a.nk, kv_begin + a.keys_per_split) : a.nk;
  const int ntiles = (kv_end - kv_begin + KT - 1) / KT;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NT);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  auto issue = [&](int i) {  // the keys of tile i into stage i % S
    const int s = i % S;
    if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
    const int key0 = kv_begin + i * KT;
    // an image row is a key of K, or 128 bytes of a 32-key V^T panel: both
    // end at the padded length, a multiple of 64 keys (keys of the next
    // split are copied too, and masked)
    const uint32_t st = ring + s * STAGE;
    copy_image<KT * 8, NT>(st, kh + key0 * D, a.npk - key0, tid);
    copy_image<KT * 8, NT>(st + TILE, vh + key0 * D, a.npk - key0, tid);
    cp_async_arrive(&full[s]);
  };
  for (int i = 0; i < S - 1 && i < ntiles; ++i) issue(i);

  // the q-tile as a swizzled tile, the A operand of S: each thread rounds
  // the chunks it copied once they have landed (rows past nq zeros, not
  // written back), streaming times q_scale in fp32 first
  auto round_q = [&](uint32_t x) {
    return tf32_rna(STREAM ? __uint_as_float(x) * a.q_scale
                           : __uint_as_float(x));
  };
  const int rw = wg * WG_ROWS + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int t4 = lane & 3;
  {
    const float* qrow = a.q + (b * a.nq + q0) * a.ld + h * D;
#pragma unroll
    for (int x = 0; x < QTILE / 16 / NT; ++x) {
      const int i = tid + x * NT, r = i >> 3, c = i & 7;
      const bool ok = q0 + r < a.nq;
      cp_async16(sq + Swz<128>::at(r, c), qrow + (ok ? r * a.ld + 4 * c : 0),
                 ok);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < QTILE / 16 / NT; ++x) {
      const int i = tid + x * NT;
      uint4* p = reinterpret_cast<uint4*>(base + S * STAGE +
                                          Swz<128>::at(i >> 3, i & 7));
      const uint4 v = *p;
      *p = make_uint4(round_q(v.x), round_q(v.y), round_q(v.z), round_q(v.w));
    }
    fence_async_shared();
    __syncthreads();   // the rounded q-tile visible to both warpgroups
  }

  float o[16];
#pragma unroll
  for (int x = 0; x < 16; ++x) o[x] = 0.f;
  const float m_start = STREAM ? -1e30f : -INFINITY;
  float m0 = m_start, m1 = m_start, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    if (i + S - 1 < ntiles) issue(i + S - 1);   // into the stage of i - 1
    fence_async_shared();
    const uint32_t sk = ring + s * STAGE, sv = sk + TILE;

    float sc[KT / 2];   // S = q K^T
    wgmma_fence();
    rows_times_rows<KT>(sc, sq + wg * WG_ROWS * ROWB, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    float alpha0, alpha1;
    softmax_scores<KT, STREAM>(sc, m0, m1, alpha0, alpha1, kv_begin + i * KT,
                               kv_end, STREAM ? 1.f : a.scale_log2, lane);
    l0 *= alpha0;
    l1 *= alpha1;
    add_row_sums<KT>(sc, l0, l1);
    scale_rows<D>(o, alpha0, alpha1);
    uint32_t pa[KT / 8][4];   // P, rounded: the A operand of P V
    acc_to_tf32<KT>(pa, sc);

    wgmma_fence();
    frag_times_panels<KT>(o, pa, sv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[s]);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int valid = a.nq - q0 - wg * WG_ROWS;
  const int r = rw - wg * WG_ROWS;
  if constexpr (STREAM) {
    const int64_t row0 = bh * a.nq + q0 + wg * WG_ROWS;   // split heads
    if (gridDim.y == 1) {
      store_rows(a.o + row0 * D, D, valid, o, 1.f / fmaxf(l0, 1e-30f),
                 1.f / fmaxf(l1, 1e-30f));
      return;
    }
    const int64_t rows = static_cast<int64_t>(gridDim.x / a.q_tiles) * a.nq;
    float* ml = a.part_ml + blockIdx.y * 2 * rows + row0;
    if (t4 == 0) {
      if (r < valid) {
        ml[r] = m0;
        ml[rows + r] = l0;
      }
      if (r + 8 < valid) {
        ml[r + 8] = m1;
        ml[rows + r + 8] = l1;
      }
    }
    store_rows(a.part_o + (blockIdx.y * rows + row0) * D, D, valid, o, 1.f,
               1.f);
    return;
  }
  if (a.lse != nullptr && t4 == 0) {
    float* row = a.lse + bh * a.nq + q0 + rw;
    if (r < valid) row[0] = m0 * a.scale_log2 + log2f(l0);
    if (r + 8 < valid) row[8] = m1 * a.scale_log2 + log2f(l1);
  }
  store_rows(a.o + (b * a.nq + q0 + wg * WG_ROWS) * a.ld + h * D, a.ld, valid,
             o, 1.f / l0, 1.f / l1);
}

// The forward's kernels by plan: the caller's .cu defines a __global__
// around attend_block<WGS, KT[, STREAM]> for each (Kernels::fwd<WGS, KT>()),
// so that a profile names its row. scratch holds fwd_scratch_floats(b *
// heads, nk) fp32. STREAM (split heads: heads = 1, ld = 32): scale is q_scale,
// lse unused, and the grid's y the `splits` ranges of keys_per_split keys;
// with splits > 1 the blocks write part_o / part_ml and the caller
// combines them. Returns cudaGetLastError() of the first launch that failed
// (0 = both launched), or -1 for an empty shape or no scratch.
template <typename Kernels, bool STREAM = false>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, float* scratch, int b, int nq, int nk, int heads,
               int64_t ld, float scale, cudaStream_t stream,
               float* part_o = nullptr, float* part_ml = nullptr,
               int splits = 1, int keys_per_split = 0) {
  if (b < 1 || nq < 1 || nk < 1 || heads < 1 || splits < 1 ||
      scratch == nullptr)
    return -1;
  const int64_t bh = static_cast<int64_t>(b) * heads;
  const int npk = pad_rows(nk);
  float* kimg = scratch;
  float* vimg = scratch + bh * npk * D;
  ImageJobs jobs{};
  jobs.job[0] = {k, kimg, nullptr, nullptr, nullptr, nk, npk, 1.f};
  jobs.job[1] = {v, nullptr, vimg, nullptr, nullptr, nk, npk, 1.f};
  int err = launch_images(Kernels::images(), jobs, 2, npk, bh, ld, heads,
                          stream);
  if (err != 0) return err;
  const int wgs = wgs_for(nq);
  const int q_tiles = (nq + wgs * WG_ROWS - 1) / (wgs * WG_ROWS);
  const FwdArgs args{q, kimg, vimg, o, lse, part_o, part_ml, ld, nq, nk,
                     npk, heads, q_tiles, STREAM ? keys_per_split : nk,
                     STREAM ? 1.f : scale * 1.4426950408889634f,
                     STREAM ? scale : 1.f};
  auto go = [&](auto kernel) {
    const int smem = fwd_smem(FWD_KEYS, wgs);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<dim3(static_cast<unsigned>(bh * q_tiles), splits), wgs * 128,
             smem, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  };
  return wgs == 2 ? go(Kernels::template fwd<2, FWD_KEYS>())
                  : go(Kernels::template fwd<1, FWD_KEYS>());
}

// ----------------------------------------------------------- backward ---
struct BwdArgs {
  const float* qr;      // images: q, q^T, do, do^T [BH][npq * 32]
  const float* qt;
  const float* dor;
  const float* dot;
  const float* kr;      // k, k^T, v [BH][npk * 32]
  const float* kt;
  const float* vr;
  const float* lse;     // [BH, nq]
  const float* delta;   // [BH, nq]
  float* dq;            // [B, nq, ld]
  float* dk;            // [B, nk, ld]
  float* dv;
  int64_t ld;
  int nq, nk, npq, npk, heads, tiles;
  float scale_log2, dk_mul, dq_mul;
};

// Block (batch x head, 64 WGS keys): dk and dv of its keys over all nq
// queries (see the file's note).
template <int WGS>
__device__ __forceinline__ void dkdv_block(const BwdArgs& a) {
  constexpr int NT = WGS * 128;
  constexpr int OWN = WGS * WG_ROWS * ROWB;   // bytes of the owned k (or v)
  constexpr int S = DKDV_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sk = cvta(base), sv = sk + OWN, ring = sv + OWN;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + 2 * OWN + S * DKDV_STAGE);
  uint64_t* empty = full + S;
  uint64_t* own = empty + S;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int64_t bh = blockIdx.x / a.tiles;
  const int kv0 = (blockIdx.x % a.tiles) * WGS * WG_ROWS;
  const int64_t b = bh / a.heads;
  const int h = static_cast<int>(bh % a.heads);
  const int64_t qimg = bh * a.npq * D, kimg = bh * a.npk * D;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NT);
    }
    mbar_init(own, NT);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  copy_image<OWN / 16, NT>(sk, a.kr + kimg + kv0 * D, a.npk - kv0, tid);
  copy_image<OWN / 16, NT>(sv, a.vr + kimg + kv0 * D, a.npk - kv0, tid);
  cp_async_arrive(own);

  const int q_tiles = a.npq / STR;
  const float* lse = a.lse + bh * a.nq;
  const float* delta = a.delta + bh * a.nq;
  auto issue = [&](int j) {  // query tile j into stage j % S
    const int s = j % S;
    if (j >= S) mbar_wait(&empty[s], ((j / S) - 1) & 1);
    const uint32_t st = ring + s * DKDV_STAGE;
    const int64_t off = qimg + static_cast<int64_t>(j) * STR * D;
    copy_image<STR_TILE / 16, NT>(st, a.qr + off, STR, tid);
    copy_image<STR_TILE / 16, NT>(st + STR_TILE, a.dor + off, STR, tid);
    copy_image<STR_TILE / 16, NT>(st + 2 * STR_TILE, a.qt + off, STR, tid);
    copy_image<STR_TILE / 16, NT>(st + 3 * STR_TILE, a.dot + off, STR, tid);
    if (tid < 2 * STR) {  // lse then delta of the tile's queries
      const int i = tid % STR, q = j * STR + i;
      const bool ok = q < a.nq;
      cp_async4(st + 4 * STR_TILE + 4 * tid,
                (tid < STR ? lse : delta) + (ok ? q : 0), ok);
    }
    cp_async_arrive(&full[s]);
  };
  for (int j = 0; j < S - 1 && j < q_tiles; ++j) issue(j);

  float dka[16], dva[16];
#pragma unroll
  for (int x = 0; x < 16; ++x) dka[x] = dva[x] = 0.f;
  const uint32_t myk = sk + wg * WG_ROWS * ROWB, myv = sv + wg * WG_ROWS * ROWB;
  const int t4 = lane & 3;
  mbar_wait(own, 0);

  for (int j = 0; j < q_tiles; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    if (j + S - 1 < q_tiles) issue(j + S - 1);   // into the stage of j - 1
    fence_async_shared();
    const uint32_t sq = ring + s * DKDV_STAGE, sdo = sq + STR_TILE;
    const uint32_t sqt = sq + 2 * STR_TILE, sdot = sq + 3 * STR_TILE;
    const float* slse = reinterpret_cast<const float*>(
        base + 2 * OWN + s * DKDV_STAGE + 4 * STR_TILE);
    const float* sdl = slse + STR;

    float st[STR / 2], dpt[STR / 2];   // S^T = k q^T, dP^T = v do^T
    wgmma_fence();
    rows_times_rows<STR>(st, myk, sq);
    wgmma_commit();
    rows_times_rows<STR>(dpt, myv, sdo);
    wgmma_commit();
    wgmma_wait<1>();   // S^T: the exponentials run under dP^T's product
    fence_regs(st);

    // P^T = exp2(S^T scale_log2 - lse[q]), then dS^T = P^T (dP^T -
    // delta[q]); a column is a query: those past nq give 0
    const int q1 = j * STR;
#pragma unroll
    for (int jj = 0; jj < STR / 8; ++jj) {
      const int c0 = 8 * jj + 2 * t4;
      const bool ok0 = q1 + c0 < a.nq, ok1 = q1 + c0 + 1 < a.nq;
      const float l0 = slse[c0], l1 = slse[c0 + 1];
      st[4 * jj] = ok0 ? exp2_fast(st[4 * jj] * a.scale_log2 - l0) : 0.f;
      st[4 * jj + 1] = ok1 ? exp2_fast(st[4 * jj + 1] * a.scale_log2 - l1)
                           : 0.f;
      st[4 * jj + 2] = ok0 ? exp2_fast(st[4 * jj + 2] * a.scale_log2 - l0)
                           : 0.f;
      st[4 * jj + 3] = ok1 ? exp2_fast(st[4 * jj + 3] * a.scale_log2 - l1)
                           : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int jj = 0; jj < STR / 8; ++jj) {
      const int c0 = 8 * jj + 2 * t4;
      const float d0 = sdl[c0], d1 = sdl[c0 + 1];
      dpt[4 * jj] = st[4 * jj] * (dpt[4 * jj] - d0);
      dpt[4 * jj + 1] = st[4 * jj + 1] * (dpt[4 * jj + 1] - d1);
      dpt[4 * jj + 2] = st[4 * jj + 2] * (dpt[4 * jj + 2] - d0);
      dpt[4 * jj + 3] = st[4 * jj + 3] * (dpt[4 * jj + 3] - d1);
    }
    uint32_t pa[STR / 8][4], da[STR / 8][4];
    acc_to_tf32<STR>(pa, st);
    acc_to_tf32<STR>(da, dpt);

    // dV += P^T do, dK += dS^T q: the queries are the reduction
    wgmma_fence();
    frags_times_panels2<STR>(dva, pa, sdot, dka, da, sqt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(&empty[s]);
  }

  const int row0 = kv0 + wg * WG_ROWS;
  const int64_t out = (b * a.nk + row0) * a.ld + h * D;
  store_rows(a.dk + out, a.ld, a.nk - row0, dka, a.dk_mul, a.dk_mul);
  store_rows(a.dv + out, a.ld, a.nk - row0, dva, 1.f, 1.f);
}

// Block (batch x head, 64 WGS queries): dq of its queries over all nk keys
// (see the file's note).
template <int WGS>
__device__ __forceinline__ void dq_block(const BwdArgs& a) {
  constexpr int NT = WGS * 128;
  constexpr int OWN = WGS * WG_ROWS * ROWB;   // bytes of the owned q (or do)
  constexpr int S = DQ_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sq = cvta(base), sdo = sq + OWN, ring = sdo + OWN;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + 2 * OWN + S * DQ_STAGE);
  uint64_t* empty = full + S;
  uint64_t* own = empty + S;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int64_t bh = blockIdx.x / a.tiles;
  const int q0 = (blockIdx.x % a.tiles) * WGS * WG_ROWS;
  const int64_t b = bh / a.heads;
  const int h = static_cast<int>(bh % a.heads);
  const int64_t qimg = bh * a.npq * D, kimg = bh * a.npk * D;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NT);
    }
    mbar_init(own, NT);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  copy_image<OWN / 16, NT>(sq, a.qr + qimg + q0 * D, a.npq - q0, tid);
  copy_image<OWN / 16, NT>(sdo, a.dor + qimg + q0 * D, a.npq - q0, tid);
  cp_async_arrive(own);

  const int kv_tiles = a.npk / STR;
  auto issue = [&](int j) {  // key tile j into stage j % S
    const int s = j % S;
    if (j >= S) mbar_wait(&empty[s], ((j / S) - 1) & 1);
    const uint32_t st = ring + s * DQ_STAGE;
    const int64_t off = kimg + static_cast<int64_t>(j) * STR * D;
    copy_image<STR_TILE / 16, NT>(st, a.kr + off, STR, tid);
    copy_image<STR_TILE / 16, NT>(st + STR_TILE, a.vr + off, STR, tid);
    copy_image<STR_TILE / 16, NT>(st + 2 * STR_TILE, a.kt + off, STR, tid);
    cp_async_arrive(&full[s]);
  };
  for (int j = 0; j < S - 1 && j < kv_tiles; ++j) issue(j);

  // the thread's two query rows and their statistics
  const int wt = tid & 127, t4 = lane & 3;
  const int r0 = q0 + wg * WG_ROWS + (wt >> 5) * 16 + (lane >> 2), r1 = r0 + 8;
  const float* lse = a.lse + bh * a.nq;
  const float* delta = a.delta + bh * a.nq;
  const float lse0 = r0 < a.nq ? lse[r0] : 0.f;
  const float lse1 = r1 < a.nq ? lse[r1] : 0.f;
  const float dl0 = r0 < a.nq ? delta[r0] : 0.f;
  const float dl1 = r1 < a.nq ? delta[r1] : 0.f;
  float dqa[16], dqb[16];   // the even and the odd steps of dQ += dS k
#pragma unroll
  for (int x = 0; x < 16; ++x) dqa[x] = dqb[x] = 0.f;
  const uint32_t myq = sq + wg * WG_ROWS * ROWB;
  const uint32_t mydo = sdo + wg * WG_ROWS * ROWB;
  mbar_wait(own, 0);

  for (int j = 0; j < kv_tiles; ++j) {
    const int s = j % S;
    mbar_wait(&full[s], (j / S) & 1);
    if (j + S - 1 < kv_tiles) issue(j + S - 1);   // into the stage of j - 1
    fence_async_shared();
    const uint32_t skr = ring + s * DQ_STAGE, svr = skr + STR_TILE;
    const uint32_t skt = skr + 2 * STR_TILE;

    float sc[STR / 2], dp[STR / 2];   // S = q k^T, dP = do v^T
    wgmma_fence();
    rows_times_rows<STR>(sc, myq, skr);
    wgmma_commit();
    rows_times_rows<STR>(dp, mydo, svr);
    wgmma_commit();
    wgmma_wait<1>();   // S: the exponentials run under dP's product
    fence_regs(sc);

    // P = exp2(S scale_log2 - lse), then dS = P (dP - delta); keys past nk
    // are outside the softmax and give 0
    const int kv0 = j * STR;
#pragma unroll
    for (int jj = 0; jj < STR / 8; ++jj) {
      const int key = kv0 + 8 * jj + 2 * t4;
      const bool ok0 = key < a.nk, ok1 = key + 1 < a.nk;
      sc[4 * jj] = ok0 ? exp2_fast(sc[4 * jj] * a.scale_log2 - lse0) : 0.f;
      sc[4 * jj + 1] = ok1 ? exp2_fast(sc[4 * jj + 1] * a.scale_log2 - lse0)
                           : 0.f;
      sc[4 * jj + 2] = ok0 ? exp2_fast(sc[4 * jj + 2] * a.scale_log2 - lse1)
                           : 0.f;
      sc[4 * jj + 3] = ok1 ? exp2_fast(sc[4 * jj + 3] * a.scale_log2 - lse1)
                           : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < STR / 8; ++jj) {
      dp[4 * jj] = sc[4 * jj] * (dp[4 * jj] - dl0);
      dp[4 * jj + 1] = sc[4 * jj + 1] * (dp[4 * jj + 1] - dl0);
      dp[4 * jj + 2] = sc[4 * jj + 2] * (dp[4 * jj + 2] - dl1);
      dp[4 * jj + 3] = sc[4 * jj + 3] * (dp[4 * jj + 3] - dl1);
    }
    uint32_t da[STR / 8][4];
    acc_to_tf32<STR>(da, dp);

    // dQ += dS k: the keys are the reduction
    wgmma_fence();
    frag_times_panels_split<STR>(dqa, dqb, da, skt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(dqb);
    fence_regs(da);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int x = 0; x < 16; ++x) dqa[x] += dqb[x];
  const int row0 = q0 + wg * WG_ROWS;
  store_rows(a.dq + (b * a.nq + row0) * a.ld + h * D, a.ld, a.nq - row0, dqa,
             a.dq_mul, a.dq_mul);
}

struct LseArgs {
  const float* qr;      // the q row images [BH][npq * 32], q times its factor
  const float* kr;      // the k row images [BH][npk * 32]
  float* lse;           // [BH, nq]
  int nq, nk, npq, npk, tiles;
};

// Block (batch x head, 64 WGS queries): the row log-sum-exp of its queries
// over all nk keys of the head (see the file's note), in the base-2 domain
// of scores already times scale * log2(e); the streaming kernel's rules.
template <int WGS>
__device__ __forceinline__ void lse_block(const LseArgs& a) {
  constexpr int NT = WGS * 128;
  constexpr int KT = FWD_KEYS;
  constexpr int TILE = KT * ROWB;             // bytes of a K tile
  constexpr int OWN = WGS * WG_ROWS * ROWB;   // bytes of the owned q
  constexpr int S = FWD_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sq = cvta(base), ring = sq + OWN;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + OWN + S * TILE);
  uint64_t* empty = full + S;
  uint64_t* own = empty + S;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int64_t bh = blockIdx.x / a.tiles;
  const int q0 = (blockIdx.x % a.tiles) * WGS * WG_ROWS;
  const float* kh = a.kr + bh * a.npk * D;
  const int ntiles = (a.nk + KT - 1) / KT;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NT);
    }
    mbar_init(own, NT);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  copy_image<OWN / 16, NT>(sq, a.qr + bh * a.npq * D + q0 * D, a.npq - q0,
                           tid);
  cp_async_arrive(own);
  auto issue = [&](int i) {  // the keys of tile i into stage i % S
    const int s = i % S;
    if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
    copy_image<TILE / 16, NT>(ring + s * TILE, kh + i * KT * D,
                              a.npk - i * KT, tid);
    cp_async_arrive(&full[s]);
  };
  for (int i = 0; i < S - 1 && i < ntiles; ++i) issue(i);

  const uint32_t myq = sq + wg * WG_ROWS * ROWB;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
  mbar_wait(own, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    if (i + S - 1 < ntiles) issue(i + S - 1);   // into the stage of i - 1
    fence_async_shared();

    float sc[KT / 2];   // S = q K^T, base 2 as formed
    wgmma_fence();
    rows_times_rows<KT>(sc, myq, ring + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&empty[s]);   // the K tile is read

    float alpha0, alpha1;
    softmax_scores<KT, true>(sc, m0, m1, alpha0, alpha1, i * KT, a.nk, 1.f,
                             lane);
    l0 *= alpha0;
    l1 *= alpha1;
    add_row_sums<KT>(sc, l0, l1);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if ((lane & 3) == 0) {
    const int r = wg * WG_ROWS + ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int valid = a.nq - q0;
    float* row = a.lse + bh * a.nq + q0;
    if (r < valid) row[r] = m0 + log2f(fmaxf(l0, 1e-30f));
    if (r + 8 < valid) row[r + 8] = m1 + log2f(fmaxf(l1, 1e-30f));
  }
}

// The images launch (q times q_mul, q^T, do, do^T with delta, k, k^T, v),
// with LSE the log-sum-exp grid writing lse_out (which the grids then read
// in place of lse), then the dk/dv grid, then the dq grid on `stream`, by
// the caller's kernels (Kernels::images(), lse<WGS>() around
// lse_block<WGS>, dkdv<WGS>() around dkdv_block<WGS>, dq<WGS>() around
// dq_block<WGS>). scratch holds bwd_scratch_floats(b * heads, nq, nk) fp32.
// Returns cudaGetLastError() of the first launch that failed (0 = all
// launched), or -1 for an empty shape or no scratch.
template <typename Kernels, bool LSE = false>
int launch_bwd(const float* q, const float* k, const float* v, const float* o,
               const float* dout, const float* lse, float* delta, float* dq,
               float* dk, float* dv, float* scratch, int b, int nq, int nk,
               int heads, int64_t ld, float scale, float scale_log2,
               float dk_mul, cudaStream_t stream, float q_mul = 1.f,
               float* lse_out = nullptr) {
  if (b < 1 || nq < 1 || nk < 1 || heads < 1 || scratch == nullptr ||
      (LSE && lse_out == nullptr))
    return -1;
  const int64_t bh = static_cast<int64_t>(b) * heads;
  const int npq = pad_rows(nq), npk = pad_rows(nk);
  const int64_t qsz = bh * npq * D, ksz = bh * npk * D;
  float* qr = scratch;
  float* qt = qr + qsz;
  float* dor = qt + qsz;
  float* dot = dor + qsz;
  float* kr = dot + qsz;
  float* kt = kr + ksz;
  float* vr = kt + ksz;
  ImageJobs jobs{};
  jobs.job[0] = {q, qr, qt, nullptr, nullptr, nq, npq, q_mul};
  jobs.job[1] = {dout, dor, dot, o, delta, nq, npq, 1.f};
  jobs.job[2] = {k, kr, kt, nullptr, nullptr, nk, npk, 1.f};
  jobs.job[3] = {v, vr, nullptr, nullptr, nullptr, nk, npk, 1.f};
  int err = launch_images(Kernels::images(), jobs, 4, npq > npk ? npq : npk,
                          bh, ld, heads, stream);
  if (err != 0) return err;
  // a grid of bh x (the owned length in tiles of wgs warpgroups)
  auto grid = [&](auto kernel, int wgs, int smem, int n, auto& args) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    args.tiles = (n + wgs * WG_ROWS - 1) / (wgs * WG_ROWS);
    kernel<<<static_cast<unsigned>(bh * args.tiles), wgs * 128, smem,
             stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (LSE) {
    LseArgs la{qr, kr, lse_out, nq, nk, npq, npk, 0};
    err = wgs_for(nq) == 2
              ? grid(Kernels::template lse<2>(), 2, lse_smem(2), nq, la)
              : grid(Kernels::template lse<1>(), 1, lse_smem(1), nq, la);
    if (err != 0) return err;
    lse = lse_out;
  }
  BwdArgs args{qr, qt, dor, dot, kr, kt, vr, lse, delta, dq, dk, dv, ld,
               nq, nk, npq, npk, heads, 0, scale_log2, dk_mul, scale};
  err = wgs_for(nk) == 2
            ? grid(Kernels::template dkdv<2>(), 2, dkdv_smem(2), nk, args)
            : grid(Kernels::template dkdv<1>(), 1, dkdv_smem(1), nk, args);
  if (err != 0) return err;
  return wgs_for(nq) == 2
             ? grid(Kernels::template dq<2>(), 2, dq_smem(2), nq, args)
             : grid(Kernels::template dq<1>(), 1, dq_smem(1), nq, args);
}

}  // namespace hnarrow_f32
}  // namespace
