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
// query rows, and projecting K and V in each of the N / 64 blocks would
// multiply that work by N / 64, so this file has two kernels:
//   (1) qkv_proj_kernel writes q, k, v once, cast to bf16 as the TPU kernel
//       casts them, into a packed [B, N, 3*H*D] scratch that the wrapper
//       allocates (one write and a few cached reads of 3*H*D*2 bytes a row,
//       which stay in the 50 MB L2 at the model's shapes).
//   (2) fproj_attention_kernel attends and projects the output; the
//       attention output and the head split never reach device memory.
//
// Bound on this card: operations ([16, 1024, 320] x 10 heads: 21.5 GFLOP of
// attention and 13.4 of projections, 0.035 ms at 989 TFLOP/s; 0.012 ms of
// bytes). At D = 32 every score product is two k16 steps deep, and each
// score costs an exp2 on the special-function unit (16 a cycle an SM:
// 168 M of them, 0.045 ms, at that shape), so the softmax weighs more than
// the tensor-core work.
//
// Design (hopper_tiles.cuh):
//   (1) a 128 x 128 output tile a block, two warpgroups of 64 rows, wgmma
//       m64n128k16 from 128-byte-swizzled tiles of 64 channels that arrive
//       through a ring of three stages filled by cp.async, each stage
//       completing on an mbarrier and released on another; the tile leaves
//       through shared memory as whole 16-byte chunks of a row.
//   (2) one warpgroup a (batch, 64-row q-tile, head group); the G blocks of
//       the H / G head groups of one q-tile form a thread-block cluster.
//       Each block attends its heads: its q columns sit in a [64, H*D]
//       shared-memory tile, the heads' 128-row K / V tiles stream through a
//       ring of three cp.async stages on mbarriers, S = q K^T runs on wgmma
//       from shared memory and O += P V with P packed to bf16 in registers.
//       Each head's normalised output, cast to bf16, replaces its q columns.
//       After a cluster barrier each block copies the other blocks' columns
//       from their shared memory (distributed shared memory) into its own
//       tile, and computes C / G output columns of att @ Wo^T + bo on wgmma
//       while Wo's 32-column panels stream through the same ring
//       (hopper::gather_head_groups and project_out, which the q/out-fused
//       kernel shares). No atomics:
//       equal inputs give equal bits. G is the largest count up to
//       MAX_GROUPS = 2 that divides H and leaves C / G a multiple of 32:
//       clusters of 4 and 5 measured slower at the model's shapes (the
//       copies between blocks and the cluster barrier grow with G), and so
//       did issuing the next tile's scores before this tile's softmax
//       (ptxas serialized every wgmma of that version, warning C7518).
//
// fp32 at D = 32 (dsml_flash_attention_fproj_f32; mead-128-ldm-f4.yaml, whose
// UNet computes in fp32, serving): three launches on the TF32 tensor cores
// (attention_f32_narrow.cuh), operands rounded to TF32 once where they are
// stored, fp32 accumulation:
//   (1) gemm_block writes q, k, v into the [B, N, 3*H*D] fp32 scratch (one
//       grid plane a projection, 64 x 64 output tiles);
//   (2) fwd_block attends each (batch, 64-row q-tile, head) and writes the
//       normalised output over the q columns it read (a block reads only its
//       own q rows and head, before it writes them);
//   (3) gemm_block computes att @ Wo^T + bo from those columns.
// The attention output reaches device memory once (the bf16 design keeps it
// in shared memory across a cluster): at [16, 1024, 160] that is 10 MB
// written and read against 14.1 GFLOP of products (3.4 of them the four
// projections). Bound at that shape: operations, on the TF32 tensor cores.
#include "attention_f32_narrow.cuh"
#include "hopper_tiles.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------- (1) ---
// out[m, z*hd + n] = sum_k a[m, k] * w_z[n, k]; columns of all three
// projections side by side (z = column / hd picks q / k / v).
constexpr int PM = 128;      // rows a block
constexpr int PN = 128;      // output columns a block
constexpr int PK = 64;       // channels a stage (128-byte rows)
constexpr int P_STAGES = 3;
constexpr int P_TILE = PM * PK * 2;     // bytes of the A (or B) tile
constexpr int P_STAGE = 2 * P_TILE;
constexpr int P_SMEM = 1024 + P_STAGES * P_STAGE + 2 * P_STAGES * 8;

__global__ void __launch_bounds__(256)
qkv_proj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ wq,
                const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                bf16* __restrict__ out, int m, int c, int hd) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t ring = cvta(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + P_STAGES * P_STAGE);
  uint64_t* empty = full + P_STAGES;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * PM;
  const int n0 = blockIdx.y * PN;
  const int ncols = 3 * hd;

  if (tid == 0) {
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(&full[s], 256);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  const int steps = (c + PK - 1) / PK;
  auto issue = [&](int j) {  // channels j * PK .. + PK into stage j % STAGES
    const int s = j % P_STAGES;
    if (j >= P_STAGES) mbar_wait(&empty[s], ((j / P_STAGES) - 1) & 1);
    const uint32_t sa = ring + s * P_STAGE, sb = sa + P_TILE;
    const int k0 = j * PK;
#pragma unroll
    for (int x = 0; x < 2 * PM * 8 / 256; ++x) {  // 8 chunks a thread
      const int i = tid + x * 256;
      const int tile = i / (PM * 8), r = (i / 8) % PM, ch = i % 8;
      const int k = k0 + ch * 8;
      const bf16* src;
      bool ok;
      if (tile == 0) {
        ok = m0 + r < m && k < c;
        src = a + (ok ? static_cast<int64_t>(m0 + r) * c + k : 0);
      } else {
        const int n = n0 + r;
        ok = n < ncols && k < c;
        const int z = ok ? n / hd : 0;
        const bf16* w = z == 0 ? wq : (z == 1 ? wk : wv);
        src = w + (ok ? static_cast<int64_t>(n - z * hd) * c + k : 0);
      }
      cp_async16((tile == 0 ? sa : sb) + Swz<128>::at(r, ch), src, ok);
    }
    cp_async_arrive(&full[s]);
  };
  for (int j = 0; j < P_STAGES - 1 && j < steps; ++j) issue(j);

  const int wg = tid >> 7;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int j = 0; j < steps; ++j) {
    const int s = j % P_STAGES;
    mbar_wait(&full[s], (j / P_STAGES) & 1);
    fence_async_shared();
    const uint32_t sa = ring + s * P_STAGE + wg * 64 * 128;
    const uint32_t sb = ring + s * P_STAGE + P_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK / 16; ++kk)
      wgmma_ss<128, 0>(acc, desc_k<128>(sa + 32 * kk),
                       desc_k<128>(sb + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (j > 0) mbar_arrive(&empty[(j - 1) % P_STAGES]);
    if (j + P_STAGES - 1 < steps) issue(j + P_STAGES - 1);  // into that stage
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the tile, cast to bf16, through shared memory (rows of PN + 8) so that
  // the stores to device memory are whole 16-byte chunks of a row
  constexpr int LDT = PN + 8;
  bf16* tile = reinterpret_cast<bf16*>(base);
  __syncthreads();  // both warpgroups are done reading the ring
  const int wt = tid & 127;
  const int r0 = wg * 64 + (wt >> 5) * 16 + ((wt & 31) >> 2);
#pragma unroll
  for (int j = 0; j < PN / 8; ++j) {
    const int col = 8 * j + 2 * (wt & 3);
    *reinterpret_cast<uint32_t*>(tile + r0 * LDT + col) =
        pack2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + (r0 + 8) * LDT + col) =
        pack2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  for (int i = tid; i < PM * PN / 8; i += 256) {
    const int r = i / (PN / 8), col = (i % (PN / 8)) * 8;
    if (m0 + r < m && n0 + col < ncols)
      *reinterpret_cast<uint4*>(out + static_cast<int64_t>(m0 + r) * ncols +
                                n0 + col) =
          *reinterpret_cast<const uint4*>(tile + r * LDT + col);
  }
}

// ---------------------------------------------------------------- (2) ---
constexpr int AKV = 128;      // key / value rows a streamed tile
constexpr int A_STAGES = 3;
constexpr int MAX_GROUPS = 2; // blocks of a cluster, at most

__host__ __device__ constexpr int round_up(int x, int r) {
  return (x + r - 1) / r * r;
}

// bytes of a ring stage: a K and a V tile, or cols rows of a Wo panel
__host__ __device__ constexpr int attn_stage_bytes(int d, int pass_cols) {
  return round_up(2 * AKV * 2 * d > pass_cols * WO_COLS * 2
                      ? 2 * AKV * 2 * d
                      : pass_cols * WO_COLS * 2,
                  1024);
}

// NCH: 32-wide output chunks of a pass of the output projection (a
// compile-time count keeps every wgmma on a path all threads take)
template <int D, int NCH>
__global__ void __launch_bounds__(ATT_THREADS)
fproj_attention_kernel(const bf16* __restrict__ qkv,
                       const bf16* __restrict__ wo,
                       const bf16* __restrict__ bo, bf16* __restrict__ out,
                       int n, int heads, int c, int groups, int q_tiles,
                       float scale_log2) {
  constexpr int ROWB = 2 * D;
  const int hd = heads * D;
  const int64_t ld = 3 * static_cast<int64_t>(hd);
  const int g = static_cast<int>(cluster_rank());
  const int hg = heads / groups;            // heads of this block
  const int cg = c / groups;                // output columns of this block
  constexpr int pass_cols = NCH * 32;
  const int stage = attn_stage_bytes(D, pass_cols);
  const int panels = (hd + 63) / 64;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t att = cvta(base);
  const uint32_t ring = att + panels * ATT_PANEL;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + panels * ATT_PANEL +
                                               A_STAGES * stage);
  uint64_t* empty = full + A_STAGES;
  uint64_t* qbar = empty + A_STAGES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tile = blockIdx.x / groups;
  const int b = tile / q_tiles;
  const int q0 = (tile % q_tiles) * ATT_ROWS;
  const bf16* rows = qkv + static_cast<int64_t>(b) * n * ld;
  const int col0 = g * hg * D;              // this block's attention columns

  if (tid == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(&full[s], ATT_THREADS);
      mbar_init(&empty[s], ATT_THREADS);
    }
    mbar_init(qbar, ATT_THREADS);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  // q of the block's heads into their columns of the [64, H*D] tile
  for (int i = tid; i < ATT_ROWS * hg * D / 8; i += ATT_THREADS) {
    const int r = i / (hg * D / 8), col = col0 + (i % (hg * D / 8)) * 8;
    const bool ok = q0 + r < n;
    cp_async16(att + att_at(r, col), rows + (ok ? (q0 + r) * ld + col : 0),
               ok);
  }
  cp_async_arrive(qbar);

  const int kv_tiles = (n + AKV - 1) / AKV;
  const int natt = hg * kv_tiles;           // items: (head, K / V tile) ...
  const int kpanels = wo_panels(hd);        // ... then (pass, Wo panel)
  const int passes = cg / pass_cols;
  const int nitems = natt + passes * kpanels;
  auto issue = [&](int i) {
    const int s = i % A_STAGES;
    if (i >= A_STAGES) mbar_wait(&empty[s], ((i / A_STAGES) - 1) & 1);
    const uint32_t st = ring + s * stage;
    if (i < natt) {
      const int h = g * hg + i / kv_tiles, kv0 = (i % kv_tiles) * AKV;
      const bf16* src = rows + kv0 * ld + hd + h * D;
      load_tile_async<ROWB, AKV, ATT_THREADS>(st, src, ld, n - kv0, tid);
      load_tile_async<ROWB, AKV, ATT_THREADS>(st + AKV * ROWB, src + hd, ld,
                                              n - kv0, tid);
    } else {
      const int pass = (i - natt) / kpanels, p = (i - natt) % kpanels;
      const int r0 = g * cg + pass * pass_cols;
      load_wo_panel<pass_cols>(st, wo, hd, r0, pass_cols, p, tid);
    }
    cp_async_arrive(&full[s]);
  };
  for (int i = 0; i < A_STAGES && i < nitems; ++i) issue(i);
  mbar_wait(qbar, 0);

  // ---- attention of the block's heads: item i is K / V tile i % kv_tiles
  // of head i / kv_tiles
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // the thread's two rows
  float o[D / 2];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // the finished head's output, normalised and cast, over its q columns
  auto park = [&](int hl) {
    float s0 = l0 + __shfl_xor_sync(0xffffffffu, l0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    float s1 = l1 + __shfl_xor_sync(0xffffffffu, l1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    const float inv0 = 1.f / s0, inv1 = 1.f / s1;
    const int byte = 4 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = col0 + hl * D + 8 * j;
      *reinterpret_cast<uint32_t*>(base + att_at(r0, col) + byte) =
          pack2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(base + att_at(r0 + 8, col) + byte) =
          pack2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  };
  for (int i = 0; i < natt; ++i) {
    const int s = i % A_STAGES;
    const int t = i % kv_tiles;
    const int hcol = col0 + (i / kv_tiles) * D;
    const uint32_t sq = att + (hcol / 64) * ATT_PANEL + (hcol % 64) * 2;
    const uint32_t sk = ring + s * stage, sv = sk + AKV * ROWB;
    mbar_wait(&full[s], (i / A_STAGES) & 1);
    fence_async_shared();

    float sc[AKV / 2];  // S = q K^T, [64 query rows] x [AKV keys]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<AKV, 0>(sc, desc_k<128>(sq + 32 * kk),
                       desc_k<ROWB>(sk + 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (t == 0) {  // a new head: park the last one, start again
      if (i > 0) park(i / kv_tiles - 1);
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    }

    // scale (and mask the keys past n in a ragged last tile), new row max
    // (a quad of lanes holds a row)
    const int kv0 = t * AKV;
#pragma unroll
    for (int j = 0; j < AKV / 2; ++j) sc[j] *= scale_log2;
    if (kv0 + AKV > n) {
#pragma unroll
      for (int j = 0; j < AKV / 8; ++j) {
        const int key = kv0 + 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = key + (e & 1) < n ? sc[4 * j + e] : -INFINITY;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < AKV / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2_fast(m0 - mx0), alpha1 = exp2_fast(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    // P = exp2(S - max), summed in fp32, cast to bf16 as the A operand
#pragma unroll
    for (int j = 0; j < AKV / 8; ++j) {
      sc[4 * j] = exp2_fast(sc[4 * j] - m0);
      sc[4 * j + 1] = exp2_fast(sc[4 * j + 1] - m0);
      sc[4 * j + 2] = exp2_fast(sc[4 * j + 2] - m1);
      sc[4 * j + 3] = exp2_fast(sc[4 * j + 3] - m1);
      l0 += sc[4 * j] + sc[4 * j + 1];
      l1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    uint32_t pa[AKV / 16][4];
#pragma unroll
    for (int kt = 0; kt < AKV / 16; ++kt) acc_to_a<AKV>(pa[kt], sc, kt);

    // O += P V: the keys are the reduction
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < AKV / 16; ++kt)
      wgmma_rs<D, 1>(o, pa[kt], desc_mn<ROWB>(sv + kt * 16 * ROWB));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[s]);
    if (i + A_STAGES < nitems) issue(i + A_STAGES);  // into the freed stage
  }
  park(hg - 1);

  // ---- the other head groups' columns, then out[:, g*cg .. +cg]; the Wo
  // panels are the ring's items natt ..
  gather_head_groups(att, g, groups, hg * D / 8, tid);
  int next = natt;
  auto take = [&]() {
    const int s = next % A_STAGES;
    mbar_wait(&full[s], (next / A_STAGES) & 1);
    fence_async_shared();
    ++next;
    return ring + s * stage;
  };
  auto release = [&]() {
    const int i = next - 1;
    mbar_arrive(&empty[i % A_STAGES]);
    if (i + A_STAGES < nitems) issue(i + A_STAGES);
  };
  project_out<NCH>(att, bo, out + (static_cast<int64_t>(b) * n + q0) * c, c,
                   n - q0, g * cg, g * cg + cg, passes, hd, take, release);
  cluster_wait();  // no block leaves while another may still read it
}

template <int D, int NCH>
int launch_attention(const bf16* qkv, const bf16* wo, const bf16* bo,
                     bf16* out, int b, int n, int c, int heads, int groups,
                     float scale, cudaStream_t stream) {
  const int hd = heads * D;
  const int smem = 1024 + (hd + 63) / 64 * ATT_PANEL +
                   A_STAGES * attn_stage_bytes(D, NCH * 32) +
                   (2 * A_STAGES + 1) * 8;
  const int q_tiles = (n + ATT_ROWS - 1) / ATT_ROWS;
  return launch_clusters(fproj_attention_kernel<D, NCH>, b * q_tiles * groups,
                         smem, groups, stream, qkv, wo, bo, out, n, heads, c,
                         groups, q_tiles, scale * 1.4426950408889634f);
}

// ------------------------------------------------------------ fp32 ---
__global__ void __launch_bounds__(f32narrow::NT)
fproj_gemm_f32_kernel(const float* __restrict__ a,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1,
                      const float* __restrict__ w2,
                      const float* __restrict__ bias, float* __restrict__ c,
                      int m, int n, int kdim, int64_t lda, int64_t ldc) {
  f32narrow::gemm_block(a, w0, w1, w2, bias, c, m, n, kdim, lda, ldc);
}

// q and o are the same columns of the scratch (no __restrict__): each
// block reads its q rows into registers before it writes its output there
__global__ void __launch_bounds__(f32narrow::NT)
fproj_attention_f32_kernel(const float* q, const float* __restrict__ k,
                           const float* __restrict__ v, float* o, float* lse,
                           int64_t ldq, int64_t ldkv, int64_t ldo, int nq,
                           int nk, int heads, int q_tiles, float scale_log2) {
  f32narrow::fwd_block(q, k, v, o, lse, ldq, ldkv, ldo, nq, nk, heads,
                       q_tiles, scale_log2);
}

}  // namespace

// h [B, N, C]; wq / wk / wv [H*D, C]; wo [C, H*D]; bo [C]; qkv is scratch of
// B * N * 3 * H * D bf16; out [B, N, C]. Needs C % 32 == 0 and D in {32, 64}.
// Returns cudaGetLastError() of the launches (0 = launched), -1 for a shape
// this file does not take.
extern "C" int dsml_flash_attention_fproj(
    const void* h, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* bo, void* qkv, void* out, int b, int n, int c,
    int heads, int d, float scale, void* stream) {
  if (c % 32 != 0 || (d != 32 && d != 64)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = heads * d;
  const int m = b * n;
  cudaError_t err = cudaFuncSetAttribute(
      qkv_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((m + PM - 1) / PM, (3 * hd + PN - 1) / PN);
  qkv_proj_kernel<<<grid, 256, P_SMEM, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<bf16*>(qkv), m, c, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto cq = static_cast<const bf16*>(qkv);
  auto cw = static_cast<const bf16*>(wo);
  auto cb = static_cast<const bf16*>(bo);
  auto o = static_cast<bf16*>(out);
  const int groups = head_groups(heads, c, MAX_GROUPS, 32);
  const int chunks = c / groups / 32;  // 32-wide output chunks of a block
  const int nch = chunks % 5 == 0 ? 5 : chunks % 4 == 0 ? 4
                : chunks % 3 == 0 ? 3 : chunks % 2 == 0 ? 2 : 1;
#define DSML_FPROJ_LAUNCH(DD, NN)                                          \
  if (d == DD && nch == NN)                                               \
    return launch_attention<DD, NN>(cq, cw, cb, o, b, n, c, heads, groups, \
                                    scale, s);
  DSML_FPROJ_LAUNCH(32, 1) DSML_FPROJ_LAUNCH(32, 2) DSML_FPROJ_LAUNCH(32, 3)
  DSML_FPROJ_LAUNCH(32, 4) DSML_FPROJ_LAUNCH(32, 5) DSML_FPROJ_LAUNCH(64, 1)
  DSML_FPROJ_LAUNCH(64, 2) DSML_FPROJ_LAUNCH(64, 3) DSML_FPROJ_LAUNCH(64, 4)
  DSML_FPROJ_LAUNCH(64, 5)
#undef DSML_FPROJ_LAUNCH
  return -1;
}

// The fp32 instantiation: the same contract on fp32 tensors (qkv scratch of
// B * N * 3 * H * D fp32), C % 32 == 0 and D = 32 only.
extern "C" int dsml_flash_attention_fproj_f32(
    const void* h, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* bo, void* qkv, void* out, int b, int n, int c,
    int heads, int d, float scale, void* stream) {
  if (c % 32 != 0 || d != f32narrow::D || b < 1 || n < 1 || heads < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  float* buf = static_cast<float*>(qkv);
  const int hd = heads * d;
  const int m = b * n;
  constexpr int T = f32narrow::TILE;
  fproj_gemm_f32_kernel<<<dim3((m + T - 1) / T, (hd + T - 1) / T, 3),
                          f32narrow::NT, 0, s>>>(
      cf(h), cf(wq), cf(wk), cf(wv), nullptr, buf, m, hd, c, c, 3 * hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ld = 3 * static_cast<int64_t>(hd);
  const int code = f32narrow::launch_fwd(
      fproj_attention_f32_kernel, buf, buf + hd, buf + 2 * hd, buf, nullptr, b,
      n, n, heads, ld, ld, ld, scale, s);
  if (code != 0) return code;
  fproj_gemm_f32_kernel<<<dim3((m + T - 1) / T, (c + T - 1) / T, 1),
                          f32narrow::NT, 0, s>>>(
      buf, cf(wo), cf(wo), cf(wo), cf(bo), static_cast<float*>(out), m, c, hd,
      ld, c);
  return static_cast<int>(cudaGetLastError());
}
