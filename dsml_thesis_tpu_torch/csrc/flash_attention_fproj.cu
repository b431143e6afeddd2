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
// UNet computes in fp32, serving): two launches, every product on TF32
// wgmma (hopper_tf32.cuh), every operand rounded to TF32 (cvt.rna) once
// where it is stored, fp32 accumulation, softmax statistics and sums:
//   (1) fproj_qkv_tf32_kernel writes q and k as [B, N, H*D] and v
//       transposed per head, [B, H, 32, npad] (N rounded up to the 64-key
//       tile, the padding zero), with the keys permuted inside each 8: TF32
//       wgmma reads shared-memory operands K-major only, and P V's B operand
//       is V^T with the keys as its depth, in the order in which P's
//       accumulator columns become its A fragment in registers;
//   (2) fproj_attend_tf32_kernel attends and projects the output: the
//       attention output never reaches device memory. The G head-group
//       blocks of a q-tile form a cluster; a block's heads stream 64-key K
//       and V^T tiles through a ring read by both of its warpgroups (a
//       128-row q-tile; one warpgroup a 64-row tile at N = 64), which take
//       turns on the tensor cores so that one's softmax runs under the
//       other's products; then each block computes its C / G output columns
//       over all H attention panels, reading the other groups' panels from
//       their blocks' shared memory. f_plan picks the warpgroups and G so
//       that the grid fills the card (G up to 16, non-portable clusters
//       past 8).
// Bound at [16, 1024, 160] x 5 on an H100 SXM at 700 W: operations, 14.1
// GFLOP on the TF32 tensor cores (0.0285 ms), beside 83.9 M exponentials
// on the special-function units (16 a cycle an SM: about 0.02 ms) that the
// softmax adds.
#include "hopper_tf32.cuh"
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
// TF32 wgmma throughout (hopper_tf32.cuh): every operand is rounded to TF32
// (tf32_rna: cvt.rna's rounding) once, where it is stored, and every product
// accumulates in fp32.
constexpr int F_PANEL_ROWB = 128;     // bytes of a tile row: 32 fp32 values
constexpr int F_KEYS = 64;            // keys of a streamed K / V tile
constexpr int F_STAGES = 4;           // K / V tiles of the ring
constexpr int F_KV_STAGE = 2 * F_KEYS * F_PANEL_ROWB;  // K, then V^T
constexpr int F_MAX_GROUPS = 16;      // blocks of a cluster, at most
constexpr int F_MAX_COLS = 160;       // output columns of a pass, at most
// the plan (f_plan): N up to F_ONE_WG_ROWS takes one warpgroup a 64-row
// q-tile, longer sequences two warpgroups a 128-row q-tile unless that
// leaves fewer than F_FILL blocks
constexpr int F_ONE_WG_ROWS = 64;
constexpr int F_FILL = 64;
constexpr int F_QKV_FILL = 192;  // blocks the grid of (1) should have

// The position in V^T of key n inside its 8: an accumulator's columns 2t and
// 2t + 1 are the TF32 A fragment's columns t and t + 4 (hopper_tf32.cuh).
__device__ __forceinline__ int perm8(int n) {
  return (n & ~7) | ((n & 1) << 2) | ((n & 7) >> 1);
}

__device__ __forceinline__ void cp_async_commit_f() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_f() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rounds 16 bytes of fp32 in shared memory to TF32 in place.
__device__ __forceinline__ void round16(unsigned char* p) {
  uint4 v = *reinterpret_cast<uint4*>(p);
  v = make_uint4(
      tf32_rna(__uint_as_float(v.x)), tf32_rna(__uint_as_float(v.y)),
      tf32_rna(__uint_as_float(v.z)), tf32_rna(__uint_as_float(v.w)));
  *reinterpret_cast<uint4*>(p) = v;
}

// Stores a thread's share of a 64 x (8 * J) accumulator (rows r and r + 8 of
// its warp, columns 8 j + 2 t, + 1) times mul0 / mul1, rounded to TF32, into
// a swizzled tile of 128-byte rows (J = 4: one 32-column panel).
template <int J>
__device__ __forceinline__ void park_rows(unsigned char* panel, int r,
                                          const float* acc, float mul0,
                                          float mul1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int col = 8 * j + 2 * t;
    const uint32_t in = (col & 3) * 4;
    *reinterpret_cast<uint2*>(panel + Swz<128>::at(r, col / 4) + in) =
        make_uint2(tf32_rna(acc[4 * j] * mul0),
                   tf32_rna(acc[4 * j + 1] * mul0));
    *reinterpret_cast<uint2*>(panel + Swz<128>::at(r + 8, col / 4) + in) =
        make_uint2(tf32_rna(acc[4 * j + 2] * mul1),
                   tf32_rna(acc[4 * j + 3] * mul1));
  }
}

// stages of (1)'s ring: four at BM = 64 (three tiles in flight), three at
// 128, where a fourth would leave one block an SM
__host__ __device__ constexpr int f_qkv_stages(int bm) {
  return bm == 64 ? 4 : 3;
}

__host__ __device__ constexpr int f_qkv_smem(int bm, int bn) {
  return 1024 + f_qkv_stages(bm) * (bm + bn) * F_PANEL_ROWB;
}

// (1) q, k and v^T: block (BM-row tile of a batch element, BN = 32 NCH
// output columns of the 3 H*D, batch), a warpgroup a 64 rows, m64nBNk8 from
// 128-byte-swizzled tiles of 32 channels through a ring of f_qkv_stages(BM)
// cp.async stages, each thread rounding the chunks it copied. q, k
// [B, N, H*D]; v^T [B, H, 32, npad] with the keys permuted inside each 8
// (perm8) and keys N .. npad - 1 zero (their h rows are zero-filled).
// BM = 64 where N <= 64, so that no tile is half empty. The grid's last
// z-slice writes Wo rounded to TF32 (wo_r) for (2) instead.
template <int NCH, int BM>
__global__ void __launch_bounds__(BM * 2)
fproj_qkv_tf32_kernel(const float* __restrict__ h, const float* __restrict__ wq,
                      const float* __restrict__ wk,
                      const float* __restrict__ wv,
                      const float* __restrict__ wo, float* __restrict__ q,
                      float* __restrict__ k, float* __restrict__ vt,
                      float* __restrict__ wo_r, int n, int c, int hd,
                      int npad) {
  constexpr int NT = BM * 2;
  if (blockIdx.z == gridDim.z - 1) {  // the last slice: Wo rounded, once
    const int64_t n4 = static_cast<int64_t>(c) * hd / 4;
    const int64_t step = static_cast<int64_t>(gridDim.x) * gridDim.y * NT;
    for (int64_t i = (static_cast<int64_t>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * NT + threadIdx.x;
         i < n4; i += step) {
      const float4 v = reinterpret_cast<const float4*>(wo)[i];
      reinterpret_cast<uint4*>(wo_r)[i] =
          make_uint4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                     tf32_rna(v.w));
    }
    return;
  }
  constexpr int BN = 32 * NCH;
  constexpr int A_TILE = BM * F_PANEL_ROWB;
  constexpr int STAGE = A_TILE + BN * F_PANEL_ROWB;
  constexpr int CHUNKS = (BM + BN) * 8 / NT;   // a thread's chunks a stage
  constexpr int S = f_qkv_stages(BM);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;   // of the 3 H*D output columns
  const int64_t b = blockIdx.z;
  const int z = col0 / hd;            // 0 q, 1 k, 2 v: BN divides H*D
  const float* w = (z == 0 ? wq : z == 1 ? wk : wv) +
                   static_cast<int64_t>(col0 - z * hd) * c;
  const float* hb = h + (b * n + n0) * c;
  const int steps = c / 32;

  auto at = [&](int j, int x) {  // chunk x of this thread in stage j
    const int i = tid + x * NT;
    const int r = i / 8, ch = i % 8;
    return base + (j % S) * STAGE +
           (r < BM ? Swz<128>::at(r, ch) : A_TILE + Swz<128>::at(r - BM, ch));
  };
  auto issue = [&](int j) {  // channels 32 j .. + 31 (an empty group past c)
    if (j < steps) {
#pragma unroll
      for (int x = 0; x < CHUNKS; ++x) {
        const int i = tid + x * NT;
        const int r = i / 8, ch = i % 8;
        const bool ok = r >= BM || n0 + r < n;
        const float* src = r < BM ? hb + static_cast<int64_t>(ok ? r : 0) * c
                                  : w + static_cast<int64_t>(r - BM) * c;
        cp_async16(cvta(at(j, x)), src + 32 * j + 4 * ch, ok);
      }
    }
    cp_async_commit_f();
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < S - 1; ++j) issue(j);
  for (int j = 0; j < steps; ++j) {
    issue(j + S - 1);  // into the stage read at step j - 1
    cp_async_wait_f<S - 1>();  // this thread's copies of step j have landed
#pragma unroll
    for (int x = 0; x < CHUNKS; ++x) round16(at(j, x));
    fence_async_shared();
    __syncthreads();  // stage j rounded and visible to the async proxy
    const uint32_t sa = cvta(base + (j % S) * STAGE) + wg * 64 * F_PANEL_ROWB;
    const uint32_t sb = cvta(base + (j % S) * STAGE) + A_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32_ss<BN>(acc, desc_k<128>(sa + 32 * kk),
                        desc_k<128>(sb + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with stage j
  }

  const int lane = tid & 31, t = lane & 3;
  const int r0 = n0 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  if (z < 2) {
    float* dst = (z == 0 ? q : k) + b * n * hd + (col0 - z * hd);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r0 < n)
        *reinterpret_cast<uint2*>(dst + static_cast<int64_t>(r0) * hd + col) =
            make_uint2(tf32_rna(acc[4 * j]), tf32_rna(acc[4 * j + 1]));
      if (r0 + 8 < n)
        *reinterpret_cast<uint2*>(dst + static_cast<int64_t>(r0 + 8) * hd +
                                  col) =
            make_uint2(tf32_rna(acc[4 * j + 2]), tf32_rna(acc[4 * j + 3]));
    }
  } else {
    // column col0 - 2 hd + col is (head, dim) = (.. / 32, .. % 32): v^T row
    float* dst = vt + (b * hd + (col0 - 2 * hd)) * npad;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int row = r0 + (e >> 1) * 8;
        if (row < npad)
          reinterpret_cast<uint32_t*>(dst)[static_cast<int64_t>(col) * npad +
                                           perm8(row)] =
              tf32_rna(acc[4 * j + e]);
      }
    }
  }
}

// Bytes of dynamic shared memory of (2) (1024 of alignment slack, the
// barriers at the end): the q / attention panels of the block's heads, then
// the K / V ring, which the output projection's two stages of an attention
// panel and a Wo panel reuse.
constexpr int F_OUT_STAGES = 4;  // stages of the output projection's ring

__host__ __device__ constexpr int f_attend_smem(int wgs, int hg, int cg) {
  return 1024 + hg * wgs * 64 * F_PANEL_ROWB +
         (F_STAGES * F_KV_STAGE > F_OUT_STAGES * (wgs * 64 + cg) * F_PANEL_ROWB
              ? F_STAGES * F_KV_STAGE
              : F_OUT_STAGES * (wgs * 64 + cg) * F_PANEL_ROWB) +
         (2 * F_STAGES + 1) * 8;
}

// (2) block (batch, q-tile of WGS x 64 rows, head group g), the G head-group
// blocks of a q-tile one thread-block cluster; warpgroup w owns rows 64 w ..
// of the q-tile. Each head's q columns sit in a panel (rows of 32 fp32);
// the heads' K tiles and V^T tiles (64 keys) stream through a ring of
// F_STAGES cp.async stages on mbarriers that both warpgroups read;
// S = q K^T and O += P V on TF32 wgmma, P formed in registers as the A
// operand (rounded to TF32; its depth is V^T's permuted order), the online
// softmax in the base-2 domain in fp32. A finished head's output, normalised
// and rounded to TF32, replaces its q columns. Then out[:, g cg .. + cg] =
// att @ Wo^T + bo over the H 32-column panels of att: the block's own, or
// another group's copied from its block's shared memory (distributed shared
// memory), each beside Wo's panel of the block's cg rows (Wo as (1)
// rounded it to TF32).
template <int WGS, int NCH>
__global__ void __launch_bounds__(WGS * 128)
fproj_attend_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ vt,
                         const float* __restrict__ wo,
                         const float* __restrict__ bo, float* __restrict__ out,
                         int n, int npad, int heads, int c, int groups,
                         int q_tiles, float scale_log2) {
  constexpr int NT = WGS * 128;
  constexpr int QR = WGS * 64;                  // rows of the q-tile
  constexpr int PANEL = QR * F_PANEL_ROWB;      // bytes of a head's panel
  constexpr int CG = 32 * NCH;                  // output columns a pass
  const int hd = heads * 32;
  const int g = static_cast<int>(cluster_rank());
  const int hg = heads / groups;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int tile = blockIdx.x / groups;
  const int64_t b = tile / q_tiles;
  const int q0 = (tile % q_tiles) * QR;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  unsigned char* ring = base + hg * PANEL;
  const int ring_bytes = f_attend_smem(WGS, hg, CG) - 1024 - hg * PANEL -
                         (2 * F_STAGES + 1) * 8;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ring_bytes);
  uint64_t* empty = full + F_STAGES;
  uint64_t* qbar = empty + F_STAGES;
  if (tid == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NT);
    }
    mbar_init(qbar, NT);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  // q of the block's heads, one panel a head (rows past n zeros)
  for (int i = tid; i < hg * QR * 8; i += NT) {
    const int hl = i / (QR * 8), r = (i / 8) % QR, ch = i % 8;
    const bool ok = q0 + r < n;
    cp_async16(cvta(base + hl * PANEL + Swz<128>::at(r, ch)),
               q + (b * n + (ok ? q0 + r : 0)) * hd + (g * hg + hl) * 32 +
                   4 * ch,
               ok);
  }
  cp_async_arrive(qbar);

  const int kv_tiles = npad / F_KEYS;
  const int natt = hg * kv_tiles;  // items: (head, K / V tile)
  auto issue = [&](int i) {
    const int s = i % F_STAGES;
    if (i >= F_STAGES) mbar_wait(&empty[s], ((i / F_STAGES) - 1) & 1);
    unsigned char* st = ring + s * F_KV_STAGE;
    const int h = g * hg + i / kv_tiles, kv0 = (i % kv_tiles) * F_KEYS;
    const float* ks = k + (b * n + kv0) * hd + h * 32;
    const float* vs = vt + ((b * heads + h) * 32) * npad + kv0;
#pragma unroll
    for (int x = 0; x < 2 * F_KEYS * 8 / NT; ++x) {
      const int j = tid + x * NT;
      if (j < F_KEYS * 8) {  // K: key r, channels 4 ch ..
        const int r = j / 8, ch = j % 8;
        const bool ok = kv0 + r < n;
        cp_async16(cvta(st + Swz<128>::at(r, ch)),
                   ks + static_cast<int64_t>(ok ? r : 0) * hd + 4 * ch, ok);
      } else {  // V^T: dim d, keys 4 ch .. (two panels of 32 keys)
        const int jj = j - F_KEYS * 8, d = jj / 16, ch = jj % 16;
        cp_async16(cvta(st + F_KEYS * F_PANEL_ROWB + (ch / 8) * 32 * 128 +
                        Swz<128>::at(d, ch % 8)),
                   vs + static_cast<int64_t>(d) * npad + 4 * ch, true);
      }
    }
    cp_async_arrive(&full[s]);
  };
  for (int i = 0; i < F_STAGES - 1 && i < natt; ++i) issue(i);
  mbar_wait(qbar, 0);
  fence_async_shared();

  const int rw = ((tid & 127) >> 5) * 16 + (lane >> 2);  // row in the wg
  const int key_t = 2 * (lane & 3);

  float o[16];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < natt; ++i) {
    const int s = i % F_STAGES;
    const int t = i % kv_tiles, hl = i / kv_tiles;
    if (t == 0) {
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) o[j] = 0.f;
    }
    const uint32_t sq = cvta(base + hl * PANEL) + wg * 64 * F_PANEL_ROWB;
    const uint32_t sk = cvta(ring + s * F_KV_STAGE);
    const uint32_t sv = sk + F_KEYS * F_PANEL_ROWB;
    mbar_wait(&full[s], (i / F_STAGES) & 1);
    fence_async_shared();

    float sc[F_KEYS / 2];  // S = q K^T, 64 rows x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32_ss<F_KEYS>(sc, desc_k<128>(sq + 32 * kk),
                            desc_k<128>(sk + 32 * kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask the keys past n (the last tile only), new row maxima in units of
    // the raw scores (a quad holds a row)
    const int kv0 = t * F_KEYS;
    if (kv0 + F_KEYS > n) {
#pragma unroll
      for (int j = 0; j < F_KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + 8 * j + key_t + (e & 1) >= n) sc[4 * j + e] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < F_KEYS / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2_fast((m0 - mx0) * scale_log2);
    const float alpha1 = exp2_fast((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    // P = exp2(S scale - max), summed in fp32, rounded to TF32 as the A
    // operand
    uint32_t pa[F_KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < F_KEYS / 8; ++j) {
      const float p0 = exp2_fast(fmaf(sc[4 * j], scale_log2, -ms0));
      const float p1 = exp2_fast(fmaf(sc[4 * j + 1], scale_log2, -ms0));
      const float p2 = exp2_fast(fmaf(sc[4 * j + 2], scale_log2, -ms1));
      const float p3 = exp2_fast(fmaf(sc[4 * j + 3], scale_log2, -ms1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j][0] = tf32_rna(p0);
      pa[j][1] = tf32_rna(p2);
      pa[j][2] = tf32_rna(p1);
      pa[j][3] = tf32_rna(p3);
    }

    // O += P V: the keys are the reduction, V^T's two panels of 32 keys
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < F_KEYS / 8; ++kt)
      wgmma_tf32_rs<32>(o, pa[kt],
                        desc_k<128>(sv + (kt / 4) * 32 * 128 + 32 * (kt % 4)),
                        1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[s]);
    // the stage of item i - 1, which both warpgroups are done with
    if (i + F_STAGES - 1 < natt) issue(i + F_STAGES - 1);
    if (t == kv_tiles - 1) {  // the head is done: park it over its q
      float s0 = l0 + __shfl_xor_sync(0xffffffffu, l0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      float s1 = l1 + __shfl_xor_sync(0xffffffffu, l1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      park_rows<4>(base + hl * PANEL, wg * 64 + rw, o, 1.f / s0, 1.f / s1);
    }
  }

  // ---- out[:, g cg .. + cg] = att @ Wo^T + bo, over the H panels
  fence_async_shared();
  cluster_arrive();
  cluster_wait();  // every block's heads are parked; the ring is free
  const int cg = c / groups;
  const int row = q0 + wg * 64 + rw;
  const int total = cg / CG * heads;  // Wo panels of all passes
  auto stage_of = [&](int p) {
    return ring + (p % F_OUT_STAGES) * (QR + CG) * F_PANEL_ROWB;
  };
  // panel p of the projection counts the panels of every pass: head panel
  // p % H
  auto hp_of = [&](int p) { return p % heads; };
  // Wo rows g cg + c0 .., columns 32 hp(p) .. + 31
  auto issue_wo = [&](int p) {
    unsigned char* st = stage_of(p) + PANEL;
    const float* src = wo + static_cast<int64_t>(g * cg + p / heads * CG) * hd +
                       32 * hp_of(p);
    if (p < total)
      for (int i = tid; i < CG * 8; i += NT)
        cp_async16(cvta(st + Swz<128>::at(i / 8, i % 8)),
                   src + static_cast<int64_t>(i / 8) * hd + 4 * (i % 8), true);
    cp_async_commit_f();  // an empty group past the last panel
  };
  // another group's panel p % H into its stage, in two halves: a thread's
  // four chunks loaded (all in flight at once) while panel p - 1's product
  // runs, then stored once it has been waited for
  constexpr int GCH = QR * 8 / NT;  // 16-byte chunks a thread of a panel
  auto remote = [&](int p) { return p < total && hp_of(p) / hg != g; };
  auto gather_load = [&](int p, uint4 (&v)[GCH]) {
    if (!remote(p)) return;
    const uint32_t src =
        map_rank(cvta(base + (hp_of(p) % hg) * PANEL), hp_of(p) / hg);
#pragma unroll
    for (int x = 0; x < GCH; ++x)
      v[x] = ld_cluster16(src + 16 * (tid + x * NT));
  };
  auto gather_store = [&](int p, const uint4 (&v)[GCH]) {
    if (!remote(p)) return;
    const uint32_t dst = cvta(stage_of(p));
#pragma unroll
    for (int x = 0; x < GCH; ++x) st_shared16(dst + 16 * (tid + x * NT), v[x]);
  };
  uint4 gv[GCH];
  float acc[CG / 2];
  for (int p = 0; p < F_OUT_STAGES - 1; ++p) issue_wo(p);
  gather_load(0, gv);
  gather_store(0, gv);
  for (int p = 0; p < total; ++p) {
    const int hp = hp_of(p);
    if (p % heads == 0) {
#pragma unroll
      for (int i = 0; i < CG / 2; ++i) acc[i] = 0.f;
    }
    gather_load(p + 1, gv);
    issue_wo(p + F_OUT_STAGES - 1);  // into the stage read at panel p - 1
    cp_async_wait_f<F_OUT_STAGES - 1>();  // this thread's copies of panel p
    unsigned char* sw = stage_of(p) + PANEL;
    fence_async_shared();
    __syncthreads();  // stage p is complete and visible to the async proxy
    const uint32_t sa = (hp / hg == g ? cvta(base + (hp % hg) * PANEL)
                                      : cvta(stage_of(p))) +
                        wg * 64 * F_PANEL_ROWB;
    const uint32_t sb = cvta(sw);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_tf32_ss<CG>(acc, desc_k<128>(sa + 32 * kk),
                        desc_k<128>(sb + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    gather_store(p + 1, gv);  // its stage was last read at panel p - 3
    __syncthreads();  // stage p is free for panel p + F_OUT_STAGES
    if (p % heads == heads - 1) {  // the pass is done: + bo, one write of out
      const int c0 = g * cg + p / heads * CG;
      float* orow = out + (b * n + row) * c + c0;
#pragma unroll
      for (int j = 0; j < CG / 8; ++j) {
        const int col = 8 * j + (lane & 3) * 2;
        const float b0 = bo[c0 + col], b1 = bo[c0 + col + 1];
        if (row < n)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
        if (row + 8 < n)
          *reinterpret_cast<float2*>(orow + 8 * static_cast<int64_t>(c) +
                                     col) =
              make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
      }
    }
  }
  cluster_arrive();  // done reading the other blocks (waited for at exit)
  cluster_wait();  // no block leaves while another may still read it
}

// Output columns of a pass of (2): the widest multiple of 32 up to
// F_MAX_COLS that divides the block's cg.
inline int f_pass_cols(int cg) {
  for (int w = F_MAX_COLS; w > 32; w -= 32)
    if (cg % w == 0) return w;
  return 32;
}

// The plan of (2) (ops/attention.py:fproj_f32_plan mirrors it): wgs
// warpgroups a block (two only past F_ONE_WG_ROWS tokens) and g head-group
// blocks a cluster (up to F_MAX_GROUPS, non-portable past 8) that divide
// the heads, leave each block a multiple of 32 output columns, at most
// F_MAX_COLS (one pass), and fit the shared memory. The first by wgs
// descending and g ascending whose grid has F_FILL blocks; else the one
// with the most blocks (the first of them). Where no grouping leaves one
// pass: one warpgroup, the fewest groups that fit, several passes. False
// where nothing fits.
inline bool f_plan(int b, int n, int heads, int c, int* wgs, int* groups) {
  int best = 0, best_wgs = 0, best_g = 0;
  for (int w = n > F_ONE_WG_ROWS ? 2 : 1; w >= 1; --w) {
    for (int g = 1; g <= F_MAX_GROUPS; ++g) {
      if (heads % g != 0 || c % (32 * g) != 0 || c / g > F_MAX_COLS ||
          f_attend_smem(w, heads / g, c / g) > 232448)
        continue;
      const int blocks = b * ((n + 64 * w - 1) / (64 * w)) * g;
      if (blocks >= F_FILL) {
        *wgs = w;
        *groups = g;
        return true;
      }
      if (blocks > best) {
        best = blocks;
        best_wgs = w;
        best_g = g;
      }
    }
  }
  if (best == 0) {  // several passes
    best_wgs = 1;
    for (int g = 1; g <= F_MAX_GROUPS && best_g == 0; ++g)
      if (heads % g == 0 && c % (32 * g) == 0 &&
          f_attend_smem(1, heads / g, f_pass_cols(c / g)) <= 232448)
        best_g = g;
  }
  *wgs = best_wgs;
  *groups = best_g;
  return best_g != 0;
}

template <int WGS, int NCH>
int launch_attend_tf32(const float* q, const float* k, const float* vt,
                       const float* wo, const float* bo, float* out, int b,
                       int n, int npad, int heads, int c, int groups,
                       float scale, cudaStream_t s) {
  const int q_tiles = (n + WGS * 64 - 1) / (WGS * 64);
  if (groups > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        fproj_attend_tf32_kernel<WGS, NCH>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return launch_cluster_grid(
      fproj_attend_tf32_kernel<WGS, NCH>, b * q_tiles * groups,
      WGS * 128, f_attend_smem(WGS, heads / groups, 32 * NCH), groups, s,
      q, k, vt, wo, bo, out, n, npad, heads, c, groups, q_tiles,
      scale * 1.4426950408889634f);
}

// Output columns of a block of (1) (ops/attention.py:fproj_f32_plan mirrors
// it): the widest multiple of 32 up to F_MAX_COLS that divides H*D and gives
// the grid F_QKV_FILL blocks, else the one that gives the most.
inline int f_qkv_cols(int b, int n, int hd) {
  const int tiles = b * ((n + (n <= 64 ? 63 : 127)) / (n <= 64 ? 64 : 128));
  int most = 32;
  for (int w = F_MAX_COLS; w >= 32; w -= 32) {
    if (hd % w != 0) continue;
    if (tiles * (3 * hd / w) >= F_QKV_FILL) return w;
    if (tiles * (3 * hd / w) > tiles * (3 * hd / most)) most = w;
  }
  return most;
}

template <int NCH, int BM>
int launch_qkv_tf32(const float* h, const float* wq, const float* wk,
                    const float* wv, const float* wo, float* q, float* k,
                    float* vt, float* wo_r, int b, int n, int c, int hd,
                    int npad, cudaStream_t s) {
  const int smem = f_qkv_smem(BM, 32 * NCH);
  const cudaError_t err = cudaFuncSetAttribute(
      fproj_qkv_tf32_kernel<NCH, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fproj_qkv_tf32_kernel<NCH, BM>
      <<<dim3((n + BM - 1) / BM, 3 * hd / (32 * NCH), b + 1), BM * 2, smem,
         s>>>(h, wq, wk, wv, wo, q, k, vt, wo_r, n, c, hd, npad);
  return static_cast<int>(cudaGetLastError());
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

// The fp32 instantiation: the same contract on fp32 tensors, D = 32 only;
// qkv is scratch of B * H*D * (2 N + npad) + C * H*D floats, npad = N
// rounded up to 64 (q [B, N, H*D], k the same, v^T [B, H, 32, npad], Wo
// rounded to TF32). Returns -1 also where
// no head grouping fits (f_plan).
extern "C" int dsml_flash_attention_fproj_f32(
    const void* h, const void* wq, const void* wk, const void* wv,
    const void* wo, const void* bo, void* qkv, void* out, int b, int n, int c,
    int heads, int d, float scale, void* stream) {
  if (c % 32 != 0 || d != 32 || b < 1 || n < 1 || heads < 1 || b >= 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const int hd = heads * 32;
  const int npad = (n + F_KEYS - 1) / F_KEYS * F_KEYS;
  int wgs, groups;
  if (!f_plan(b, n, heads, c, &wgs, &groups)) return -1;
  float* q = static_cast<float*>(qkv);
  float* k = q + static_cast<int64_t>(b) * n * hd;
  float* vt = k + static_cast<int64_t>(b) * n * hd;
  float* wo_r = vt + static_cast<int64_t>(b) * hd * npad;
  const int pn = f_qkv_cols(b, n, hd) / 32;
  int err = -1;
#define DSML_QKV_LAUNCH(NN)                                               \
  if (pn == NN)                                                           \
    err = n <= 64                                                         \
              ? launch_qkv_tf32<NN, 64>(cf(h), cf(wq), cf(wk), cf(wv),    \
                                        cf(wo), q, k, vt, wo_r, b, n, c,  \
                                        hd, npad, s)                      \
              : launch_qkv_tf32<NN, 128>(cf(h), cf(wq), cf(wk), cf(wv),   \
                                         cf(wo), q, k, vt, wo_r, b, n, c, \
                                         hd, npad, s);
  DSML_QKV_LAUNCH(1) DSML_QKV_LAUNCH(2) DSML_QKV_LAUNCH(3)
  DSML_QKV_LAUNCH(4) DSML_QKV_LAUNCH(5)
#undef DSML_QKV_LAUNCH
  if (err != 0) return err;
  const int nch = f_pass_cols(c / groups) / 32;
  auto o = static_cast<float*>(out);
#define DSML_ATTEND_LAUNCH(WW, NN)                                            \
  if (wgs == WW && nch == NN)                                                 \
    return launch_attend_tf32<WW, NN>(q, k, vt, wo_r, cf(bo), o, b, n, npad, \
                                      heads, c, groups, scale, s);
  DSML_ATTEND_LAUNCH(1, 1) DSML_ATTEND_LAUNCH(1, 2) DSML_ATTEND_LAUNCH(1, 3)
  DSML_ATTEND_LAUNCH(1, 4) DSML_ATTEND_LAUNCH(1, 5) DSML_ATTEND_LAUNCH(2, 1)
  DSML_ATTEND_LAUNCH(2, 2) DSML_ATTEND_LAUNCH(2, 3) DSML_ATTEND_LAUNCH(2, 4)
  DSML_ATTEND_LAUNCH(2, 5)
#undef DSML_ATTEND_LAUNCH
  return -1;
}
