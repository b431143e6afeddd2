// flash_attention_qout: self-attention with the q projection and to_out
// fused around it, K and V given:
//   out = concat_h softmax(h Wq_h K_h^T * scale) V_h @ Wo^T + bo
//   h [B, N, C], k / v [B, Nk, H*D], Wq [H*D, C], Wo [C, H*D], bo [C]
//   -> out [B, N, C]
// (weights in the [out, in] layout of torch.nn.Linear), bf16, fp32 accumulate.
//
// Replaces the TPU kernel
// dsml_thesis_tpu/ops/attention.py:_flash_kernel_packed_qout
// (flash_attention_qout), the form for sequences of more than one q-block,
// where projecting K and V inside every q-block would repeat that work: K
// and V come from plain linears outside, and q and the attention output
// never reach device memory. Its casts: q is accumulated in fp32 and cast to
// bf16, each head's output is cast to bf16 before the output projection,
// and out is accumulated in fp32, the bias added, then cast.
//
// Bound on this card ([8, 4096, 160], 5 heads of 32): 89 GFLOP, 0.090 ms at
// 989 TFLOP/s. Each score also costs an exp2 on the special-function unit
// (16 a cycle an SM: 671 M of them, about 0.17 ms), and at D = 32 a score
// is only two k16 steps of tensor-core work, so the per-tile chain of
// products, softmax and ring waits sets the pace, not either unit alone.
// What the design does about it: several blocks in flight on an SM, so that
// one block's products overlap another's softmax; no work repeated between
// blocks; q and the attention output kept on chip.
//
// Design (hopper_tiles.cuh), the layout of flash_attention_fproj.cu's
// attention kernel: one warpgroup (64 query rows) a (batch, q-tile, head
// group); the G blocks of the H / G head groups of one q-tile form a
// thread-block cluster. A block walks its heads in turn. For each head it
//   (1) projects the head's q columns, q_h = h Wq_h^T on wgmma, from 64-channel
//       panels of h and of the head's rows of Wq that stream through a ring
//       of STAGES cp.async stages completing on mbarriers (channels past C
//       are zeros); the fp32 accumulator, cast to bf16, stays in registers
//       as the A operand of the score product (no block repeats another's
//       projection, and q never touches shared memory);
//   (2) streams the head's columns of K and V in 128-key tiles through the
//       same ring: hopper::attend_tiles, S = q K^T and O += P V on wgmma
//       with P packed to bf16 in registers, under the online softmax (exp2
//       by ex2.approx, fp32 row sums as the TPU kernel takes them);
//   (3) parks the normalised output, cast to bf16, in its columns of a
//       [64, H*D] shared-memory tile.
// After a cluster barrier each block copies the other blocks' columns from
// their shared memory (distributed shared memory) and computes its C / G
// output columns of att @ Wo^T + bo on wgmma while Wo's 32-column panels
// stream through the ring (hopper::gather_head_groups, project_out; where
// H*D % 32 == 16 the last panel is cut at H*D). No atomics: equal inputs
// give equal bits. G is the most head groups up to 8 that divide H (5 at
// the model's shapes, 2560 blocks at [8, 4096, 160] against 512 with one
// group). A head of 80
// columns (the level-0 heads of mead-256-ldm-f4-fullattn-dh64.yaml: 160
// channels, 2 heads under the legacy head-width rule) is two column panels
// of 64 and 16 (hopper::HeadSplit), each with products of its own width.
#include "hopper_tiles.cuh"

namespace {

using namespace hopper;

constexpr int AKV = 128;              // key / value rows a streamed tile
constexpr int STAGES = 3;
constexpr int HK = 64;                // channels of h / Wq a stage (128 B rows)
constexpr int MAX_NCH = 5;            // 32-wide output chunks a pass, at most
// Blocks of a cluster, at most (the portable cluster size). Timed in one
// call of tools/variants.py on an H100 SXM at 700 W (PERF.md section 6), at
// [8, 4096, 160] and [16, 4096, 160] x 5 five groups read 0.4434 and
// 0.8535 ms against 0.4449 and 0.8794 for one: a tie at batch 8, 3% at
// batch 16.
constexpr int MAX_GROUPS = 8;
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ constexpr int round_up(int x, int r) {
  return (x + r - 1) / r * r;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// bytes of a ring stage: a K and a V tile, an h panel and a head's Wq panel,
// or a Wo panel of up to MAX_NCH * 32 rows
__host__ __device__ constexpr int stage_bytes(int d) {
  return round_up(cmax(cmax(2 * AKV * 2 * d, ATT_ROWS * HK * 2 + d * HK * 2),
                       MAX_NCH * 32 * WO_COLS * 2),
                  1024);
}

// shared memory of a block: alignment slack, the [64, H*D] tile, the ring
// and its barriers (mirrored by ops/attention.py:_qout_shared_memory)
__host__ __device__ constexpr int smem_bytes(int hd, int d) {
  return 1024 + (hd + 63) / 64 * ATT_PANEL + STAGES * stage_bytes(d) +
         2 * STAGES * 8;
}

template <int D, int NCH>
__global__ void __launch_bounds__(ATT_THREADS)
qout_attention_kernel(const bf16* __restrict__ h, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ wq,
                      const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                      bf16* __restrict__ out, int n, int nk, int c, int heads,
                      int groups, int q_tiles, float scale_log2) {
  constexpr int NT = ATT_THREADS;
  constexpr int DA = HeadSplit<D>::A, DB = HeadSplit<D>::B;
  const int hd = heads * D;
  const int g = static_cast<int>(cluster_rank());
  const int hg = heads / groups;            // heads of this block
  const int cg = c / groups;                // output columns of this block
  const int stage = stage_bytes(D);
  const int panels = (hd + 63) / 64;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t att = cvta(base);
  const uint32_t ring = att + panels * ATT_PANEL;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + panels * ATT_PANEL +
                                               STAGES * stage);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tile = blockIdx.x / groups;
  const int b = tile / q_tiles;
  const int q0 = (tile % q_tiles) * ATT_ROWS;
  const bf16* hrows = h + (static_cast<int64_t>(b) * n + q0) * c;
  const bf16* kb = k + static_cast<int64_t>(b) * nk * hd;
  const bf16* vb = v + static_cast<int64_t>(b) * nk * hd;
  const int col0 = g * hg * D;              // this block's attention columns

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NT);
    }
    mbar_fence_init();
  }
  zero_att_tail(att, hd, tid);
  __syncthreads();  // the barriers exist before anyone waits on them

  // items: for each head, its q-projection panels then its K / V tiles;
  // then the (pass, Wo panel) pairs of the output projection
  const int cpan = (c + HK - 1) / HK;
  const int kv_tiles = (nk + AKV - 1) / AKV;
  const int per_head = cpan + kv_tiles;
  const int natt = hg * per_head;
  const int kpanels = wo_panels(hd);
  const int chunks = (cg + 31) / 32;
  const int passes = chunks / NCH;          // the host picks NCH | chunks
  const int nitems = natt + passes * kpanels;
  // the producer's cursor: the next item is head ih's item it (its q
  // projection panels, then its K / V tiles), then output pass ip's Wo
  // panel iw
  int issued = 0, ih = 0, it = 0, ip = 0, iw = 0;
  auto issue_next = [&]() {
    const int s = issued % STAGES;
    if (issued >= STAGES) mbar_wait(&empty[s], ((issued / STAGES) - 1) & 1);
    const uint32_t st = ring + s * stage;
    if (ih < hg) {
      const int head = g * hg + ih;
      if (it < cpan) {
        const int kc = it * HK;
        load_tile_async<HK * 2, ATT_ROWS, NT>(st, hrows + kc, c, n - q0, tid,
                                              c - kc);
        load_tile_async<HK * 2, D, NT>(
            st + ATT_ROWS * HK * 2,
            wq + static_cast<int64_t>(head) * D * c + kc, c, D, tid, c - kc);
      } else {
        load_kv_tile_async<D, AKV, NT>(st, kb + head * D, vb + head * D, hd,
                                       (it - cpan) * AKV, nk, tid);
      }
      if (++it == per_head) {
        it = 0;
        ++ih;
      }
    } else {
      const int r0 = g * cg + ip * NCH * 32;
      load_wo_panel<NCH * 32>(st, wo, hd, r0, g * cg + cg - r0, iw, tid);
      if (++iw == kpanels) {
        iw = 0;
        ++ip;
      }
    }
    cp_async_arrive(&full[s]);
    ++issued;
  };
  while (issued < STAGES && issued < nitems) issue_next();

  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // the thread's two rows
  // the ring's items in order: take() waits for the next one and returns
  // its stage's address, release() frees the one taken last and refills
  // its stage
  int taken = 0;
  auto take = [&]() {
    const int s = taken % STAGES;
    mbar_wait(&full[s], (taken / STAGES) & 1);
    fence_async_shared();
    ++taken;
    return ring + s * stage;
  };
  auto release = [&]() {
    mbar_arrive(&empty[(taken - 1) % STAGES]);
    if (issued < nitems) issue_next();
  };

  for (int j = 0; j < hg; ++j) {
    // ---- (1) q of head j: [64 rows] x [D]
    float qacc[D / 2];
    for (int p = 0; p < cpan; ++p) {
      const uint32_t st = take();
      const uint32_t sb = st + ATT_ROWS * HK * 2;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk) {
        const uint64_t da = desc_k<128>(st + 32 * kk);
        wgmma_ss<DA, 0>(part<0, DA>(qacc), da, desc_k<128>(sb + 32 * kk),
                        p > 0 || kk > 0);
        if constexpr (DB > 0)
          wgmma_ss<DB, 0>(part<DA, DB>(qacc), da,
                          desc_k<128>(sb + DA * HK * 2 + 32 * kk),
                          p > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(qacc);
      release();
    }
    uint32_t qa[D / 16][4];  // q cast to bf16: the A operand of S
#pragma unroll
    for (int s = 0; s < D / 16; ++s) acc_to_a<D>(qa[s], qacc, s);

    // ---- (2) attention of head j over the K / V tiles
    float o[D / 2];
    float m0, m1, l0, l1;
    attend_tiles<D, AKV, false>(qa, o, m0, m1, l0, l1, kv_tiles, 0, nk,
                                scale_log2, 0u, lane, take, release);

    // ---- (3) the head's output, normalised and cast, into its columns
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int byte = 4 * (lane & 3);
#pragma unroll
    for (int x = 0; x < D / 8; ++x) {
      const int col = col0 + j * D + 8 * x;
      *reinterpret_cast<uint32_t*>(base + att_at(r0, col) + byte) =
          pack2(o[4 * x] * inv0, o[4 * x + 1] * inv0);
      *reinterpret_cast<uint32_t*>(base + att_at(r0 + 8, col) + byte) =
          pack2(o[4 * x + 2] * inv1, o[4 * x + 3] * inv1);
    }
  }

  // ---- the other head groups' columns, then out[:, g*cg .. +cg]
  gather_head_groups(att, g, groups, hg * D / 8, tid);
  project_out<NCH>(att, bo, out + (static_cast<int64_t>(b) * n + q0) * c, c,
                   n - q0, g * cg, g * cg + cg, passes, hd, take, release);
  cluster_wait();  // no block leaves while another may still read it
}

template <int D, int NCH>
int launch(const bf16* h, const bf16* k, const bf16* v, const bf16* wq,
           const bf16* wo, const bf16* bo, bf16* out, int b, int n, int nk,
           int c, int heads, int groups, float scale, cudaStream_t stream) {
  const int q_tiles = (n + ATT_ROWS - 1) / ATT_ROWS;
  return launch_clusters(qout_attention_kernel<D, NCH>, b * q_tiles * groups,
                         smem_bytes(heads * D, D), groups, stream, h, k, v,
                         wq, wo, bo, out, n, nk, c, heads, groups, q_tiles,
                         scale * 1.4426950408889634f);
}

}  // namespace

// Needs C % 16 == 0, D in {32, 64, 80} and smem_bytes(H*D, D) within the
// 227 KB of a block. Returns cudaGetLastError() of the launch (0 = launched),
// -1 for a shape this file does not take.
extern "C" int dsml_flash_attention_qout(
    const void* h, const void* k, const void* v, const void* wq,
    const void* wo, const void* bo, void* out, int b, int n, int nk, int c,
    int heads, int d, float scale, void* stream) {
  if (c % 16 != 0 || (d != 32 && d != 64 && d != 80) || b < 1 || n < 1 ||
      nk < 1 || heads < 1)
    return -1;
  if (smem_bytes(heads * d, d) > SMEM_LIMIT) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = head_groups(heads, c, MAX_GROUPS, 16);
  const int chunks = (c / groups + 31) / 32;  // 32-wide chunks of a block
  const int nch = chunks % 5 == 0 ? 5 : chunks % 4 == 0 ? 4
                : chunks % 3 == 0 ? 3 : chunks % 2 == 0 ? 2 : 1;
  auto ch = static_cast<const bf16*>(h);
  auto ck = static_cast<const bf16*>(k);
  auto cv = static_cast<const bf16*>(v);
  auto cwq = static_cast<const bf16*>(wq);
  auto cwo = static_cast<const bf16*>(wo);
  auto cbo = static_cast<const bf16*>(bo);
  auto o = static_cast<bf16*>(out);
#define DSML_QOUT_LAUNCH(DD, NN)                                          \
  if (d == DD && nch == NN)                                              \
    return launch<DD, NN>(ch, ck, cv, cwq, cwo, cbo, o, b, n, nk, c, heads, \
                          groups, scale, s);
  DSML_QOUT_LAUNCH(32, 1) DSML_QOUT_LAUNCH(32, 2) DSML_QOUT_LAUNCH(32, 3)
  DSML_QOUT_LAUNCH(32, 4) DSML_QOUT_LAUNCH(32, 5) DSML_QOUT_LAUNCH(64, 1)
  DSML_QOUT_LAUNCH(64, 2) DSML_QOUT_LAUNCH(64, 3) DSML_QOUT_LAUNCH(64, 4)
  DSML_QOUT_LAUNCH(64, 5) DSML_QOUT_LAUNCH(80, 1) DSML_QOUT_LAUNCH(80, 2)
  DSML_QOUT_LAUNCH(80, 3) DSML_QOUT_LAUNCH(80, 4) DSML_QOUT_LAUNCH(80, 5)
#undef DSML_QOUT_LAUNCH
  return -1;
}
