// The Hopper grid of the attention forward with a saved row log-sum-exp,
// shared by the packed forward (flash_attention_packed.cu) and the bf16
// split-head forward at D = 32 / 64 / 80 (flash_attention.cu): one
// warpgroup a (batch, 64-row q-tile, head) on rows of `heads` heads of D
// columns, a head addressed by base pointer + h * D with the row stride
// heads * D. Split heads [BH, N, D] are heads = 1 with B = BH, so both
// callers run the same instantiations.
//
// Arithmetic, as the TPU kernels': scores in fp32 times scale * log2(e), the
// running row maximum and the row sums in fp32 (of the fp32 probabilities),
// P = exp2(s - max) cast to bf16 for P V, fp32 accumulation, one cast of o.
// The log-sum-exp is m * scale * log2(e) + log2(l), the domain in which the
// backward grids (hopper_bwd.cuh) recompute p = exp2(s * scale * log2(e) -
// lse).
//
// Bound: operations (4 * Nq * Nk * H * D a batch element against
// 2 * (2 Nq + 2 Nk) * H * D bytes), and at D = 32 the exp2 of every score on
// the special-function unit (16 a cycle an SM) as much.
//
// Design (hopper_tiles.cuh): cp.async gathers the head's columns of the
// q-tile (2 * D bytes of each 2 * H * D byte row: whole 32-byte sectors)
// into a swizzled tile, whence each thread reads its rows as the A operand
// of the score product. The head's K and V stream in 128-key tiles through
// a ring of stages filled by cp.async, each completing on an mbarrier
// (hopper::load_kv_tile_async, row 6's loader); hopper::attend_tiles runs
// S = q K^T and O += P V on wgmma with P packed to bf16 in registers, exp2 by
// ex2.approx. A head of 80 columns (the level-0 heads of
// mead-256-ldm-f4-fullattn-dh64.yaml: 160 channels, 2 heads under the legacy
// head-width rule) is two column panels of 64 and 16 (hopper::HeadSplit).
// Shared memory: the q-tile and the stages, 53 KB at D = 32 (four blocks an
// SM), 105 KB at D = 64 (two); at D = 80 two stages, 91 KB (two blocks an
// SM, where three stages would leave room for one).
#pragma once

#include "hopper_tiles.cuh"

namespace {
namespace hfwd {

using namespace hopper;

constexpr int ROWS = 64;   // query rows a block: one warpgroup
constexpr int NT = 128;    // its threads
constexpr int AKV = 128;   // key / value rows a streamed tile

// The blocks an SM that the callers' kernels state (__launch_bounds__):
// four at D = 32, which caps a thread at 128 registers (it takes 130
// uncapped, three blocks: 0.6409 against 0.5629 ms at [16, 4096, 5 x 32],
// tools/variants.py, H100 SXM at 700 W), and one at D = 64 / 80, where
// shared memory and registers (183 / 217) leave room for two blocks and a
// stated minimum of two made D = 80 8% slower (0.2738 against 0.2521 ms at
// [8, 4096, 2 x 80]).
__host__ __device__ constexpr int min_blocks(int d) { return d == 32 ? 4 : 1; }

// shared memory of a block: alignment slack, the q-tile, the ring and its
// barriers (full, empty, the q-tile's)
__host__ __device__ constexpr int smem_bytes(int d) {
  return 1024 + ROWS * 2 * d + kv_stages(d) * 2 * AKV * 2 * d +
         (2 * kv_stages(d) + 1) * 8;
}

// The A operand of k16 step s of the score product for the warpgroup's
// thread: rows r0 and r0 + 8 of the q-tile at sq (the panels of
// HeadSplit<D>), columns 16 s + 2 (lane % 4) + {0, 1} and + 8.
template <int D>
__device__ __forceinline__ void q_fragments(uint32_t (&qa)[D / 16][4],
                                            uint32_t sq, int r0, int lane) {
  constexpr int DA = HeadSplit<D>::A;
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + ((e & 1) ? 8 : 0);
      const int chunk = (e & 2) ? 1 : 0;   // 16-byte chunk of the k16 step
      uint32_t at;
      if (16 * s < DA)
        at = sq + Swz<2 * DA>::at(r, 2 * s + chunk);
      else
        at = sq + ROWS * 2 * DA + Swz<32>::at(r, 2 * (s - DA / 16) + chunk);
      asm volatile("ld.shared.u32 %0, [%1];\n"
                   : "=r"(qa[s][e])
                   : "r"(at + 4 * (lane & 3)));
    }
  }
}

template <int D>
__device__ __forceinline__ void attend_heads(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int nq, int nk, int heads, int q_tiles, float scale_log2) {
  constexpr int STAGES = kv_stages(D);
  constexpr int QTILE = ROWS * 2 * D;      // the q-tile's panels
  constexpr int STAGE = 2 * AKV * 2 * D;   // a K and a V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw, 1024);
  const uint32_t sq = cvta(base);
  const uint32_t ring = sq + QTILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + QTILE + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int h = blockIdx.x % heads;
  const int tile = blockIdx.x / heads;
  const int b = tile / q_tiles;
  const int q0 = (tile % q_tiles) * ROWS;
  const int64_t ld = static_cast<int64_t>(heads) * D;
  const int64_t qrow = (static_cast<int64_t>(b) * nq + q0) * ld + h * D;
  const bf16* kh = k + static_cast<int64_t>(b) * nk * ld + h * D;
  const bf16* vh = v + static_cast<int64_t>(b) * nk * ld + h * D;
  const int ntiles = (nk + AKV - 1) / AKV;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NT);
    }
    mbar_init(qbar, NT);
    mbar_fence_init();
  }
  __syncthreads();  // the barriers exist before anyone waits on them

  // the ragged last q-tile: rows past nq are zeros and are not written back
  load_head_async<D, ROWS, NT>(sq, q + qrow, ld, nq - q0, tid);
  cp_async_arrive(qbar);
  int issued = 0;
  auto issue_next = [&]() {  // the keys of tile `issued` into its stage
    const int i = issued++;
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
    load_kv_tile_async<D, AKV, NT>(ring + s * STAGE, kh, vh, ld, i * AKV, nk,
                                   tid);
    cp_async_arrive(&full[s]);
  };
  while (issued < STAGES && issued < ntiles) issue_next();

  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // the thread's two rows
  uint32_t qa[D / 16][4];
  mbar_wait(qbar, 0);
  q_fragments<D>(qa, sq, r0, lane);

  int taken = 0;
  auto wait = [&]() {
    const int s = taken % STAGES;
    mbar_wait(&full[s], (taken / STAGES) & 1);
    fence_async_shared();
    ++taken;
    return ring + s * STAGE;
  };
  auto done = [&]() {  // frees the tile taken last and refills its stage
    mbar_arrive(&empty[(taken - 1) % STAGES]);
    if (issued < ntiles) issue_next();
  };
  float acc[D / 2];
  float m0, m1, l0, l1;
  attend_tiles<D, AKV, false>(qa, acc, m0, m1, l0, l1, ntiles, 0, nk,
                              scale_log2, 0u, lane, wait, done);

  const int r1 = r0 + 8;
  if (lse != nullptr && (lane & 3) == 0) {
    float* row_lse = lse + (static_cast<int64_t>(b) * heads + h) * nq + q0;
    if (q0 + r0 < nq) row_lse[r0] = m0 * scale_log2 + log2f(l0);
    if (q0 + r1 < nq) row_lse[r1] = m1 * scale_log2 + log2f(l1);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* orow = o + qrow;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (q0 + r0 < nq)
      *reinterpret_cast<uint32_t*>(orow + r0 * ld + col) =
          pack2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (q0 + r1 < nq)
      *reinterpret_cast<uint32_t*>(orow + r1 * ld + col) =
          pack2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

// Each caller defines its own __global__ kernel around attend_heads, with
// __launch_bounds__(NT, min_blocks(D)), so that a profile names the row
// that launched it.

// o (and, where lse is not null, the [B, H, Nq] row log-sum-exp) of b batch
// elements of `heads` heads of D columns on `stream`, by `kernel` (the
// caller's __global__ around attend_heads<D>). Returns the CUDA error
// of the launch (0 = launched), or -1 for an empty shape.
template <int D, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v,
           void* o, void* lse, int b, int nq, int nk, int heads, float scale,
           cudaStream_t stream) {
  if (b < 1 || nq < 1 || nk < 1 || heads < 1) return -1;
  const int smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + ROWS - 1) / ROWS;
  kernel<<<b * q_tiles * heads, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), nq, nk, heads, q_tiles,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hfwd
}  // namespace
