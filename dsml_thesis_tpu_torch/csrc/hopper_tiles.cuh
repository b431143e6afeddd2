// Hopper building blocks of the redesigned attention kernels
// (flash_attention_fproj.cu, flash_attention_packed.cu,
// flash_attention_qout.cu, the D = 32 / 64 path of
// flash_attention_streaming.cu, hopper_bwd.cuh's backward grids with the
// bf16 streaming backward's lse launch, and hopper_wide.cuh's and
// hopper_wide_f32.cuh's D = 512 forwards): shared-memory tiles in the
// swizzled layouts wgmma reads, the wgmma descriptors and instructions (bf16
// in, fp32 accumulate), named barriers, mbarriers, cp.async copies that
// complete on an mbarrier, the cluster barrier and distributed shared-memory
// loads, the K / V tile loader and the online-softmax loop over a K / V ring
// that the packed, q/out-fused and streaming kernels share, and the cluster
// gather and output projection that the fused-projection and q/out-fused
// kernels share. Raw PTX, for sm_90a.
//
// Tiles. A tile of rows of ROWB bytes (32, 64 or 128: 16, 32 or 64 bf16
// columns) is stored row after row with each 16-byte chunk of a row moved
// by the swizzle of that width: byte offset o goes to
// o ^ ((o >> 3) & mask), mask = (ROWB / 16 - 1) << 4, which is what the
// hardware reads for swizzle mode ROWB when the tile starts on a multiple
// of 8 * ROWB bytes. The same tile serves as a K-major operand (its columns
// are the reduction: the rows of a [rows][D] tile against the columns of
// another) and as an MN-major one (its rows are the reduction: the B
// operand of P V), through two descriptors.
//
// Fragments. The accumulator of m64nNk16 gives thread t of the warpgroup
// (warp w = t / 32, lane l) rows 16 w + l / 4 and + 8, and of each 8-column
// block j the columns 8 j + 2 (l % 4) + {0, 1}: d[4 j + {0, 1}] on the
// first row, d[4 j + {2, 3}] on the second, as mma.sync's m16n8 fragment
// of the warp's 16 rows. An A operand in registers is mma.sync's m16n8k16
// A fragment of the warp's 16 rows, so an accumulator becomes the A operand
// of the next product by packing pairs to bf16 in place.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace hopper {

__device__ __forceinline__ uint32_t cvta(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit alone (ex2.approx.ftz: about 2 ulp,
// results below 2^-126 flushed to 0), where exp2f adds range handling
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ swizzle ---
template <int ROWB>
struct Swz {
  static_assert(ROWB == 32 || ROWB == 64 || ROWB == 128, "swizzle width");
  static constexpr uint32_t MASK = (ROWB / 16 - 1) << 4;
  static constexpr int LAYOUT = ROWB == 128 ? 1 : (ROWB == 64 ? 2 : 3);
  static constexpr int CHUNKS = ROWB / 16;  // 16-byte chunks a row
  // byte offset of 16-byte chunk c of row r
  __device__ __forceinline__ static uint32_t at(int r, int c) {
    const uint32_t o = static_cast<uint32_t>(r * ROWB + c * 16);
    return o ^ ((o >> 3) & MASK);
  }
};

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout (1 = 128-byte, 2 = 64-byte, 3 = 32-byte
// swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// A tile read with its columns as the reduction (K-major): 8-row groups
// 8 * ROWB bytes apart. k16 step s of a row starts 32 s bytes in: add it to
// addr.
template <int ROWB>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return make_desc(addr, 16, 8 * ROWB, Swz<ROWB>::LAYOUT);
}

// A tile read with its rows as the reduction (MN-major, TRANS_B = 1): its
// ROWB bytes of columns are one swizzle atom; 8-row groups of the
// reduction 8 * ROWB bytes apart. k16 step s starts 16 s rows in.
template <int ROWB>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return make_desc(addr, 8 * ROWB, 8 * ROWB, Swz<ROWB>::LAYOUT);
}

// The same over N > ROWB / 2 columns stored as panels of ROWB-byte rows,
// `panel` bytes apart: the leading byte offset steps from one swizzle atom
// of the columns to the next.
template <int ROWB>
__device__ __forceinline__ uint64_t desc_mn_panels(uint32_t addr,
                                                   uint32_t panel) {
  return make_desc(addr, panel, 8 * ROWB, Swz<ROWB>::LAYOUT);
}

// ------------------------------------------------------- named barriers ---
// Barrier id (1-15; 0 is __syncthreads) of `count` threads: bar_sync waits
// for all of them, bar_arrive counts this thread's warp and goes on (a
// producer's signal to threads that bar_sync on the same id).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------ mbarrier ---
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(cvta(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy and the cluster
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(cvta(bar))
               : "memory");
}

// Spins until the phase of the given parity has completed (the loop is
// inside the asm).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(cvta(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------ cp.async ---
// 16 bytes global -> shared; zeros written and nothing read when !valid
// (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One arrival on bar once every cp.async this thread issued so far has
// landed (the barrier's count includes this thread: no increment).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   cvta(bar))
               : "memory");
}

// Orders this thread's shared-memory traffic of the generic proxy (its
// stores, the cp.async copies it has seen complete) before later reads of
// the async proxy (wgmma operands).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy a tile of ROWS rows of ROWB bytes from device memory (row i at
// src + i * ld elements) into a swizzled tile at dst; rows at or past
// valid_rows, and 8-element chunks at or past valid_cols elements, are
// zeros. The NTHREADS threads of the calling group (index t) share the
// chunks in a loop of fixed trip count (the last round is cut short only
// where NTHREADS does not divide the chunks).
template <int ROWB, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                int64_t ld, int valid_rows,
                                                int t,
                                                int valid_cols = ROWB / 2) {
  constexpr int CH = Swz<ROWB>::CHUNKS;
  constexpr int TOTAL = ROWS * CH;
#pragma unroll
  for (int k = 0; k < (TOTAL + NTHREADS - 1) / NTHREADS; ++k) {
    const int i = t + k * NTHREADS;
    if (TOTAL % NTHREADS != 0 && i >= TOTAL) break;
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid_rows && c * 8 < valid_cols;
    cp_async16(dst + Swz<ROWB>::at(r, c), src + (ok ? r * ld + c * 8 : 0), ok);
  }
}

// -------------------------------------------------------------- wgmma ---
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// After wgmma_wait: the registers an asynchronous product wrote are read
// no earlier than here.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A operands in registers: wgmma reads them asynchronously,
// so they stay live (and unchanged) until the wait.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[64 x 16] (+)= A[64 x 16] B[16 x 16], A and B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
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
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d[64 x 8] (+)= A[64 x 16] B[16 x 8], A in registers (the warp's
// m16n8k16 A fragment of its 16 rows), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// d[64 x 16] (+)= A[64 x 16] B[16 x 16], A in registers (the warp's
// m16n8k16 A fragment of its 16 rows), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "%14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], A in registers (the warp's
// m16n8k16 A fragment of its 16 rows), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (the warp's
// m16n8k16 A fragment of its 16 rows), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}
// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers (the warp's
// m16n8k16 A fragment of its 16 rows), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], A in registers (the warp's
// m16n8k16 A fragment of its 16 rows), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
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
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d = 1) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_ss width");
  if constexpr (N == 16) wgmma_ss_n16<TRANS_B>(d, da, db, scale_d);
  if constexpr (N == 32) wgmma_ss_n32<TRANS_B>(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_ss_n64<TRANS_B>(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_ss_n128<TRANS_B>(d, da, db, scale_d);
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128 ||
                    N == 256,
                "wgmma_rs width");
  if constexpr (N == 8) wgmma_rs_n8<TRANS_B>(d, a, db, scale_d);
  if constexpr (N == 16) wgmma_rs_n16<TRANS_B>(d, a, db, scale_d);
  if constexpr (N == 32) wgmma_rs_n32<TRANS_B>(d, a, db, scale_d);
  if constexpr (N == 64) wgmma_rs_n64<TRANS_B>(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_rs_n128<TRANS_B>(d, a, db, scale_d);
  if constexpr (N == 256) wgmma_rs_n256<TRANS_B>(d, a, db, scale_d);
}

// The A operand of k16 step s from an accumulator of N columns that becomes
// the reduction of the next product: columns 16 s .. 16 s + 15, cast to
// bf16 (mma.sync's m16n8k16 A fragment).
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&d)[N / 2], int s) {
  a[0] = pack2(d[8 * s + 0], d[8 * s + 1]);
  a[1] = pack2(d[8 * s + 2], d[8 * s + 3]);
  a[2] = pack2(d[8 * s + 4], d[8 * s + 5]);
  a[3] = pack2(d[8 * s + 6], d[8 * s + 7]);
}

// ---------------------------------------------------------- head split ---
// A head of D columns (32, 64 or 80) as two column panels: A, the first
// min(D, 64) columns in rows of 2 A bytes (the widest swizzle), and B, the
// 16 columns past 64 of an 80-wide head in rows of 32 bytes. An accumulator
// of D columns is the A part's accumulator followed by the B part's, which
// is the layout of one D-wide accumulator: part<0, A>() and part<A, B>()
// name the two for the products.
template <int D>
struct HeadSplit {
  static_assert(D == 32 || D == 64 || D == 80, "head width");
  static constexpr int A = D < 64 ? D : 64;
  static constexpr int B = D - A;
};

// Stages of a K / V ring that feeds attend_tiles, by head width: two at
// D = 80, where a third would leave room for one block an SM instead of two
// (the packed forward 0.2511 against 0.3898 ms, the streaming forward
// 0.2789 against 0.4396 ms, at 2 heads of 80 and 4096 rows, batch 8,
// tools/variants.py, H100 SXM at 700 W); three otherwise.
__host__ __device__ constexpr int kv_stages(int d) { return d == 80 ? 2 : 3; }
template <int OFF, int N, int LEN>
__device__ __forceinline__ float (&part(float (&d)[LEN]))[N / 2] {
  static_assert(OFF / 2 + N / 2 <= LEN, "accumulator part");
  return *reinterpret_cast<float(*)[N / 2]>(&d[OFF / 2]);
}

// ROWS rows of one head's D columns (row i at src + i * ld elements; rows at
// or past valid_rows zeros) into the tile at dst: panel A of HeadSplit<D>,
// then panel B (ROWS rows of 32 bytes) where D = 80.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_head_async(uint32_t dst, const bf16* src,
                                                int64_t ld, int valid_rows,
                                                int t) {
  constexpr int DA = HeadSplit<D>::A, DB = HeadSplit<D>::B;
  load_tile_async<2 * DA, ROWS, NTHREADS>(dst, src, ld, valid_rows, t);
  if constexpr (DB > 0)
    load_tile_async<32, ROWS, NTHREADS>(dst + ROWS * 2 * DA, src + DA, ld,
                                        valid_rows, t);
}

// The K / V tile of attend_tiles for keys kv0 .. kv0 + AKV - 1 (those at or
// past kv_end zeros): one head's columns of K, then of V, each as the
// panels of load_head_async. k and v point at the head's first column of
// key 0; rows are ld elements apart (D on split heads, H*D on packed rows).
template <int D, int AKV, int NTHREADS>
__device__ __forceinline__ void load_kv_tile_async(uint32_t dst,
                                                   const bf16* k,
                                                   const bf16* v, int64_t ld,
                                                   int kv0, int kv_end,
                                                   int t) {
  const int64_t off = static_cast<int64_t>(kv0) * ld;
  load_head_async<D, AKV, NTHREADS>(dst, k + off, ld, kv_end - kv0, t);
  load_head_async<D, AKV, NTHREADS>(dst + AKV * 2 * D, v + off, ld,
                                    kv_end - kv0, t);
}

// ------------------------------------------------------ online softmax ---
// The scores S = q K^T [64 x AKV] of one K / V tile in a warpgroup's
// accumulator layout (a quad of lanes holds a row) of keys key0 ..
// key0 + AKV - 1, those at or past key_end masked, become the probabilities
// P = exp2((S - max) * scale) in place (fp32), with the running row maxima
// m0 / m1 kept in units of the raw scores (scale > 0) and alpha0 / alpha1 the
// factors that rescale what was summed under the old maxima. FINITE is the
// streaming kernel's arithmetic: masked scores are the finite -1e30 and
// their probabilities exactly 0 (a row with no key yet would otherwise get
// exp2(0) = 1); else masked scores are -inf.
template <int AKV, bool FINITE>
__device__ __forceinline__ void softmax_scores(float (&sc)[AKV / 2],
                                               float& m0, float& m1,
                                               float& alpha0, float& alpha1,
                                               int key0, int key_end,
                                               float scale, int lane) {
  const float masked = FINITE ? -1e30f : -INFINITY;
  const bool ragged = key0 + AKV > key_end;
  if (ragged) {
#pragma unroll
    for (int j = 0; j < AKV / 8; ++j) {
      const int key = key0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key + (e & 1) >= key_end) sc[4 * j + e] = masked;
    }
  }
  // row maxima in four independent chains a row
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = sc[e];
#pragma unroll
  for (int j = 2; j < AKV / 8; j += 2)
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = fmaxf(x[e], sc[4 * j + e]);
  float mx0 = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[4], x[5]));
  float mx1 = fmaxf(fmaxf(x[2], x[3]), fmaxf(x[6], x[7]));
  mx0 = fmaxf(m0, fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1)));
  mx1 = fmaxf(m1, fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1)));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha0 = exp2_fast((m0 - mx0) * scale);
  alpha1 = exp2_fast((m1 - mx1) * scale);
  m0 = mx0;
  m1 = mx1;
  const float ms0 = mx0 * scale, ms1 = mx1 * scale;
#pragma unroll
  for (int j = 0; j < AKV / 8; ++j) {
    sc[4 * j] = exp2_fast(fmaf(sc[4 * j], scale, -ms0));
    sc[4 * j + 1] = exp2_fast(fmaf(sc[4 * j + 1], scale, -ms0));
    sc[4 * j + 2] = exp2_fast(fmaf(sc[4 * j + 2], scale, -ms1));
    sc[4 * j + 3] = exp2_fast(fmaf(sc[4 * j + 3], scale, -ms1));
  }
  if (FINITE && ragged) {
#pragma unroll
    for (int j = 0; j < AKV / 8; ++j) {
      const int key = key0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key + (e & 1) >= key_end) sc[4 * j + e] = 0.f;
    }
  }
}

// This lane's share of the two rows' sums of P (fp32), in four independent
// chains a row.
template <int AKV>
__device__ __forceinline__ void add_row_sums(const float (&p)[AKV / 2],
                                             float& l0, float& l1) {
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = p[e];
#pragma unroll
  for (int j = 2; j < AKV / 8; j += 2)
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] += p[4 * j + e];
  l0 += (x[0] + x[1]) + (x[4] + x[5]);
  l1 += (x[2] + x[3]) + (x[6] + x[7]);
}

// acc *= alpha of its row (an accumulator of N columns)
template <int N>
__device__ __forceinline__ void scale_rows(float (&acc)[N / 2], float alpha0,
                                           float alpha1) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    acc[4 * j] *= alpha0;
    acc[4 * j + 1] *= alpha0;
    acc[4 * j + 2] *= alpha1;
    acc[4 * j + 3] *= alpha1;
  }
}

// The full row sums of a warpgroup's two rows from the lanes' shares.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Online-softmax attention of a warpgroup's 64 query rows over ntiles >= 1
// K / V tiles of AKV keys (tile t holds keys key0 + AKV t ..; keys at or
// past key_end are masked) that arrive in shared memory in a ring: wait()
// waits for the next tile and returns the address of its K tile, done()
// releases it. A tile is the K panels A and B of HeadSplit<D>, then the V
// panels A and B, each AKV rows, swizzled by the width of its rows. qa is q
// (cast to bf16) as the A operand of S. On return o holds the unnormalised
// output, m0 / m1 the row maxima (raw score units) and l0 / l1 the full row
// sums. Each product is waited for at once: the overlap of
// products and softmax comes from the other blocks on the SM (a version that
// issued the next tile's scores before this tile's softmax needed a second
// set of P registers, and lost more to occupancy than it gained).
// Row sums: FINITE adds P as cast to bf16, on the tensor cores as a product
// with the all-ones bf16 tile at `ones` (1024 bytes): the exact products
// summed in fp32, the TPU streaming kernel's ones column of V. Otherwise
// the fp32 P on the FMA units.
template <int D, int AKV, bool FINITE, typename Wait, typename Done>
__device__ __forceinline__ void attend_tiles(
    const uint32_t (&qa)[D / 16][4], float (&o)[D / 2], float& m0,
    float& m1, float& l0, float& l1, int ntiles, int key0, int key_end,
    float scale, uint32_t ones, int lane, Wait wait, Done done) {
  constexpr int DA = HeadSplit<D>::A, DB = HeadSplit<D>::B, ROWA = 2 * DA;
  float lacc[4];  // FINITE: the row sums as an accumulator of 8 columns
#pragma unroll
  for (int x = 0; x < 4; ++x) lacc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  m0 = m1 = FINITE ? -1e30f : -INFINITY;
  l0 = l1 = 0.f;
  const uint64_t dones = desc_k<32>(ones);
  for (int t = 0; t < ntiles; ++t) {
    const uint32_t ka = wait(), kb = ka + AKV * ROWA;
    const uint32_t va = kb + AKV * 2 * DB, vb = va + AKV * ROWA;
    float sc[AKV / 2];  // S = q K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DA / 16; ++kk)
      wgmma_rs<AKV, 0>(sc, qa[kk], desc_k<ROWA>(ka + 32 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DB / 16; ++kk)
      wgmma_rs<AKV, 0>(sc, qa[DA / 16 + kk], desc_k<32>(kb + 32 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    float alpha0, alpha1;
    softmax_scores<AKV, FINITE>(sc, m0, m1, alpha0, alpha1, key0 + t * AKV,
                                key_end, scale, lane);
    uint32_t pa[AKV / 16][4];  // P cast to bf16: the A operand of P V
#pragma unroll
    for (int kt = 0; kt < AKV / 16; ++kt) acc_to_a<AKV>(pa[kt], sc, kt);
    scale_rows<D>(o, alpha0, alpha1);
    if constexpr (FINITE) {
      scale_rows<8>(lacc, alpha0, alpha1);
    } else {
      l0 *= alpha0;
      l1 *= alpha1;
      add_row_sums<AKV>(sc, l0, l1);
    }
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < AKV / 16; ++kt) {
      wgmma_rs<DA, 1>(part<0, DA>(o), pa[kt],
                      desc_mn<ROWA>(va + kt * 16 * ROWA));
      if constexpr (DB > 0)
        wgmma_rs<DB, 1>(part<DA, DB>(o), pa[kt],
                        desc_mn<32>(vb + kt * 16 * 32));
      if constexpr (FINITE) wgmma_rs<8, 0>(lacc, pa[kt], dones);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(lacc);
    fence_regs(pa);
    done();
  }
  if constexpr (FINITE) {
    l0 = lacc[0];
    l1 = lacc[2];
  } else {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
  }
}

// Fills the 1024-byte all-ones bf16 tile of attend_tiles' FINITE row sums
// (the NTHREADS threads of the block, before a barrier that precedes any
// product reading it).
template <int NTHREADS>
__device__ __forceinline__ void fill_ones(unsigned char* ones, int t) {
  for (int i = t; i < 1024 / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(ones)[i] =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
  fence_async_shared();
}

// ------------------------------------------------------------ cluster ---
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address in block `rank`'s shared memory of this block's address addr
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// A dynamic shared-memory pointer rounded up to a multiple of `align` bytes
// (a swizzled tile starts on a multiple of its swizzle atom, 1024 at most).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p,
                                                     uint32_t align) {
  const uint32_t a = cvta(p);
  return p + ((align - (a % align)) % align);
}

// ---------------------------------------- attention tile and out proj ---
// The layout of the fused-projection and q/out-fused attention kernels
// (flash_attention_fproj.cu, flash_attention_qout.cu): one warpgroup a
// (batch, 64-row q-tile, head group), the G head-group blocks of a q-tile
// one thread-block cluster. Each block parks its heads' outputs, cast to
// bf16, over their columns of a [64, H*D] tile of 64-column panels swizzled
// by 128 bytes, gathers the other groups' columns from their blocks' shared
// memory, and computes its C / G columns of att @ Wo^T + bo on wgmma while
// Wo's 32-column panels stream through its ring.
constexpr int ATT_ROWS = 64;                 // query rows of a block
constexpr int ATT_THREADS = 128;             // one warpgroup
constexpr int ATT_PANEL = ATT_ROWS * 128;    // a 64-column panel of the tile
constexpr int WO_COLS = 32;                  // Wo columns (reduction) a panel

// byte offset of channel col (a multiple of 8) of row r in the tile
__device__ __forceinline__ uint32_t att_at(int r, int col) {
  return (col / 64) * ATT_PANEL + Swz<128>::at(r, (col % 64) / 8);
}

// the Wo panels that cover H*D columns, the last one cut at hd
__host__ __device__ constexpr int wo_panels(int hd) {
  return (hd + WO_COLS - 1) / WO_COLS;
}

// Zeros the tile's columns from hd to the end of the last Wo panel (16 where
// hd % 32 == 16): they meet the zeros of that panel's columns past hd, and
// shared memory never written may hold a NaN, which times 0 stays NaN.
__device__ __forceinline__ void zero_att_tail(uint32_t att, int hd, int t) {
  const int tail = (wo_panels(hd) * WO_COLS - hd) / 8;  // 16-byte chunks a row
  for (int i = t; i < ATT_ROWS * tail; i += ATT_THREADS)
    st_shared16(att + att_at(i / tail, hd + (i % tail) * 8),
                make_uint4(0u, 0u, 0u, 0u));
}

// Rows r0 .. r0 + ROWS - 1 of Wo [C, H*D] (rows at or past rows_valid
// zeros), the columns of Wo panel p (those at or past hd zeros), into a
// ring stage of 64-byte rows.
template <int ROWS>
__device__ __forceinline__ void load_wo_panel(uint32_t dst, const bf16* wo,
                                              int hd, int r0, int rows_valid,
                                              int p, int t) {
  load_tile_async<WO_COLS * 2, ROWS, ATT_THREADS>(
      dst, wo + static_cast<int64_t>(r0) * hd + p * WO_COLS, hd, rows_valid,
      t, hd - p * WO_COLS);
}

// Once every block of the cluster has parked its heads (group r's gcols
// 16-byte chunks of a row from column 8 r gcols), copies the other groups'
// columns into this block's tile through distributed shared memory. On
// return wgmma may read the whole tile. The block must end with
// cluster_wait(): no block leaves while another may still read it.
__device__ __forceinline__ void gather_head_groups(uint32_t att, int g,
                                                   int groups, int gcols,
                                                   int t) {
  cluster_arrive();
  cluster_wait();  // every block of the cluster has parked its heads
  for (int i = t; i < (groups - 1) * ATT_ROWS * gcols; i += ATT_THREADS) {
    const int rr = i / (ATT_ROWS * gcols);
    const int rank = rr < g ? rr : rr + 1;
    const int r = (i / gcols) % ATT_ROWS, col = (rank * gcols + i % gcols) * 8;
    const uint32_t at = att + att_at(r, col);
    st_shared16(at, ld_cluster16(map_rank(at, rank)));
  }
  fence_async_shared();
  cluster_arrive();  // done reading the other blocks (waited for at exit)
  __syncthreads();   // every gathered chunk is in place before wgmma
}

// out[row, c0 .. cend) = att @ Wo^T + bo for the block's rows (orow: its
// first row of out [.., c]; rows_left of them lie inside the sequence), in
// `passes` passes of NCH * 32 columns (the last may end past cend), each
// over the wo_panels(hd) Wo panels of its
// rows that take() waits for (returning the stage's address) and release()
// frees, in the ring's order. The tile's columns from hd to the end of the
// last panel must be zeros (zero_att_tail). NCH is a compile-time count, so
// that every wgmma sits on a path all threads take.
template <int NCH, typename Take, typename Release>
__device__ __forceinline__ void project_out(uint32_t att,
                                            const bf16* __restrict__ bo,
                                            bf16* __restrict__ orow, int c,
                                            int rows_left, int c0, int cend,
                                            int passes, int hd, Take take,
                                            Release release) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int kpanels = wo_panels(hd);
  for (int pass = 0; pass < passes; ++pass) {
    const int cp = c0 + pass * NCH * 32;
    float acc[NCH][16];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int x = 0; x < 16; ++x) acc[ch][x] = 0.f;
    for (int p = 0; p < kpanels; ++p) {
      const uint32_t sw = take();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WO_COLS / 16; ++kk) {
        const int acol = p * WO_COLS + 16 * kk;
        const uint64_t da =
            desc_k<128>(att + (acol / 64) * ATT_PANEL + (acol % 64) * 2);
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
          wgmma_ss<32, 0>(acc[ch], da,
                          desc_k<WO_COLS * 2>(sw + ch * 32 * WO_COLS * 2 +
                                              32 * kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) fence_regs(acc[ch]);
      release();
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = cp + ch * 32 + 8 * x + 2 * (lane & 3);
        if (col >= cend) continue;
        const float b0 = __bfloat162float(bo[col]);
        const float b1 = __bfloat162float(bo[col + 1]);
        if (r0 < rows_left)
          *reinterpret_cast<uint32_t*>(orow + static_cast<int64_t>(r0) * c +
                                       col) =
              pack2(acc[ch][4 * x] + b0, acc[ch][4 * x + 1] + b1);
        if (r0 + 8 < rows_left)
          *reinterpret_cast<uint32_t*>(
              orow + static_cast<int64_t>(r0 + 8) * c + col) =
              pack2(acc[ch][4 * x + 2] + b0, acc[ch][4 * x + 3] + b1);
      }
    }
  }
}

// Head groups of a cluster: the most, up to max_groups, that divide the
// heads and leave each block a multiple of `unit` output columns.
inline int head_groups(int heads, int c, int max_groups, int unit) {
  for (int g = max_groups; g > 1; --g)
    if (heads % g == 0 && c % (unit * g) == 0) return g;
  return 1;
}

// Launches kernel(args...) on `blocks` blocks of `threads` threads with
// smem bytes of dynamic shared memory, in clusters of `cluster` consecutive
// blocks. Returns the CUDA error of the launch (0 = launched).
template <typename... Params, typename... Args>
int launch_cluster_grid(void (*kernel)(Params...), int blocks, int threads,
                        int smem, int cluster, cudaStream_t stream,
                        Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The same on blocks of ATT_THREADS threads.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int blocks, int smem,
                    int cluster, cudaStream_t stream, Args... args) {
  return launch_cluster_grid(kernel, blocks, ATT_THREADS, smem, cluster,
                             stream, args...);
}

}  // namespace hopper
