// Hopper building blocks of the redesigned attention kernels
// (flash_attention_fproj.cu, flash_attention_bwd_packed.cu): shared-memory
// tiles in the swizzled layouts wgmma reads, the wgmma descriptors and
// instructions (bf16 in, fp32 accumulate), mbarriers, cp.async copies that
// complete on an mbarrier, and the cluster barrier and distributed
// shared-memory loads. Raw PTX, for sm_90a.
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
// valid_rows are zeros. The NTHREADS threads of the calling group (index t)
// share the chunks, the same count each (no divergent loop).
template <int ROWB, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                int64_t ld, int valid_rows,
                                                int t) {
  constexpr int CH = Swz<ROWB>::CHUNKS;
  static_assert(ROWS * CH % NTHREADS == 0, "chunks a thread");
#pragma unroll
  for (int k = 0; k < ROWS * CH / NTHREADS; ++k) {
    const int i = t + k * NTHREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid_rows;
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

// d[64 x 32] += A[64 x 16] B[16 x 32], A in registers (the warp's
// m16n8k16 A fragment of its 16 rows), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TRANS_B));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the warp's
// m16n8k16 A fragment of its 16 rows), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TRANS_B));
}
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d = 1) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss width");
  if constexpr (N == 32) wgmma_ss_n32<TRANS_B>(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_ss_n64<TRANS_B>(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_ss_n128<TRANS_B>(d, da, db, scale_d);
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 32 || N == 64, "wgmma_rs width");
  if constexpr (N == 32) wgmma_rs_n32<TRANS_B>(d, a, db);
  if constexpr (N == 64) wgmma_rs_n64<TRANS_B>(d, a, db);
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

}  // namespace hopper
