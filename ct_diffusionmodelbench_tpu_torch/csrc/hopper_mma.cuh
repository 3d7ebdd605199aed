// Hopper building blocks shared by the wgmma kernels (flash_attention.cu:
// the forward; flash_attention_bwd.cu: dq and dk/dv; grouped_gemm.cu: the
// bf16 grouped expert GEMMs; grouped_gemm_q.cu: the int8 grouped expert
// GEMMs; grouped_ffn_fused.cu: the fused expert FFN).
//
// - cp.async copies from device memory into shared memory, 16 bytes (or 4)
//   per thread, zero-filling rows past the sequence end;
// - TMA loads (cp.async.bulk.tensor, 2-D and 3-D, one thread for a whole
//   box) that report their bytes to an mbarrier, the mbarrier operations of
//   a producer / consumer ring, and setmaxnreg for warp specialisation;
// - the canonical swizzled layout of a bf16 [ROWS, Dh] tile that wgmma
//   reads, and the matrix descriptors that name it: one layout serves as a
//   K-major operand (Q, K as the A / B of Q K^T) and as an MN-major one (V as
//   the B of P V; a weight tile W[k, n] as the A of W^T x^T), so every tile
//   is stored the same way; a TMA box of 64 bf16 columns with the 128-byte
//   swizzle lands in exactly this layout;
// - the wgmma instructions the kernels issue, with their fence / commit /
//   wait and the register fences that keep the compiler from touching an
//   operand while an asynchronous wgmma still owns it;
// - thread block clusters: the cluster barrier, a CTA's rank, and stores
//   into another CTA's shared memory (distributed shared memory);
// - rotate-half RoPE rounded as PyTorch's separate elementwise ops round it;
// - for the grouped GEMMs, which compute a transposed output tile
//   out^T = W^T x^T (the weight as the 64-row A operand, the rows of x as
//   N): the copy of 64 or 128 rows of x, 64 values deep, into a K-major B
//   tile, and the epilogue that stages such a transposed tile in shared
//   memory and writes it back as 16-byte rows;
// - on the host: the CUtensorMaps that name TMA boxes, encoded through the
//   runtime's driver entry-point query (so nothing links the driver
//   library), and a cache of the expert weights' maps.
//
// Layout.  A tile has ROWS rows (64; 128 for the grouped GEMMs' B tile),
// each Dh * 2 bytes.  A row is cut into column blocks
// of SW = min(Dh * 2, 128) bytes (the 128 B, 64 B or 32 B swizzle mode:
// Dh 128 takes two 128 B blocks, Dh 64 one, Dh 32 one 64 B block, Dh 16 one
// 32 B block); block b holds the SW-byte slice of all ROWS rows, row after
// row, and inside a block the 16-byte chunk c of row r sits at chunk
// c ^ f(r), f(r) = r % 8 (128 B), (r / 2) % 4 (64 B), (r / 4) % 2 (32 B).
// That is the address swizzle wgmma applies to bits 4-6 of an address from
// bits 7-9, so every tile starts at a multiple of 1024 bytes.
//
// Descriptors (PTX ISA, "matrix descriptor"): start address / 16 in bits
// 0-13, leading byte offset / 16 in 16-29, stride byte offset / 16 in 32-45,
// swizzle mode in 62-63 (1: 128 B, 2: 64 B, 3: 32 B).
// - K-major (rows are M or N, columns the reduction dim K): the stride byte
//   offset steps 8 rows (8 * SW); the leading offset is unused when
//   swizzled; k-step kk (16 columns, 32 bytes) starts 32 * kk bytes into the
//   row, in the column block that holds it.
// - MN-major (rows are K, columns N): the stride byte offset steps 8 rows
//   of K (8 * SW), the leading byte offset steps to the next SW-byte column
//   block of N (ROWS * SW); k-step kk starts 16 rows further down.
// wgmma reads an A operand from registers with B in either major
// (imm-trans-b 1: MN-major, 0: K-major), or both from shared memory, where
// A too may be MN-major (imm-trans-a 1) for 16-bit types.
//
// Register layouts (wgmma m64nNk16, per warp w of the warpgroup, lane =
// 4 * g + t): accumulator element d[4 i + 2 h + e] is row 16 w + g + 8 h,
// column 8 i + 2 t + e; the A fragment of k-step kk from registers holds
// A[16 w + g + 8 h][16 kk + 8 u + 2 t + e] in bf16 half e of register
// 2 u + h.  So an f32 accumulator over 64 columns becomes the A operand of
// the next product over those columns pair by pair: register j of k-step kk
// packs d[8 kk + 2 j] and d[8 kk + 2 j + 1].

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace ctdb {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, asynchronously; with
// `valid` false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// As cp_async16, for one 4-byte word (rows of f32 vectors that need not be
// 16-byte aligned).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes (stores and completed cp.async
// copies) visible to wgmma, which reads shared memory through the async
// proxy; a barrier after it publishes them to the other threads' wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers (id 1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// mbarriers (8 bytes of shared memory each).  A phase completes when the
// expected arrivals have arrived and the expected transaction bytes (TMA
// copies) have landed; waiters name the parity of the phase they wait for.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals)
               : "memory");
}
// After mbar_init and before a barrier that publishes it to the block: makes
// the initialised barriers visible to the async proxy (TMA) too.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival that also expects `bytes` more transaction bytes this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Spin until the phase of parity `parity` has completed (on a fresh barrier
// parity 1 counts as completed, so a producer's first wait on an empty
// stage passes).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box at coordinates (c0 innermost, c1[, c2]) of the tensor map at
// `map` (a __grid_constant__ kernel parameter) into shared memory at dst,
// its bytes reported to the mbarrier bar; elements outside the tensor are
// zero-filled.  With the 128-byte swizzle and a 1024-byte aligned dst, a box
// of 64 bf16 columns lands as SwTile<64, ROWS>.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Thread block clusters.  The barrier counts every thread of the cluster
// that has not exited; each thread alternates arrive and wait.  arrive
// releases this thread's earlier writes (to any CTA's shared memory) to the
// threads that return from the matching wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The address in CTA `rank`'s shared memory of this CTA's shared address
// `addr` (both CTAs lay their shared memory out alike).
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// 16 bytes into the shared memory of a CTA of the cluster (an address from
// cluster_map).
__device__ __forceinline__ void st_cluster16(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// Orders this thread's shared-memory writes, to any CTA of the cluster,
// before later reads through the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}

// Warp specialisation: every warp of a warpgroup lowers (a producer) or
// raises (a consumer) its register budget to N together.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

// A [ROWS, DH] bf16 tile in the canonical swizzled layout (see the top).
template <int DH, int ROWS = 64>
struct SwTile {
  static_assert(ROWS % 8 == 0, "8-row core matrices");
  static constexpr int SW = DH * 2 < 128 ? DH * 2 : 128;  // bytes per swizzled row
  static constexpr int CPB = SW / 16;                      // 16-byte chunks in it
  static constexpr int BLOCK = ROWS * SW;                  // one column block
  static constexpr int BYTES = ROWS * DH * 2;
  static constexpr uint64_t MODE = SW == 128 ? 1 : (SW == 64 ? 2 : 3);

  // Byte offset of chunk c (elements 8c .. 8c + 7) of row r.
  __device__ static __forceinline__ uint32_t chunk(int r, int c) {
    const int f = SW == 128 ? (r & 7) : (SW == 64 ? ((r >> 1) & 3) : ((r >> 2) & 1));
    return (c / CPB) * BLOCK + r * SW + (((c % CPB) ^ f) << 4);
  }
  // k-step kk of the tile at `base` as a K-major operand.
  __device__ static __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    return smem_desc(base + (kk * 32 / SW) * BLOCK + (kk * 32) % SW, 16, 8 * SW, MODE);
  }
  // k-step kk of the tile at `base` as an MN-major operand.
  __device__ static __forceinline__ uint64_t mn_major(uint32_t base, int kk) {
    return smem_desc(base + kk * 16 * SW, BLOCK, 8 * SW, MODE);
  }
};

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

// Tie registers to this point of the instruction order: placed after a
// wgmma wait, no read of an accumulator moves above the wait, and no
// register of an A operand is reused before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rotate-half RoPE of 8 pairs: lo holds x1 = x[d .. d + 7], hi holds
// x2 = x[d + Dh/2 .. d + Dh/2 + 7]; becomes x1 c - x2 s, x2 c + x1 s with
// every product and sum rounded on its own, as PyTorch's ops round them.
__device__ __forceinline__ void rope8(uint4& lo, uint4& hi, const float* c, const float* s) {
  const bf16* x1 = reinterpret_cast<const bf16*>(&lo);
  const bf16* x2 = reinterpret_cast<const bf16*>(&hi);
  uint4 o1, o2;
  bf16* y1 = reinterpret_cast<bf16*>(&o1);
  bf16* y2 = reinterpret_cast<bf16*>(&o2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = __bfloat162float(x1[j]);
    const float b = __bfloat162float(x2[j]);
    y1[j] = __float2bfloat16(__fsub_rn(__fmul_rn(a, c[j]), __fmul_rn(b, s[j])));
    y2[j] = __float2bfloat16(__fadd_rn(__fmul_rn(b, c[j]), __fmul_rn(a, s[j])));
  }
  lo = o1;
  hi = o2;
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16]; A in registers, B in shared memory
// (TRANS_B 1: MN-major, 0: K-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]; A in registers, B in shared memory
// (TRANS_B 1: MN-major, 0: K-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A in registers, B in shared memory
// (TRANS_B 1: MN-major, 0: K-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]; A in registers, B in shared memory
// (TRANS_B 1: MN-major, 0: K-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A in registers, B MN-major (the
// default) or, with TRANS_B 0, K-major.
template <int N, int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma width");
  static_assert(TRANS_B == 0 || TRANS_B == 1, "imm-trans-b");
  if constexpr (N == 16) wgmma_rs_m64n16<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (N == 32) wgmma_rs_m64n32<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_rs_m64n64<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_rs_m64n128<TRANS_B>(d, a, desc_b, scale_d);
}


// D[64 x N] (+)= A[64 x 16] B[16 x N], both in shared memory; B K-major, A
// K-major (TRANS_A 0) or MN-major (TRANS_A 1: A^T's rows are K, e.g. a
// weight tile W[k, n] read as the A of W^T x^T).
template <int TRANS_A>
__device__ __forceinline__ void wgmma_ss_m64n64_a(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A));
}

template <int TRANS_A>
__device__ __forceinline__ void wgmma_ss_m64n128_a(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A));
}

template <int N, int TRANS_A>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma width");
  static_assert(TRANS_A == 0 || TRANS_A == 1, "imm-trans-a");
  if constexpr (N == 64) wgmma_ss_m64n64_a<TRANS_A>(d, desc_a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_ss_m64n128_a<TRANS_A>(d, desc_a, desc_b, scale_d);
}

// ---------------------------------------------------------------------------
// Transposed tiles of the grouped GEMMs (out^T = W^T x^T: x rows as N)
// ---------------------------------------------------------------------------

// Rows [0, ROWS) of x (row stride ld), values [k0, k0 + 64), into the K-major
// swizzled tile SwTile<64, ROWS> at dst: one cp.async of 16 bytes per 8
// values, THREADS threads sharing them; values >= K are zero-filled (K % 8
// == 0).  Rows of x are K-contiguous in device memory, so this is the B tile
// of out^T as it lies there.
template <int ROWS, int THREADS>
__device__ __forceinline__ void issue_kmajor_rows(uint32_t dst, const bf16* x, size_t ld,
                                                  int k0, int K, int tid) {
  using Tile = SwTile<64, ROWS>;
  static_assert(ROWS * 8 % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int p = tid + i * THREADS;
    const int r = p / 8;
    const int c = p % 8;
    const bool ok = k0 + 8 * c < K;
    cp_async16(dst + Tile::chunk(r, c), ok ? x + r * ld + k0 + 8 * c : x, ok);
  }
}

// A [ROWS, COLS] bf16 output tile staged in shared memory on its way out.
// The accumulators of out^T hold, per thread, column pairs of rows of out
// that lie 2 apart (row 8 i + 2 t + e of thread t of a quad), so each pair
// goes to shared memory as one 4-byte word, and the tile leaves as 16-byte
// row chunks.  Rows are padded by 16 bytes: the four rows a quad writes at
// once then fall in four different 8-bank groups.
template <int ROWS, int COLS>
struct StagedTile {
  static_assert(COLS % 64 == 0, "the bank spread assumes 128-byte rows");
  static constexpr int PITCH = COLS * 2 + 16;
  static constexpr int BYTES = ROWS * PITCH;

  // bf16 pair (col, col + 1) of row `row`.
  __device__ static __forceinline__ void put(unsigned char* base, int row, int col,
                                             uint32_t pair) {
    *reinterpret_cast<uint32_t*>(base + row * PITCH + col * 2) = pair;
  }
  // One bf16 value of row `row`, column `col`.
  __device__ static __forceinline__ void put_one(unsigned char* base, int row, int col,
                                                 bf16 v) {
    *reinterpret_cast<bf16*>(base + row * PITCH + col * 2) = v;
  }
  // Rows [0, ROWS) to out[row0 + r][col0 + c] (row stride ldo) for the
  // columns below n; col0 and n are multiples of 8.
  template <int THREADS>
  __device__ static __forceinline__ void store(const unsigned char* base, bf16* out,
                                               size_t ldo, size_t row0, int col0, int n,
                                               int tid) {
    constexpr int CPR = COLS / 8;
    for (int p = tid; p < ROWS * CPR; p += THREADS) {
      const int r = p / CPR;
      const int c = p % CPR;
      const int col = col0 + 8 * c;
      if (col < n)
        *reinterpret_cast<uint4*>(out + (row0 + r) * ldo + col) =
            *reinterpret_cast<const uint4*>(base + r * PITCH + 16 * c);
    }
  }
  // Zeros to the same ROWS x COLS window of out.
  template <int THREADS>
  __device__ static __forceinline__ void zero(bf16* out, size_t ldo, size_t row0, int col0,
                                              int n, int tid) {
    constexpr int CPR = COLS / 8;
    for (int p = tid; p < ROWS * CPR; p += THREADS) {
      const int col = col0 + 8 * (p % CPR);
      if (col < n)
        *reinterpret_cast<uint4*>(out + (row0 + p / CPR) * ldo + col) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// ---------------------------------------------------------------------------
// Host: tensor maps for TMA
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The swizzle mode whose span is `bytes` (the SW of an SwTile); none for
// any other width.
inline CUtensorMapSwizzle swizzle_mode(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                    : bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                  : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// A map of rank 1 to 3 (dims innermost first, strides in bytes of dims 1..)
// read in boxes of `box`; elements outside the tensor read as zeros.  L2
// fills 128-byte lines (a box row of the grouped GEMMs is 128 bytes;
// 256-byte promotion measured a few percent slower there).  Returns 0 or a
// cudaError_t code.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                      cuuint32_t rank, const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      fn(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A bf16 map read in boxes of 64 columns (128 bytes, the 128-byte swizzle):
// each box lands as an SwTile<64, rows>.
inline int encode_bf16_map(CUtensorMap* map, const void* base, cuuint32_t rank,
                           const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The 3-D map [L * E, K, N] of a bf16 expert weight tensor, read in boxes
// of 64 columns by 64 k rows (each box an MN-major SwTile<64, 64>), cached
// by (pointer, shape): a map holds nothing else, so a cached one is right
// for as long as the same pointer names a tensor of the same shape.
inline int weight_map(CUtensorMap* map, const void* w, uint64_t le, uint64_t k, uint64_t n) {
  struct Cached {
    const void* ptr;
    uint64_t le, k, n;
    CUtensorMap map;
  };
  constexpr int SLOTS = 32;
  static std::mutex mutex;
  static Cached cache[SLOTS];
  static int next = 0;
  std::lock_guard<std::mutex> lock(mutex);
  for (const Cached& c : cache)
    if (c.ptr == w && c.le == le && c.k == k && c.n == n) {
      *map = c.map;
      return 0;
    }
  const cuuint64_t dims[3] = {n, k, le};
  const cuuint64_t strides[2] = {n * 2, k * n * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const int err = encode_bf16_map(map, w, 3, dims, strides, box);
  if (err) return err;
  cache[next] = Cached{w, le, k, n, *map};
  next = (next + 1) % SLOTS;
  return 0;
}

}  // namespace ctdb
