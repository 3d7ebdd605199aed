// Fused expert FFN for the MoE block on the expert-aligned padded layout:
// gate, up, SiLU and down in one kernel, h kept in shared memory.
//
// Replaces (TPU): ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py
//   grouped_ffn_fused_padded / _fused_ffn_kernel, the opt-in
//   (CTDB_GROUPED_FUSED=1) megakernel of grouped_expert_ffn_pallas for
//   bf16/f32 weights with D and F multiples of 128.  Its NSLOTS weight-DMA
//   schedule (_run_schedule) hides TPU DMA latency and has no counterpart.
//
// What it computes: x_padded [M_pad, D] holds the routed token rows, grouped
// so that every tile_m-row tile belongs to one expert, tile_expert[tile]:
//   h   = bf16(silu(x @ Wg[e]) * (x @ Wu[e]))   [rows, F], f32 products,
//         rounded once, as the reference's .astype(x.dtype)
//   out = bf16(h @ Wd[e])                        [rows, D], f32 product
// Weights are [E, D, F] / [E, F, D] or layer-stacked [L, E, ...]; the layer
// id picks the stack slice.  Padding rows (copies of token 0) are computed
// like any row; the combine gives them weight 0.
//
// Bound on an H100 SXM at the single-prompt chat shape (llada-moe-7b, B 1,
// S 512: 4096 routed rows, m_pad 8192, D 2048, F 896): each used expert's
// three matrices are read once, 11 MB an expert (705 MB if all 64 are
// used), against 4096 rows of x and out (34 MB): at most ~0.22 ms at
// 3.35 TB/s; the 45 GFLOP take ~0.05 ms at 989 TFLOP/s.  Bytes bound: the
// point of the fusion is that h never reaches device memory, which saves
// its write and its read.
//
// Design: one block of 8 warps per 64-row tile (one expert's rows).
//   1. h: for each 64-column chunk of F, a [64 x 128] product of x with the
//      chunk of Wg beside the same chunk of Wu, over D in 32-deep steps
//      through a 4-stage cp.async ring; WMMA bf16 fragments (each warp
//      32 x 32), f32 accumulators staged through shared memory for the
//      SiLU, written as bf16 into the block's h tile in shared memory.
//      At F = 896 that tile is 64 x 904 bf16 = 113 KB: dynamic shared
//      memory (cudaFuncSetAttribute), 167 KB per block with the ring.
//   2. out: for each 128-column chunk of D, the product of h, read in place
//      from shared memory, with Wd's chunk streamed through the same ring.
// Blocks of one expert run side by side and share its weights through L2.
// The largest F whose h tile fits the 227 KB a block may have is 1376
// (1280 for F % 128 == 0); the wrapper refuses larger ones.  What is left
// for later: TMA and wgmma, a persistent per-expert schedule that reads each
// expert's weights from device memory exactly once, more than one block per
// SM at short F.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 64;   // rows per block: one row tile of one expert
constexpr int BN = 128;  // output columns per pass: 64 gate + 64 up, or 128 of D
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int RING_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int EPI_BYTES = BM * C_LD * 4;
// The ring, reused as the f32 staging tile between passes; h follows it.
constexpr int WORK_BYTES = RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES;
static_assert(WORK_BYTES % 128 == 0, "h tile alignment");

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc = A [64, K] @ B [K, 128].  A is 64 rows of x (row stride K, streamed
// through the ring) or, with A_IN_SMEM, the h tile already in shared memory
// (leading dim lda).  B's 128 columns are w0's columns n0 .. n0 + WN - 1
// beside w1's same columns (WN 64: gate/up), or w0's n0 .. n0 + 127 (WN 128:
// down).  K % BK == 0 and every column exists: the wrapper checks D and F.
// Ends with the ring drained and every warp past a barrier.
template <bool A_IN_SMEM, int WN>
__device__ __forceinline__ void tile_product(Acc (&acc)[2][2], unsigned char* ring,
                                             const bf16* a, int lda,
                                             const bf16* __restrict__ w0,
                                             const bf16* __restrict__ w1, int K,
                                             int N, int n0) {
  bf16* As = reinterpret_cast<bf16*>(ring);
  bf16* Bs = As + STAGES * A_STAGE;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;

  auto load_stage = [&](int stage, int k0) {
    if (!A_IN_SMEM) {
      bf16* as = As + stage * A_STAGE;
      for (int c = tid; c < BM * BK / 8; c += THREADS) {
        const int r = c / (BK / 8);
        const int kc = (c % (BK / 8)) * 8;
        cp_async16(as + r * A_LD + kc, a + static_cast<size_t>(r) * lda + k0 + kc);
      }
    }
    bf16* bs = Bs + stage * B_STAGE;
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8);
      const int cc = (c % (BN / 8)) * 8;
      const bf16* wm = cc < WN ? w0 : w1;
      cp_async16(bs + r * B_LD + cc,
                 wm + static_cast<size_t>(k0 + r) * N + n0 + cc % WN);
    }
  };

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;  // refill the stage consumed at kt - 1
    if (nk < ktiles) load_stage(nk % STAGES, nk * BK);
    cp_async_commit();

    const bf16* as = A_IN_SMEM ? a + kt * BK : As + (kt % STAGES) * A_STAGE;
    const int a_ld = A_IN_SMEM ? lda : A_LD;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], as + (warp_m * 32 + i * 16) * a_ld + kk, a_ld);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * B_LD + warp_n * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before it is reused
}

// Stage this warp's accumulators into the f32 tile Cs [64, C_LD].
__device__ __forceinline__ void stage(Acc (&acc)[2][2], float* Cs) {
  const int warp = threadIdx.x / 32;
  const int warp_m = warp / 4;
  const int warp_n = warp % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (warp_m * 32 + i * 16) * C_LD + warp_n * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
grouped_ffn_fused_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                         const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                         bf16* __restrict__ out, const int* __restrict__ tile_expert,
                         int D, int F, int num_experts, int layer, int tile_m) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* Cs = reinterpret_cast<float*>(smem);
  bf16* Hs = reinterpret_cast<bf16*>(smem + WORK_BYTES);
  const int ldh = F + 8;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int e = tile_expert[m0 / tile_m];
  // Wg, Wu [D, F] and Wd [F, D]: the same element count per expert.
  const size_t w_off =
      (static_cast<size_t>(layer) * num_experts + e) * static_cast<size_t>(D) * F;
  const bf16* xt = x + static_cast<size_t>(m0) * D;
  Acc acc[2][2];

  // 1. h = silu(x Wg) * (x Wu), 64 columns of F per pass.
  for (int f0 = 0; f0 < F; f0 += BN / 2) {
    tile_product<false, BN / 2>(acc, ring, xt, D, wg + w_off, wu + w_off, D, F, f0);
    stage(acc, Cs);
    for (int idx = tid; idx < BM * (BN / 2); idx += THREADS) {
      const int r = idx / (BN / 2);
      const int c = idx % (BN / 2);
      const float g = Cs[r * C_LD + c];
      const float u = Cs[r * C_LD + BN / 2 + c];
      Hs[r * ldh + f0 + c] = __float2bfloat16(g / (1.0f + expf(-g)) * u);
    }
    __syncthreads();  // Cs (the ring) is read before the next pass refills it
  }

  // 2. out = h Wd, 128 columns of D per pass, h read in place.
  for (int n0 = 0; n0 < D; n0 += BN) {
    tile_product<true, BN>(acc, ring, Hs, ldh, wd + w_off, wd + w_off, F, D, n0);
    stage(acc, Cs);
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN;
      const int c = idx % BN;
      out[static_cast<size_t>(m0 + r) * D + n0 + c] = __float2bfloat16(Cs[r * C_LD + c]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// out [m_pad, d] = bf16(bf16(silu(x @ wg[layer, e]) * (x @ wu[layer, e])) @
// wd[layer, e]) per 64-row block; x [m_pad, d]; d, f multiples of 128.
int ctdb_grouped_ffn_fused(const void* x, const void* wg, const void* wu,
                           const void* wd, void* out, const int* tile_expert,
                           int m_pad, int d, int f, int num_experts, int layer,
                           int tile_m, void* stream) {
  if (d % BN != 0 || f % BN != 0 || m_pad % BM != 0 || tile_m % BM != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The ring, then the h tile (ops/grouped_gemm_cuda.py::fused_smem_bytes).
  const int bytes = WORK_BYTES + BM * (f + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_ffn_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_ffn_fused_kernel<<<m_pad / BM, THREADS, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
      static_cast<bf16*>(out), tile_expert, d, f, num_experts, layer, tile_m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
