// Grouped expert GEMMs for the MoE FFN on the expert-aligned padded layout.
//
// Replaces (TPU, ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py):
//   ctdb_grouped_gateup  <- grouped_gateup_manual / _gateup_manual_kernel
//                           (and grouped_gateup_padded / _gmm_gateup_kernel)
//   ctdb_grouped_down    <- grouped_matmul_manual / _matmul_manual_kernel
//                           (and grouped_matmul_padded / _gmm_kernel)
//
// What it computes: x_padded [M_pad, K] holds the routed token rows, grouped
// so that every tile_m-row tile belongs to one expert, tile_expert[tile].
// gate/up: h = silu(x @ Wg[e]) * (x @ Wu[e]) with K = D, N = F.
// down:    out = h @ Wd[e]                   with K = F, N = D.
// Weights are [E, K, N] or layer-stacked [L, E, K, N]; the layer id picks
// the stack slice, as the TPU kernels' scalar-prefetched layer id did.
// Products run on bf16 tensor cores with f32 accumulators; the SiLU and the
// gate*up product run on the f32 accumulators before one bf16 store.
//
// Bound on an H100 SXM at the main path (M = 20480 routed rows, D 2048,
// F 896, 64 experts): gate/up moves ~0.6 GB (each used expert's two
// weight matrices once, x_padded once, h once), ~0.18 ms at 3.35 TB/s,
// against 150 GFLOP, ~0.15 ms at 989 TFLOP/s: memory-bound, close to the
// ridge.  The down projection is about half of each.
//
// Design: one block per (64-row tile, 128-wide column tile).  The block
// reads its tile's expert id itself and streams [64 x 32] x tiles and
// [32 x 128] weight tiles through a 3-stage cp.async ring in shared memory,
// multiplying them with WMMA bf16 16x16x16 fragments (4 warps, 32x64 each).
// For gate/up the 128 columns are 64 of Wg beside the same 64 of Wu, so the
// activation pairs live in one block.  Blocks of one expert run side by side
// and share its weights through L2; nothing is carried between blocks.
// What is left for later: TMA loads, wgmma, and a persistent schedule that
// streams each expert's weights from HBM exactly once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 64;
constexpr int BN = 128;   // output columns per block, summed over the weights
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int A_LD = BK + 8;   // padded leading dims (bank spread, 32B rows)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int EPI_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// NMAT = 2: gate/up (w0 = Wg, w1 = Wu, 64 columns of each per block).
// NMAT = 1: down (w0 = Wd, 128 columns per block).
template <int NMAT>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                    const bf16* __restrict__ w1, bf16* __restrict__ out,
                    const int* __restrict__ tile_expert, int K, int N,
                    int num_experts, int layer, int tile_m) {
  constexpr int WN = BN / NMAT;  // columns of each weight matrix per block
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue reuse

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 2;
  const int warp_n = warp % 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * WN;
  const int e = tile_expert[m0 / tile_m];
  const size_t w_off =
      (static_cast<size_t>(layer) * num_experts + e) * static_cast<size_t>(K) * N;
  const bf16* wa = w0 + w_off;
  const bf16* wb = (NMAT == 2 ? w1 : w0) + w_off;
  const bf16* xa = x + static_cast<size_t>(m0) * K;

  auto load_stage = [&](int stage, int k0) {
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8);
      const int kc = (c % (BK / 8)) * 8;
      const bool ok = k0 + kc < K;
      const bf16* src = ok ? xa + static_cast<size_t>(r) * K + k0 + kc : x;
      cp_async16(as + r * A_LD + kc, src, ok);
    }
#pragma unroll
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8);
      const int cc = (c % (BN / 8)) * 8;
      const int col = n0 + cc % WN;
      const bf16* wm = cc / WN == 0 ? wa : wb;
      const bool ok = k0 + r < K && col < N;
      const bf16* src = ok ? wm + static_cast<size_t>(k0 + r) * N + col : w0;
      cp_async16(bs + r * B_LD + cc, src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (K + BK - 1) / BK;
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

    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (warp_m * 32 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * B_LD + warp_n * 64 + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before Cs reuses it
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(
          Cs + (warp_m * 32 + i * 16) * C_LD + warp_n * 64 + j * 16, acc[i][j],
          C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * WN; idx += THREADS) {
    const int r = idx / WN;
    const int c = idx % WN;
    const int col = n0 + c;
    if (col >= N) continue;
    float v = Cs[r * C_LD + c];
    if (NMAT == 2) {
      const float u = Cs[r * C_LD + WN + c];
      v = v / (1.0f + expf(-v)) * u;  // silu(gate) * up, in f32
    }
    out[static_cast<size_t>(m0 + r) * N + col] = __float2bfloat16(v);
  }
}

}  // namespace

extern "C" {

// h [m_pad, f] = silu(x @ wg[layer, e]) * (x @ wu[layer, e]); x [m_pad, d].
int ctdb_grouped_gateup(const void* x, const void* wg, const void* wu, void* h,
                        const int* tile_expert, int m_pad, int d, int f,
                        int num_experts, int layer, int tile_m, void* stream) {
  dim3 grid((f + BN / 2 - 1) / (BN / 2), m_pad / BM);
  grouped_gemm_kernel<2><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<bf16*>(h), tile_expert, d, f,
      num_experts, layer, tile_m);
  return static_cast<int>(cudaGetLastError());
}

// out [m_pad, d] = h @ wd[layer, e]; h [m_pad, f].
int ctdb_grouped_down(const void* h, const void* wd, void* out,
                      const int* tile_expert, int m_pad, int f, int d,
                      int num_experts, int layer, int tile_m, void* stream) {
  dim3 grid((d + BN - 1) / BN, m_pad / BM);
  grouped_gemm_kernel<1><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wd),
      static_cast<const bf16*>(wd), static_cast<bf16*>(out), tile_expert, f, d,
      num_experts, layer, tile_m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
