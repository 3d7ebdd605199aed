// Grouped expert GEMMs with int8 weight-only experts (serving quantization).
//
// Replaces (TPU, ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py):
//   ctdb_grouped_gateup_q  <- grouped_gateup_manual_q / _gateup_manual_q_kernel
//   ctdb_grouped_down_q    <- grouped_matmul_manual_q / _matmul_manual_q_kernel
//
// What it computes, on the expert-aligned padded layout of grouped_gemm.cu
// (every tile_m-row tile of x_padded [M_pad, K] belongs to one expert,
// tile_expert[tile]):
//   gate/up: h = silu((x @ qg[e]) * sg[e]) * ((x @ qu[e]) * su[e]), K = D, N = F
//   down:    out = (h @ qd[e]) * sd[e],                                K = F, N = D
// q is int8 [E, K, N] or layer-stacked [L, E, K, N]; s is f32 [E, N] or
// [L, E, N], indexed by layer * E + e.  int8 values (|q| <= 127) are exact in
// bf16, so the products run on bf16 tensor cores with f32 accumulators, and
// the per-column scale multiplies the f32 accumulator in the epilogue: before
// the SiLU for gate/up, before the bf16 store for down.  This is the same
// (x @ q) * s as ops/quant.py::qdot and the TPU kernels' run-start cast with
// an accumulator-epilogue scale.
//
// Bound on an H100 SXM at the main path (M = 20480 routed rows, D 2048,
// F 896, 64 experts): gate/up moves ~0.36 GB (the used experts' two int8
// matrices once, x and h once), ~0.11 ms at 3.35 TB/s, against 150 GFLOP,
// ~0.15 ms at 989 TFLOP/s: bound by operations.  Down: 0.24 GB / 0.07 ms
// against 75 GFLOP / 0.076 ms.  int8 halves the weight bytes of the bf16
// pair; the products stay bf16, because int8 x int8 would need activations
// quantized too, which the reference does not do.
//
// Design: grouped_gemm.cu's, one block per (64-row tile, 128-column tile),
// 4 warps of WMMA bf16 16x16x16 fragments (32x64 each), a 3-stage cp.async
// ring.  The ring carries the weight tile as int8: a [32 x 128] tile is
// 4 KB, half of the bf16 pair's, 16 weights per 16-byte cp.async (so N must
// be a multiple of 16).  Each k-step widens its int8 stage to one bf16
// working tile in shared memory (a register round trip per 16 weights, after
// the ring barrier), and the fragments read that tile.  The tile-to-expert
// map and the layer offset are the bf16 pair's.  Left for later: TMA, wgmma
// reading int8 through registers, a persistent per-expert schedule.

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
constexpr int A_LD = BK + 8;    // bf16 x tile (padded: bank spread, 32 B rows)
constexpr int Q_LD = BN + 16;   // int8 weight tile; rows stay 16-byte aligned
constexpr int B_LD = BN + 8;    // bf16 working copy of the weight tile
constexpr int C_LD = BN + 4;
constexpr int A_STAGE = BM * A_LD;   // bf16 elements
constexpr int Q_STAGE = BK * Q_LD;   // bytes
constexpr int A_BYTES = STAGES * A_STAGE * 2;
constexpr int Q_BYTES = STAGES * Q_STAGE;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int PIPE_BYTES = A_BYTES + Q_BYTES + B_BYTES;
constexpr int EPI_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");
static_assert(A_BYTES % 32 == 0 && (A_BYTES + Q_BYTES) % 32 == 0,
              "WMMA tiles need 32-byte aligned bases");

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

// Bytes [shift/8] and [shift/8 + 1] of v (int8) as two bf16, low address
// first.  Exact: every int8 value is a bf16.
__device__ __forceinline__ uint32_t widen2(int v, int shift) {
  const float lo = static_cast<float>(static_cast<int8_t>(v >> shift));
  const float hi = static_cast<float>(static_cast<int8_t>(v >> (shift + 8)));
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint4 widen_lo(int a, int b) {
  return make_uint4(widen2(a, 0), widen2(a, 16), widen2(b, 0), widen2(b, 16));
}

// NMAT = 2: gate/up (q0 = qg, q1 = qu, 64 columns of each per block).
// NMAT = 1: down (q0 = qd, 128 columns per block).
template <int NMAT>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_q_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q0,
                      const int8_t* __restrict__ q1, const float* __restrict__ s0,
                      const float* __restrict__ s1, bf16* __restrict__ out,
                      const int* __restrict__ tile_expert, int K, int N,
                      int num_experts, int layer, int tile_m) {
  constexpr int WN = BN / NMAT;  // columns of each weight matrix per block
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  int8_t* Qs = reinterpret_cast<int8_t*>(smem + A_BYTES);
  bf16* Bs = reinterpret_cast<bf16*>(smem + A_BYTES + Q_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue reuse

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 2;
  const int warp_n = warp % 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * WN;
  const int e = tile_expert[m0 / tile_m];
  const size_t le = static_cast<size_t>(layer) * num_experts + e;
  const size_t w_off = le * static_cast<size_t>(K) * N;
  const int8_t* wa = q0 + w_off;
  const int8_t* wb = (NMAT == 2 ? q1 : q0) + w_off;
  const float* sa = s0 + le * N;
  const float* sb = (NMAT == 2 ? s1 : s0) + le * N;
  const bf16* xa = x + static_cast<size_t>(m0) * K;

  auto load_stage = [&](int stage, int k0) {
    bf16* as = As + stage * A_STAGE;
    int8_t* qs = Qs + stage * Q_STAGE;
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8);
      const int kc = (c % (BK / 8)) * 8;
      const bool ok = k0 + kc < K;
      const bf16* src = ok ? xa + static_cast<size_t>(r) * K + k0 + kc : x;
      cp_async16(as + r * A_LD + kc, src, ok);
    }
#pragma unroll
    for (int c = tid; c < BK * BN / 16; c += THREADS) {
      const int r = c / (BN / 16);
      const int cc = (c % (BN / 16)) * 16;
      const int col = n0 + cc % WN;
      const int8_t* wm = cc / WN == 0 ? wa : wb;
      const bool ok = k0 + r < K && col < N;
      const int8_t* src = ok ? wm + static_cast<size_t>(k0 + r) * N + col : q0;
      cp_async16(qs + r * Q_LD + cc, src, ok);
    }
  };

  // int8 stage -> the bf16 working tile, 16 weights per thread and step.
  auto widen_stage = [&](int stage) {
    const int8_t* qs = Qs + stage * Q_STAGE;
#pragma unroll
    for (int c = tid; c < BK * BN / 16; c += THREADS) {
      const int r = c / (BN / 16);
      const int cc = (c % (BN / 16)) * 16;
      const int4 raw = *reinterpret_cast<const int4*>(qs + r * Q_LD + cc);
      uint4* dst = reinterpret_cast<uint4*>(Bs + r * B_LD + cc);
      dst[0] = widen_lo(raw.x, raw.y);
      dst[1] = widen_lo(raw.z, raw.w);
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
    __syncthreads();  // stage kt landed; every warp is done with step kt - 1
    const int nk = kt + STAGES - 1;  // refill the stage consumed at kt - 1
    if (nk < ktiles) load_stage(nk % STAGES, nk * BK);
    cp_async_commit();
    widen_stage(kt % STAGES);
    __syncthreads();

    const bf16* as = As + (kt % STAGES) * A_STAGE;
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
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + warp_n * 64 + j * 16,
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
    float v = Cs[r * C_LD + c] * sa[col];
    if (NMAT == 2) {
      const float u = Cs[r * C_LD + WN + c] * sb[col];
      v = v / (1.0f + expf(-v)) * u;  // silu(gate) * up, in f32
    }
    out[static_cast<size_t>(m0 + r) * N + col] = __float2bfloat16(v);
  }
}

}  // namespace

extern "C" {

// h [m_pad, f] = silu((x @ qg[layer, e]) * sg[layer, e])
//                * ((x @ qu[layer, e]) * su[layer, e]); x [m_pad, d].
int ctdb_grouped_gateup_q(const void* x, const void* qg, const void* qu,
                          const void* sg, const void* su, void* h,
                          const int* tile_expert, int m_pad, int d, int f,
                          int num_experts, int layer, int tile_m, void* stream) {
  dim3 grid((f + BN / 2 - 1) / (BN / 2), m_pad / BM);
  grouped_gemm_q_kernel<2><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(qg),
      static_cast<const int8_t*>(qu), static_cast<const float*>(sg),
      static_cast<const float*>(su), static_cast<bf16*>(h), tile_expert, d, f,
      num_experts, layer, tile_m);
  return static_cast<int>(cudaGetLastError());
}

// out [m_pad, d] = (h @ qd[layer, e]) * sd[layer, e]; h [m_pad, f].
int ctdb_grouped_down_q(const void* h, const void* qd, const void* sd, void* out,
                        const int* tile_expert, int m_pad, int f, int d,
                        int num_experts, int layer, int tile_m, void* stream) {
  dim3 grid((d + BN - 1) / BN, m_pad / BM);
  grouped_gemm_q_kernel<1><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const int8_t*>(qd),
      static_cast<const int8_t*>(qd), static_cast<const float*>(sd),
      static_cast<const float*>(sd), static_cast<bf16*>(out), tile_expert, f, d,
      num_experts, layer, tile_m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
