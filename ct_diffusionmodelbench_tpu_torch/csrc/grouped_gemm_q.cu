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
// an accumulator-epilogue scale.  With a tile_valid vector ([M_pad / tile_m]
// int32; null: every tile valid), a tile whose entry is 0 holds no real row:
// its output rows are zeros and no product runs for it (the reference's
// pad-skip sentinel slot).
//
// Bound on an H100 SXM at the main path (M = 20480 routed rows, D 2048,
// F 896, 64 experts): gate/up moves ~0.36 GB (the used experts' two int8
// matrices once, x and h once), ~0.11 ms at 3.35 TB/s, against 150 GFLOP,
// ~0.15 ms at 989 TFLOP/s: bound by operations.  Down: 0.24 GB / 0.07 ms
// against 75 GFLOP / 0.076 ms.  int8 halves the weight bytes of the bf16
// pair; the products stay bf16, because int8 x int8 would need activations
// quantized too, which the reference does not do.  So the design's work is
// to keep the tensor cores fed, with wgmma, while the weights are widened.
//
// Design (Hopper; hopper_mma.cuh has the layouts and instructions):
// - wgmma reads B from shared memory only; only A may come from registers.
//   So each warpgroup computes a transposed tile, out^T = W^T x^T: A is 64
//   weight columns (the wgmma M), widened from int8 in registers; B is the
//   64 or 128 rows of x (h for down) of the tile, K-major and swizzled in
//   shared memory as they lie in device memory (the wgmma N); the f32
//   accumulators hold out^T.
// - A block is two consumer warpgroups, each with two 64-column A slices:
//   gate and up of the same 64 columns of h (gate/up: the two accumulators
//   line up element for element, so silu(g sg) (u su) runs in registers), or
//   two neighbouring 64-column slices of out (down).  A block covers 128
//   columns of h or 256 of out.
// - A block takes the 64-row tiles 2y and 2y + 1: one m64n128k16 pass when
//   both belong to one expert (always at tile_m 128), else an m64n64k16 pass
//   for each (the tail of an odd-length run; or a zero fill for a tile that
//   tile_valid marks empty).  Column blocks vary fastest in the grid, so the
//   row tiles that read one expert's weight slice run close together in time
//   and share it in L2 (a layer's 235 MB of int8 gate/up weights do not fit
//   the 50 MB).
// - A 5-stage cp.async ring carries per 64-deep k-step the x tile (16 KB at
//   128 rows) and the int8 weight tile (64 rows of the block's 256 weight
//   columns, rows padded to 272 bytes so the 8 rows one ldmatrix phase reads
//   fall in 8 different bank groups): 33 KB a stage, three stages in flight,
//   one __syncthreads per k-step.  The weights never pass through shared
//   memory as bf16: ldmatrix.x4.trans, on 16-bit pairs of int8, hands a
//   thread per k16 step and slice the bytes W[k][c], W[k][c + 1],
//   W[k + 1][c], W[k + 1][c + 1] of its column pair c = 16 w + 2 g, which is
//   what the A fragment wants (hopper_mma.cuh: A[16 w + g + 8 h][k] with k in
//   pairs): the order of the 64 columns inside a warpgroup is free, and
//   accumulator row 16 w + g + 8 h holds weight column 16 w + 2 g + h.  Each
//   byte widens exactly through the f32 magic number (0x4B0000xx after
//   ^ 0x80, minus 2^23 + 128: an int8 value's f32 has its low 16 bits zero,
//   so its bf16 is its upper half) and __byte_perm packs the k-pairs: 11
//   integer and float instructions per 4 weights.
// - Per k16 step each warpgroup issues its two RS wgmmas and waits only for
//   those of three steps before, so up to four steps' products are in
//   flight while the next A fragment widens, one register buffer per k16
//   step of a stage.  Per k16 step a block's four m64n128k16 products take
//   256 tensor-core clocks at the peak against ~112 clocks of integer
//   widening and 32 of ldmatrix.
// - Epilogue: each thread loads its columns' f32 scales once per pass; the
//   scaled (for gate/up, SiLU-gated) bf16 pairs are staged, transposed, in
//   the ring's shared memory and leave as 16-byte rows.
// - What holds it back (H100, PERF.md): the copies.  With the products
//   taken out the kernel keeps most of its time, without the widening it
//   is no faster, and the products add to the copies' time rather than
//   hide behind them.  Each block brings 32 KB from L2 per 64-deep step
//   for 4.2 MFLOP; TMA with multicast across a cluster, fed by a producer
//   warp, is the next step.
// Registers per thread at n128: 2 x 64 f32 accumulators and 4 x 2 x 4 A
// registers; __launch_bounds__(256, 1) allows 255, and chip_smoke.py prints
// ptxas's count and spills.  Shared memory: 5 x 33 KB, one block per SM.
// Deterministic: every output element is one block's in-order k loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace ctdb;

constexpr int NWG = 2;                    // consumer warpgroups per block
constexpr int THREADS = 128 * NWG;
constexpr int TILE_ROWS = 64;             // rows of the layout's smallest tile
constexpr int BK = 64;                    // k per ring stage
constexpr int KSTEPS = BK / 16;           // k16 wgmma steps per stage
constexpr int STAGES = 5;
constexpr int WCOLS = 128 * NWG;          // weight columns per block, all matrices
constexpr int W_PITCH = WCOLS + 16;       // bytes per weight-tile row
using XTile = SwTile<BK, 2 * TILE_ROWS>;  // the B tile: 128 rows of 64 values
constexpr int X_BYTES = XTile::BYTES;
constexpr int STAGE_BYTES = (X_BYTES + BK * W_PITCH + 1023) / 1024 * 1024;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + base alignment

// NMAT = 2: gate/up (q0 = qg, q1 = qu); NMAT = 1: down (q0 = q1 = qd).
template <int NMAT>
struct Cols {
  static constexpr int OUT = WCOLS / NMAT;  // columns of out per block
  // Byte offset, in a weight-tile row, of slice s of warpgroup wg: the row
  // holds [qg n0 .. n0 + 127 | qu n0 .. n0 + 127] or [qd n0 .. n0 + 255].
  __device__ static __forceinline__ int slice(int wg, int s) {
    return NMAT == 2 ? 128 * s + 64 * wg : 128 * wg + 64 * s;
  }
  // Column of out, from the block's first, of slice s of warpgroup wg.
  __device__ static __forceinline__ int out(int wg, int s) {
    return NMAT == 2 ? 64 * wg : 128 * wg + 64 * s;
  }
};
static_assert(StagedTile<2 * TILE_ROWS, Cols<1>::OUT>::BYTES <= STAGES * STAGE_BYTES,
              "the staged output tile fits in the ring");

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// r holds the int8 bytes (W[k][c], W[k][c + 1], W[k + 1][c], W[k + 1][c + 1]);
// c0 becomes the bf16 pair (W[k][c], W[k + 1][c]), c1 (W[k][c + 1],
// W[k + 1][c + 1]), low half first.  Exact for every int8 value.
__device__ __forceinline__ void widen_kpairs(uint32_t r, uint32_t& c0, uint32_t& c1) {
  constexpr uint32_t MAGIC = 0x4B000000u;  // 2^23
  constexpr float BIAS = 8388736.0f;       // 2^23 + 128
  const uint32_t u = r ^ 0x80808080u;      // each byte v + 128, unsigned
  const float f0 = __uint_as_float(__byte_perm(u, MAGIC, 0x7650)) - BIAS;
  const float f1 = __uint_as_float(__byte_perm(u, MAGIC, 0x7651)) - BIAS;
  const float f2 = __uint_as_float(__byte_perm(u, MAGIC, 0x7652)) - BIAS;
  const float f3 = __uint_as_float(__byte_perm(u, MAGIC, 0x7653)) - BIAS;
  c0 = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  c1 = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// Two A fragments from an int8 weight tile in shared memory: one
// ldmatrix.x4.trans (matrix j = lane / 8 from this lane's row address, 8
// k-rows of 16 bytes) and the widening.  fa[0] is from matrices 0 and 1 (k
// rows 0-7 and 8-15 of one k16 step), fa[1] from matrices 2 and 3.
__device__ __forceinline__ void load_a_pair(uint32_t (&fa)[2][4], uint32_t lane_addr) {
  uint32_t r[4];
  ldmatrix_x4_trans(r, lane_addr);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    widen_kpairs(r[2 * s], fa[s][0], fa[s][1]);
    widen_kpairs(r[2 * s + 1], fa[s][2], fa[s][3]);
  }
}

// The weight tile of k-step [k0, k0 + 64) into shared memory at dst: 64
// rows of the block's weight columns, 16 per cp.async; rows >= K and
// columns >= N are zero-filled (N % 16 == 0).
template <int NMAT>
__device__ __forceinline__ void issue_weights(uint32_t dst, const int8_t* w0,
                                              const int8_t* w1, int K, int N, int n0,
                                              int k0, int tid) {
  constexpr int CPR = WCOLS / 16;  // 16-byte chunks per row
  constexpr int CPM = CPR / NMAT;  // of them per matrix
#pragma unroll
  for (int i = 0; i < BK * CPR / THREADS; ++i) {
    const int p = tid + i * THREADS;
    const int k = p / CPR;
    const int c = p % CPR;
    const int8_t* w = c < CPM ? w0 : w1;
    const int col = n0 + 16 * (c % CPM);
    const bool ok = k0 + k < K && col < N;
    cp_async16(dst + k * W_PITCH + 16 * c,
               ok ? w + static_cast<size_t>(k0 + k) * N + col : w0, ok);
  }
}

struct Args {
  const bf16* x;
  const int8_t* q0;
  const int8_t* q1;
  const float* s0;
  const float* s1;
  bf16* out;
  int K, N, num_experts, layer;
};

// One pass: NR rows of x from row0, all of expert e, times the block's
// weight columns from n0, into out.
template <int NMAT, int NR>
__device__ __forceinline__ void run_pass(unsigned char* smem, Args a, size_t row0,
                                         int e, int n0) {
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int K = a.K, N = a.N;
  const size_t le = static_cast<size_t>(a.layer) * a.num_experts + e;
  const int8_t* w0 = a.q0 + le * K * N;
  const int8_t* w1 = a.q1 + le * K * N;
  const bf16* xr = a.x + row0 * K;
  const uint32_t base = smem_u32(smem);
  const int ktiles = (K + BK - 1) / BK;

  auto issue = [&](int kt) {
    const uint32_t st = base + (kt % STAGES) * STAGE_BYTES;
    issue_kmajor_rows<NR, THREADS>(st, xr, K, kt * BK, K, tid);
    issue_weights<NMAT>(st + X_BYTES, w0, w1, K, N, n0, kt * BK, tid);
  };

  __syncthreads();  // the previous pass's epilogue is done with the ring
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < ktiles) issue(s);
    cp_async_commit();
  }

  float acc[2][NR / 2];
  uint32_t fa[KSTEPS][2][4];  // A fragments: [k16 step of the stage][slice][register]
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[s][i] = 0.0f;
#pragma unroll
    for (int b = 0; b < KSTEPS; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) fa[b][s][j] = 0u;
  }
  // This lane's ldmatrix row: matrix j = lane / 8 is slice j / 2, k rows
  // 8 (j % 2) .. 8 (j % 2) + 7 of the k16 step; the warp's 16 columns.
  const int mj = lane / 8;
  const uint32_t lm_off = X_BYTES + ((mj % 2) * 8 + lane % 8) * W_PITCH +
                          Cols<NMAT>::slice(wg, mj / 2) + 16 * warp;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    // Stage kt is in place for every thread; every warpgroup's products of
    // step kt - 2 have retired (each leaves in flight only its last
    // KSTEPS - 1 groups, all of step kt - 1), so that step's stage can be
    // refilled.
    __syncthreads();
    if (kt + STAGES - 2 < ktiles) issue(kt + STAGES - 2);
    cp_async_commit();
    const uint32_t st = base + (kt % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      load_a_pair(fa[kk], st + lm_off + kk * 16 * W_PITCH);
      const uint64_t desc = XTile::k_major(st, kk);
      wgmma_fence();
      wgmma_rs<NR, 0>(acc[0], fa[kk][0], desc, 1);
      wgmma_rs<NR, 0>(acc[1], fa[kk][1], desc, 1);
      wgmma_commit();
      // The products of KSTEPS - 1 steps ago are done: the A buffer of the
      // next step is free.
      wgmma_wait<KSTEPS - 1>();
      fence_regs(fa[(kk + 1) % KSTEPS][0]);
      fence_regs(fa[(kk + 1) % KSTEPS][1]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
#pragma unroll
  for (int b = 0; b < KSTEPS; ++b) {
    fence_regs(fa[b][0]);
    fence_regs(fa[b][1]);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the ring; the staging reuses it

  using Stage = StagedTile<NR, Cols<NMAT>::OUT>;
  const int cw = 16 * warp + 2 * g;  // weight column of accumulator rows g, g + 8
  if constexpr (NMAT == 2) {
    const int col = n0 + Cols<2>::out(wg, 0) + cw;
    float2 sg = make_float2(0.0f, 0.0f), su = sg;
    if (col < N) {
      sg = *reinterpret_cast<const float2*>(a.s0 + le * N + col);
      su = *reinterpret_cast<const float2*>(a.s1 + le * N + col);
    }
#pragma unroll
    for (int i = 0; i < NR / 8; ++i)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float gv = acc[0][4 * i + 2 * h + e2] * (h ? sg.y : sg.x);
          const float uv = acc[1][4 * i + 2 * h + e2] * (h ? su.y : su.x);
          v[h] = gv / (1.0f + expf(-gv)) * uv;  // silu(gate) * up, in f32
        }
        Stage::put(smem, 8 * i + 2 * t + e2, Cols<2>::out(wg, 0) + cw, pack_bf16(v[0], v[1]));
      }
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int col = n0 + Cols<1>::out(wg, s) + cw;
      float2 sd = make_float2(0.0f, 0.0f);
      if (col < N) sd = *reinterpret_cast<const float2*>(a.s0 + le * N + col);
#pragma unroll
      for (int i = 0; i < NR / 8; ++i)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          Stage::put(smem, 8 * i + 2 * t + e2, Cols<1>::out(wg, s) + cw,
                     pack_bf16(acc[s][4 * i + e2] * sd.x, acc[s][4 * i + 2 + e2] * sd.y));
    }
  }
  __syncthreads();
  Stage::template store<THREADS>(smem, a.out, N, row0, n0, N, tid);
}

template <int NMAT>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_q_kernel(Args a, const int* __restrict__ tile_expert,
                      const int* __restrict__ tile_valid, int m_pad, int tile_m) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n0 = blockIdx.x * Cols<NMAT>::OUT;
  const int tiles = m_pad / TILE_ROWS;
  const int t0 = 2 * blockIdx.y;
  const bool two = t0 + 1 < tiles;
  auto owner = [&](int tile) { return tile * TILE_ROWS / tile_m; };
  auto valid = [&](int tile) { return tile_valid == nullptr || tile_valid[owner(tile)] != 0; };
  const int e0 = tile_expert[owner(t0)];
  const int e1 = two ? tile_expert[owner(t0 + 1)] : -1;
  const bool v0 = valid(t0);
  const bool v1 = two && valid(t0 + 1);
  const size_t r0 = static_cast<size_t>(t0) * TILE_ROWS;
  using Zero = StagedTile<TILE_ROWS, Cols<NMAT>::OUT>;
  if (v0 && v1 && e0 == e1) {
    run_pass<NMAT, 2 * TILE_ROWS>(smem, a, r0, e0, n0);
    return;
  }
  if (v0)
    run_pass<NMAT, TILE_ROWS>(smem, a, r0, e0, n0);
  else
    Zero::template zero<THREADS>(a.out, a.N, r0, n0, a.N, threadIdx.x);
  if (!two) return;
  if (v1)
    run_pass<NMAT, TILE_ROWS>(smem, a, r0 + TILE_ROWS, e1, n0);
  else
    Zero::template zero<THREADS>(a.out, a.N, r0 + TILE_ROWS, n0, a.N, threadIdx.x);
}

template <int NMAT>
int launch(const Args& a, const int* tile_expert, const int* tile_valid, int m_pad,
           int tile_m, void* stream) {
  if (m_pad < TILE_ROWS || m_pad % TILE_ROWS || tile_m < TILE_ROWS || tile_m % TILE_ROWS ||
      m_pad % tile_m || a.K < 8 || a.K % 8 || a.N < 16 || a.N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_q_kernel<NMAT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.N + Cols<NMAT>::OUT - 1) / Cols<NMAT>::OUT, (m_pad / TILE_ROWS + 1) / 2);
  grouped_gemm_q_kernel<NMAT><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      a, tile_expert, tile_valid, m_pad, tile_m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// h [m_pad, f] = silu((x @ qg[layer, e]) * sg[layer, e])
//                * ((x @ qu[layer, e]) * su[layer, e]); x [m_pad, d].
// tile_valid: int32 [m_pad / tile_m] or null.
int ctdb_grouped_gateup_q(const void* x, const void* qg, const void* qu,
                          const void* sg, const void* su, void* h,
                          const int* tile_expert, int m_pad, int d, int f,
                          int num_experts, int layer, int tile_m,
                          const int* tile_valid, void* stream) {
  const Args a{static_cast<const bf16*>(x), static_cast<const int8_t*>(qg),
               static_cast<const int8_t*>(qu), static_cast<const float*>(sg),
               static_cast<const float*>(su), static_cast<bf16*>(h), d, f, num_experts,
               layer};
  return launch<2>(a, tile_expert, tile_valid, m_pad, tile_m, stream);
}

// out [m_pad, d] = (h @ qd[layer, e]) * sd[layer, e]; h [m_pad, f].
int ctdb_grouped_down_q(const void* h, const void* qd, const void* sd, void* out,
                        const int* tile_expert, int m_pad, int f, int d,
                        int num_experts, int layer, int tile_m, const int* tile_valid,
                        void* stream) {
  const Args a{static_cast<const bf16*>(h), static_cast<const int8_t*>(qd),
               static_cast<const int8_t*>(qd), static_cast<const float*>(sd),
               static_cast<const float*>(sd), static_cast<bf16*>(out), f, d, num_experts,
               layer};
  return launch<1>(a, tile_expert, tile_valid, m_pad, tile_m, stream);
}

}  // extern "C"
