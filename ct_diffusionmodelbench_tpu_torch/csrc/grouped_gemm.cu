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
// Weights are bf16 [E, K, N] or layer-stacked [L, E, K, N]; the layer id
// picks the stack slice, as the TPU kernels' scalar-prefetched layer id did.
// Products run on bf16 tensor cores with f32 accumulators; the SiLU and the
// gate*up product run on the f32 accumulators before one bf16 store.  With a
// tile_valid vector ([M_pad / tile_m] int32; null: every tile valid), a tile
// whose entry is 0 holds no real row: its output rows are zeros and no
// product runs for it (the manual kernels' pad-skip sentinel slot).
//
// Bound on an H100 SXM at the main path (M = 20480 routed rows, D 2048,
// F 896, 64 experts): gate/up moves ~0.59 GB (each used expert's two
// weight matrices once, the routed rows of x and h once), ~0.18 ms at
// 3.35 TB/s, against 150 GFLOP, ~0.15 ms at 989 TFLOP/s: bound by bytes,
// close to the ridge.  The down projection is about half of each.
//
// Design (Hopper; hopper_mma.cuh has the layouts and instructions):
// - Orientation and schedule are the int8 pair's (grouped_gemm_q.cu).  Each
//   consumer warpgroup computes a transposed tile, out^T = W^T x^T: the
//   wgmma M is 64 weight columns, N the block's 64 or 128 rows of x.  A
//   block takes the 64-row tiles 2y and 2y + 1: one n128 pass when one
//   expert owns both, else an n64 pass for each (or a zero fill for a tile
//   that tile_valid marks empty).  Its two consumer warpgroups each take two
//   64-column slices: gate and up of the same 64 columns of h (gate/up: the
//   two accumulators line up element for element, so silu(g) u runs in
//   registers), or two neighbouring 64-column slices of out (down).  A block
//   covers 128 columns of h or 256 of out; column blocks vary fastest in the
//   grid, so the row tiles that read one expert's weights run close together
//   in time and share them in L2.
// - Both operands come from shared memory (SS wgmma).  A weight box
//   W[k0 .. k0 + 63, c .. c + 63] lies there as 64 rows of 128 bytes in the
//   128-byte swizzle: the MN-major A of W^T (imm-trans-a 1).  The x tile is
//   the K-major B, rows of x as they lie in device memory.  A thread holds
//   its 2 x 64 f32 accumulators (n128) and little else.
// - A producer warpgroup, of which one thread works, fills a 4-stage ring of
//   48 KB stages by TMA: per 64-deep step x's box {64 k, 64 rows} once or
//   twice and one weight box {64 columns, 64 k} per slice, from a 3-D map
//   [L * E, K, N], so rows k >= K of one expert are zero-filled by the
//   hardware instead of read from the next expert (x's columns >= K
//   likewise).  A stage's full barrier counts its TMA bytes; its empty
//   barrier takes one arrival per consumer warpgroup once that warpgroup's
//   products on it have retired.  The consumers keep one stage's products
//   in flight while they wait for the next; no block-wide barrier runs in
//   the k loop.  setmaxnreg leaves the producer 40 registers and gives the
//   consumers 232.
// - Epilogue: after a drain (both warpgroups' products retired, a named
//   barrier over the consumers) the bf16 tile is staged, transposed, in the
//   ring and leaves as 16-byte rows (StagedTile).  The consumers then arrive
//   on an epilogue barrier that the producer waits for before the block's
//   second pass refills the ring.
// - Host: the entry points build the CUtensorMaps with
//   cuTensorMapEncodeTiled (hopper_mma.cuh): x's map on every call, a
//   weight tensor's once per (pointer, shape) in a small cache, since the
//   layer and expert are a coordinate.  The maps are __grid_constant__
//   kernel parameters.
// Deterministic: every output element is one block's in-order k loop.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace ctdb;

constexpr int NWG = 2;                      // consumer warpgroups per block
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = 128 + CONSUMERS;    // warpgroup 0 is the producer
constexpr int TILE_ROWS = 64;               // rows of the layout's smallest tile
constexpr int BK = 64;                      // k per ring stage
constexpr int KSTEPS = BK / 16;             // k16 wgmma steps per stage
constexpr int STAGES = 4;
constexpr int SLICES = 2 * NWG;             // 64-column weight boxes per stage
constexpr int BOX = 64;                     // columns of a weight box
static_assert(BK * 2 == 128 && BOX * 2 == 128, "a box row is one 128-byte swizzle row");
using XTile = SwTile<BK, 2 * TILE_ROWS>;    // the B tile: 128 rows of 64 values
using WTile = SwTile<BOX, BK>;              // a weight box: 64 k rows of 64 columns
constexpr int X_BYTES = XTile::BYTES;       // 16 KB
constexpr int STAGE_BYTES = X_BYTES + SLICES * WTile::BYTES;  // 48 KB
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int BARRIERS = 2 * STAGES + 1;    // full, empty, epilogue done
constexpr int SMEM_BYTES = RING_BYTES + BARRIERS * 8 + 1024;  // + base alignment
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int EPI_BAR = 1;                  // named barrier over the consumers
static_assert(STAGE_BYTES % 1024 == 0 && X_BYTES % 1024 == 0, "swizzle alignment");

// NMAT = 2: gate/up (w0 = Wg, w1 = Wu); NMAT = 1: down (w0 = w1 = Wd).
template <int NMAT>
struct Cols {
  static constexpr int OUT = 128 * NWG / NMAT;  // columns of out per block
  // Column of out, and of the weights, from the block's first, of slice s
  // of consumer warpgroup wg (gate/up: slice 0 is gate, 1 is up).
  __device__ static __forceinline__ int out(int wg, int s) {
    return NMAT == 2 ? 64 * wg : 128 * wg + 64 * s;
  }
};
static_assert(StagedTile<2 * TILE_ROWS, Cols<1>::OUT>::BYTES <= RING_BYTES,
              "the staged output tile fits in the ring");

struct Args {
  bf16* out;
  const int* tile_expert;
  const int* tile_valid;
  int K, N, num_experts, layer, m_pad, tile_m;
};

// What a block does with its tiles 2y and 2y + 1 (pass p starts at tile
// 2y + p).
enum Pass { NONE, ZERO, N64, N128 };
struct Schedule {
  Pass pass[2];
  int expert[2];
};

__device__ __forceinline__ Schedule schedule(const Args& a) {
  const int tiles = a.m_pad / TILE_ROWS;
  const int t0 = 2 * blockIdx.y;
  const bool two = t0 + 1 < tiles;
  auto owner = [&](int tile) { return tile * TILE_ROWS / a.tile_m; };
  auto valid = [&](int tile) {
    return a.tile_valid == nullptr || a.tile_valid[owner(tile)] != 0;
  };
  Schedule s;
  s.expert[0] = a.tile_expert[owner(t0)];
  s.expert[1] = two ? a.tile_expert[owner(t0 + 1)] : -1;
  const bool v0 = valid(t0);
  const bool v1 = two && valid(t0 + 1);
  if (v0 && v1 && s.expert[0] == s.expert[1]) {
    s.pass[0] = N128;
    s.pass[1] = NONE;
  } else {
    s.pass[0] = v0 ? N64 : ZERO;
    s.pass[1] = !two ? NONE : (v1 ? N64 : ZERO);
  }
  return s;
}

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (STAGES + s);
}
__device__ __forceinline__ uint32_t epi_bar(uint32_t bars) { return bars + 8 * 2 * STAGES; }

// The producer thread: every stage of every pass that multiplies.
template <int NMAT>
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const CUtensorMap* wmap0,
                                        const CUtensorMap* wmap1, const Args& a,
                                        const Schedule& sc, uint32_t ring, uint32_t bars,
                                        int n0) {
  const int ktiles = (a.K + BK - 1) / BK;
  int it = 0;  // stages filled so far, over all passes
  uint32_t epi_parity = 0;
  bool ring_used = false;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (sc.pass[p] != N64 && sc.pass[p] != N128) continue;
    if (ring_used) {  // the previous pass's epilogue still stages in the ring
      mbar_wait(epi_bar(bars), epi_parity);
      epi_parity ^= 1;
    }
    ring_used = true;
    const int rows = sc.pass[p] == N128 ? 2 * TILE_ROWS : TILE_ROWS;
    const int row0 = (2 * blockIdx.y + p) * TILE_ROWS;
    const int le = a.layer * a.num_experts + sc.expert[p];
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(empty_bar(bars, s), ((it / STAGES) & 1) ^ 1);
      const uint32_t st = ring + s * STAGE_BYTES;
      mbar_arrive_expect_tx(full_bar(bars, s), rows * BK * 2 + SLICES * WTile::BYTES);
      for (int r = 0; r < rows; r += TILE_ROWS)
        tma_load_2d(st + r * BK * 2, xmap, kt * BK, row0 + r, full_bar(bars, s));
#pragma unroll
      for (int b = 0; b < SLICES; ++b)
        tma_load_3d(st + X_BYTES + b * WTile::BYTES, NMAT == 2 && b % 2 ? wmap1 : wmap0,
                    n0 + Cols<NMAT>::out(b / 2, b % 2), kt * BK, le, full_bar(bars, s));
    }
  }
}

// One pass of a consumer warpgroup: NR rows of x from row0 times its two
// weight slices, then (with the other warpgroup) the epilogue into out.
template <int NMAT, int NR>
__device__ __forceinline__ void consume(unsigned char* smem, const Args& a, size_t row0,
                                        int n0, int& it, int wg, int ctid) {
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + RING_BYTES;
  const int ktiles = (a.K + BK - 1) / BK;
  const bool leader = ctid % 128 == 0;
  float acc[2][NR / 2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[s][i] = 0.0f;
  const uint32_t a_off = X_BYTES + 2 * wg * WTile::BYTES;  // this warpgroup's boxes

  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = it % STAGES;
    mbar_wait(full_bar(bars, s), (it / STAGES) & 1);
    const uint32_t st = ring + s * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint64_t desc_b = XTile::k_major(st, kk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_ss<NR, 1>(acc[j], WTile::mn_major(st + a_off + j * WTile::BYTES, kk), desc_b, 1);
    }
    wgmma_commit();
    // The products of the previous stage have retired: release it.
    wgmma_wait<1>();
    if (kt > 0 && leader) mbar_arrive(empty_bar(bars, (it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  if (leader) mbar_arrive(empty_bar(bars, (it - 1) % STAGES));
  named_sync(EPI_BAR, CONSUMERS);  // both warpgroups are done with the ring

  using Stage = StagedTile<NR, Cols<NMAT>::OUT>;
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // Accumulator element 4 i + 2 h + e is weight column 16 warp + g + 8 h of
  // the slice and row 8 i + 2 t + e of the pass.
  const int cw = 16 * warp + g;
#pragma unroll
  for (int i = 0; i < NR / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int d = 4 * i + 2 * h + e2;
        const int row = 8 * i + 2 * t + e2;
        if constexpr (NMAT == 2) {
          const float gv = acc[0][d];
          const float v = gv / (1.0f + expf(-gv)) * acc[1][d];  // silu(gate) * up, in f32
          Stage::put_one(smem, row, Cols<2>::out(wg, 0) + cw + 8 * h, __float2bfloat16(v));
        } else {
#pragma unroll
          for (int s = 0; s < 2; ++s)
            Stage::put_one(smem, row, Cols<1>::out(wg, s) + cw + 8 * h,
                           __float2bfloat16(acc[s][d]));
        }
      }
  named_sync(EPI_BAR, CONSUMERS);
  Stage::template store<CONSUMERS>(smem, a.out, a.N, row0, n0, a.N, ctid);
  // The staging reads and writes come before the producer's next TMA writes.
  fence_proxy_async();
  mbar_arrive(epi_bar(bars));
}

template <int NMAT>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap0,
                    const __grid_constant__ CUtensorMap wmap1, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + RING_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), NWG);
    }
    mbar_init(epi_bar(bars), CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();
  const Schedule sc = schedule(a);
  const int n0 = blockIdx.x * Cols<NMAT>::OUT;

  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wmap0);
      if (NMAT == 2) tma_prefetch_map(&wmap1);
      produce<NMAT>(&xmap, &wmap0, &wmap1, a, sc, ring, bars, n0);
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int ctid = threadIdx.x - 128;
    const int wg = ctid / 128;
    int it = 0;  // stages consumed so far, over all passes
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const size_t row0 = static_cast<size_t>(2 * blockIdx.y + p) * TILE_ROWS;
      if (sc.pass[p] == ZERO)
        StagedTile<TILE_ROWS, Cols<NMAT>::OUT>::template zero<CONSUMERS>(a.out, a.N, row0, n0,
                                                                         a.N, ctid);
      else if (sc.pass[p] == N64)
        consume<NMAT, TILE_ROWS>(smem, a, row0, n0, it, wg, ctid);
      else if (sc.pass[p] == N128)
        consume<NMAT, 2 * TILE_ROWS>(smem, a, row0, n0, it, wg, ctid);
    }
  }
}

// ---------------------------------------------------------------------------
// Host: launch
// ---------------------------------------------------------------------------

template <int NMAT>
int launch(const void* x, const void* w0, const void* w1, const Args& a, int num_layers,
           void* stream) {
  if (a.m_pad < TILE_ROWS || a.m_pad % TILE_ROWS || a.tile_m < TILE_ROWS ||
      a.tile_m % TILE_ROWS || a.m_pad % a.tile_m || a.K < 8 || a.K % 8 || a.N < 8 ||
      a.N % 8 || a.num_experts < 1 || a.layer < 0 || a.layer >= num_layers)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap0, wmap1;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(a.K), static_cast<cuuint64_t>(a.m_pad)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(a.K) * 2};
  const cuuint32_t xbox[2] = {BK, TILE_ROWS};
  int err = encode_bf16_map(&xmap, x, 2, xdims, xstrides, xbox);
  const uint64_t le = static_cast<uint64_t>(num_layers) * a.num_experts;
  if (!err) err = weight_map(&wmap0, w0, le, a.K, a.N);
  if (!err && NMAT == 2) err = weight_map(&wmap1, w1, le, a.K, a.N);
  if (err) return err;
  if (NMAT == 1) wmap1 = wmap0;
  cudaError_t cerr = cudaFuncSetAttribute(
      grouped_gemm_kernel<NMAT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  dim3 grid((a.N + Cols<NMAT>::OUT - 1) / Cols<NMAT>::OUT, (a.m_pad / TILE_ROWS + 1) / 2);
  grouped_gemm_kernel<NMAT><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap0, wmap1, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// h [m_pad, f] = silu(x @ wg[layer, e]) * (x @ wu[layer, e]); x [m_pad, d];
// wg, wu [num_layers * num_experts, d, f].  tile_valid: int32 [m_pad / tile_m]
// or null.
int ctdb_grouped_gateup(const void* x, const void* wg, const void* wu, void* h,
                        const int* tile_expert, int m_pad, int d, int f,
                        int num_experts, int num_layers, int layer, int tile_m,
                        const int* tile_valid, void* stream) {
  const Args a{static_cast<bf16*>(h), tile_expert, tile_valid, d, f, num_experts, layer,
               m_pad, tile_m};
  return launch<2>(x, wg, wu, a, num_layers, stream);
}

// out [m_pad, d] = h @ wd[layer, e]; h [m_pad, f]; wd [num_layers *
// num_experts, f, d].  tile_valid: int32 [m_pad / tile_m] or null.
int ctdb_grouped_down(const void* h, const void* wd, void* out,
                      const int* tile_expert, int m_pad, int f, int d,
                      int num_experts, int num_layers, int layer, int tile_m,
                      const int* tile_valid, void* stream) {
  const Args a{static_cast<bf16*>(out), tile_expert, tile_valid, f, d, num_experts, layer,
               m_pad, tile_m};
  return launch<1>(h, wd, wd, a, num_layers, stream);
}

}  // extern "C"
