// Fused expert FFN for the MoE block on the expert-aligned padded layout:
// gate, up, SiLU and down in one kernel, h kept in shared memory.
//
// Replaces (TPU): ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py
//   grouped_ffn_fused_padded / _fused_ffn_kernel, the opt-in
//   (CTDB_GROUPED_FUSED=1) megakernel of grouped_expert_ffn_pallas for
//   bf16/f32 weights with D and F multiples of 128, with its pad-skip: a
//   tile that tile_valid marks 0 (the reference's sentinel slot) writes
//   zeros and runs no product.  Its NSLOTS weight-DMA schedule
//   (_run_schedule) hides TPU DMA latency and has no counterpart.
//
// What it computes: x_padded [M_pad, D] holds the routed token rows, grouped
// so that every tile_m-row tile belongs to one expert, tile_expert[tile]:
//   h   = bf16(silu(x @ Wg[e]) * (x @ Wu[e]))   [rows, F], f32 products,
//         rounded once, as the reference's .astype(x.dtype)
//   out = bf16(h @ Wd[e])                        [rows, D], f32 product
// Weights are [E, D, F] / [E, F, D] or layer-stacked [L, E, ...]; the layer
// id picks the stack slice.  Padding rows (copies of token 0) in a tile
// with a real row are computed like any row; the combine gives them weight
// 0.  h never reaches device memory.
//
// Bound on an H100 SXM at the single-prompt chat shape (llada-moe-7b, B 1,
// S 512: 4096 routed rows, m_pad 8192, D 2048, F 896): each used expert's
// three matrices are read once, 11 MB an expert (705 MB if all 64 are
// used), against 4096 rows of x and out (34 MB): at most ~0.22 ms at
// 3.35 TB/s; the 45 GFLOP take ~0.05 ms at 989 TFLOP/s.  Bytes bound.
//
// Design (Hopper; hopper_mma.cuh has the layouts, instructions and tensor
// maps).  One 64-row tile's FFN is spread over a thread block cluster of
// F / 128 CTAs (7 at F 896), one per 128 columns of h, so the tile's
// weights stream into several SMs at once and the all-padding tiles, whose
// clusters only zero-fill, free whole clusters:
// - Gate/up, as the bf16 pair's gate/up kernel (grouped_gemm.cu) computes
//   it: each of two consumer warpgroups computes gate and up of 64 columns
//   of h transposed (h^T = W^T x^T: the weight box an MN-major A, the x tile
//   the K-major B, both from shared memory), so SiLU(gate) * up runs on
//   the f32 accumulators; a producer warpgroup, of which one thread works,
//   fills a 5-stage ring of 40 KB stages by TMA (x's box {64 k, 64 rows},
//   four weight boxes {64 columns, 64 k}).
// - Exchange: each warpgroup rounds its 64 columns of h to bf16 into its
//   CTA's h tile, in the K-major swizzled layout the down product reads
//   (one SwTile<64, 64> per 64 columns of F), and copies them into the same
//   place of every other CTA of the cluster through distributed shared
//   memory (16-byte st.shared::cluster).  Two cluster barriers frame the
//   writes: the first says every consumer of every CTA has retired its
//   gate/up products, so the ring, which shares its memory with the h tile,
//   is free (the local block too waits for it: the other warpgroup of the
//   CTA may still be reading the ring); the second that every CTA's h is
//   whole.  The cluster meets only there.
// - Down: each CTA computes its share of out's 64-column slices (D / 64
//   slices over the cluster, 4 or 5 at D 2048), up to three per consumer
//   warpgroup in one pass over the whole F, in order; Wd's boxes arrive by
//   TMA into a 2-stage ring of 48 KB stages beside the h tile, the first
//   ones during the exchange.  The tile leaves through shared memory as
//   16-byte rows (StagedTile).
// - Pad-skip: a cluster whose tile tile_valid marks 0 zero-fills its rows
//   and exits before any copy.
// Shared memory at F 896: the h tile (112 KB) and the down ring (96 KB),
// the gate/up ring over both: 210 KB, one CTA per SM.  F is at most 1024
// (8 CTAs, the portable cluster size; 226 KB).  setmaxnreg leaves the
// producer 40 registers and gives the consumers 232.
// Deterministic: every output element is one warpgroup's in-order k loop.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace ctdb;

constexpr int ROWS = 64;                    // rows of a tile, the wgmma N
constexpr int NWG = 2;                      // consumer warpgroups per CTA
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = 128 + CONSUMERS;    // warpgroup 0 is the producer
constexpr int BK = 64;                      // k per ring stage
constexpr int KSTEPS = BK / 16;
constexpr int COLS = 64;                    // columns of a weight box / an h block
constexpr int CTA_F = 128;                  // columns of h per CTA
constexpr int MAX_CLUSTER = 8;              // portable cluster size
using XTile = SwTile<BK, ROWS>;             // x's box, and one 64-column block of h
using WTile = SwTile<COLS, BK>;             // a weight box: 64 k rows of 64 columns
constexpr int BOX_BYTES = WTile::BYTES;     // 8 KB
static_assert(XTile::BYTES == BOX_BYTES, "x boxes, h blocks and weight boxes are 8 KB");
constexpr int GU_BOXES = 4;                 // gate, up of 2 x 64 columns
constexpr int GU_STAGE = XTile::BYTES + GU_BOXES * BOX_BYTES;  // 40 KB
constexpr int GU_STAGES = 5;
constexpr int DN_WG_SLICES = 3;             // 64-column slices of out per warpgroup
constexpr int DN_BOXES = NWG * DN_WG_SLICES;
constexpr int DN_STAGE = DN_BOXES * BOX_BYTES;  // 48 KB
constexpr int DN_STAGES = 2;
constexpr int BAR_BYTES = 1024;             // the barriers, before the 1024-aligned region
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int EPI_BAR = 1;                  // named barrier over the consumers
using Staged = StagedTile<ROWS, DN_BOXES * COLS>;
static_assert(Staged::BYTES <= DN_STAGES * DN_STAGE, "the staged out tile fits in the ring");

// Barrier slots: gate/up full, empty; down full, empty; epilogue done.
constexpr int GFULL = 0;
constexpr int GEMPTY = GFULL + GU_STAGES;
constexpr int DFULL = GEMPTY + GU_STAGES;
constexpr int DEMPTY = DFULL + DN_STAGES;
constexpr int EPI = DEMPTY + DN_STAGES;
static_assert((EPI + 1) * 8 <= BAR_BYTES, "barriers fit");

// Shared memory of a CTA at width F: barriers, then one region that holds
// the gate/up ring, and later the h tile followed by the down ring.
__host__ __device__ constexpr int h_bytes(int f) { return ROWS * f * 2; }
__host__ __device__ constexpr int region_bytes(int f) {
  return GU_STAGES * GU_STAGE > h_bytes(f) + DN_STAGES * DN_STAGE
             ? GU_STAGES * GU_STAGE
             : h_bytes(f) + DN_STAGES * DN_STAGE;
}
__host__ __device__ constexpr int smem_bytes(int f) {
  return BAR_BYTES + region_bytes(f) + 1024;  // + base alignment
}

struct Args {
  bf16* out;
  const int* tile_expert;
  const int* tile_valid;
  int D, F, num_experts, layer, tile_m;
};

// The 64-column slices of out that CTA c of `cl` computes: [begin, end).
__device__ __forceinline__ int2 down_slices(int D, int c, int cl) {
  const int ns = D / COLS;
  return make_int2(c * ns / cl, (c + 1) * ns / cl);
}

// Gate/up of one consumer warpgroup: gate and up of its 64 columns of h for
// the tile's 64 rows; returns with both products retired.
__device__ __forceinline__ void gateup(float (&g)[32], float (&u)[32], uint32_t region,
                                       uint32_t bars, int ktiles, int w, bool leader) {
#pragma unroll
  for (int i = 0; i < 32; ++i) g[i] = u[i] = 0.0f;
  const uint32_t a_off = XTile::BYTES + 2 * w * BOX_BYTES;  // this warpgroup's boxes
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % GU_STAGES;
    mbar_wait(bars + 8 * (GFULL + s), (kt / GU_STAGES) & 1);
    const uint32_t st = region + s * GU_STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint64_t desc_b = XTile::k_major(st, kk);
      wgmma_ss<ROWS, 1>(g, WTile::mn_major(st + a_off, kk), desc_b, 1);
      wgmma_ss<ROWS, 1>(u, WTile::mn_major(st + a_off + BOX_BYTES, kk), desc_b, 1);
    }
    wgmma_commit();
    // The products of the previous stage have retired: release it.
    wgmma_wait<1>();
    if (kt > 0 && leader) mbar_arrive(bars + 8 * (GEMPTY + (kt - 1) % GU_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(g);
  fence_regs(u);
}

// One down pass of a consumer warpgroup over the whole F: its NW slices
// (pass slices w, w + 2, w + 4 of the stage's boxes) times the h tile, then
// their bf16 values into the staging tile (pass column 64 * slice).  NW 0:
// the warpgroup only keeps the ring's count.
template <int NW>
__device__ __forceinline__ void down_pass(unsigned char* smem, uint32_t region,
                                          uint32_t bars, uint32_t ring, int ktiles, int& it,
                                          int w, int ctid) {
  const bool leader = ctid % 128 == 0;
  float acc[NW > 0 ? NW : 1][32];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = it % DN_STAGES;
    mbar_wait(bars + 8 * (DFULL + s), (it / DN_STAGES) & 1);
    if constexpr (NW > 0) {
      const uint32_t st = ring + s * DN_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t desc_b = XTile::k_major(region + kt * XTile::BYTES, kk);
#pragma unroll
        for (int j = 0; j < NW; ++j)
          wgmma_ss<ROWS, 1>(acc[j], WTile::mn_major(st + (w + 2 * j) * BOX_BYTES, kk), desc_b,
                            1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && leader) mbar_arrive(bars + 8 * (DEMPTY + (it - 1) % DN_STAGES));
    } else if (leader) {
      mbar_arrive(bars + 8 * (DEMPTY + s));
    }
  }
  if constexpr (NW > 0) {
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NW; ++j) fence_regs(acc[j]);
    if (ktiles > 0 && leader) mbar_arrive(bars + 8 * (DEMPTY + (it - 1) % DN_STAGES));
  }
  named_sync(EPI_BAR, CONSUMERS);  // both warpgroups are done with the ring
  const int warp = (ctid % 128) / 32;
  const int lane = ctid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // Accumulator element 4 i + 2 h + e is out column 16 warp + g + 8 h of
  // the slice and row 8 i + 2 t + e.
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int i = 0; i < ROWS / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          Staged::put_one(smem + (ring - smem_u32(smem)), 8 * i + 2 * t + e,
                          (w + 2 * j) * COLS + 16 * warp + g + 8 * h,
                          __float2bfloat16(acc[j][4 * i + 2 * h + e]));
}

__global__ void __launch_bounds__(THREADS, 1)
grouped_ffn_fused_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wgmap,
                         const __grid_constant__ CUtensorMap wumap,
                         const __grid_constant__ CUtensorMap wdmap, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem);
  const uint32_t region = bars + BAR_BYTES;        // gate/up ring, then the h tile
  const uint32_t dn_ring = region + h_bytes(a.F);  // the down ring, after h
  const int cl = a.F / CTA_F;                      // CTAs in the cluster
  const int c = static_cast<int>(cluster_rank());
  const int tile = blockIdx.y;
  const size_t row0 = static_cast<size_t>(tile) * ROWS;
  const int owner = tile * ROWS / a.tile_m;
  const int2 sl = down_slices(a.D, c, cl);
  const int tid = threadIdx.x;

  if (a.tile_valid != nullptr && a.tile_valid[owner] == 0) {
    // No real row: zeros for this CTA's columns, no product (the whole
    // cluster takes this branch).
    const int c0 = sl.x * COLS;
    const int cpr = (sl.y - sl.x) * COLS / 8;  // 16-byte chunks per row
    for (int p = tid; p < ROWS * cpr; p += THREADS)
      *reinterpret_cast<uint4*>(a.out + (row0 + p / cpr) * a.D + c0 + 8 * (p % cpr)) =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < GU_STAGES; ++s) {
      mbar_init(bars + 8 * (GFULL + s), 1);
      mbar_init(bars + 8 * (GEMPTY + s), NWG);
    }
    for (int s = 0; s < DN_STAGES; ++s) {
      mbar_init(bars + 8 * (DFULL + s), 1);
      mbar_init(bars + 8 * (DEMPTY + s), NWG);
    }
    mbar_init(bars + 8 * EPI, CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();
  const int le = a.layer * a.num_experts + a.tile_expert[owner];
  const int gu_ktiles = a.D / BK;
  const int dn_ktiles = a.F / BK;

  if (tid < 128) {
    regs_dec<PRODUCER_REGS>();
    cluster_arrive();  // 1: nothing of this thread's to publish
    if (tid == 0) {
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wgmap);
      tma_prefetch_map(&wumap);
      tma_prefetch_map(&wdmap);
      for (int kt = 0; kt < gu_ktiles; ++kt) {
        const int s = kt % GU_STAGES;
        mbar_wait(bars + 8 * (GEMPTY + s), ((kt / GU_STAGES) & 1) ^ 1);
        const uint32_t st = region + s * GU_STAGE;
        const uint32_t full = bars + 8 * (GFULL + s);
        mbar_arrive_expect_tx(full, GU_STAGE);
        tma_load_2d(st, &xmap, kt * BK, static_cast<int>(row0), full);
#pragma unroll
        for (int bx = 0; bx < GU_BOXES; ++bx)
          tma_load_3d(st + XTile::BYTES + bx * BOX_BYTES, bx % 2 ? &wumap : &wgmap,
                      c * CTA_F + (bx / 2) * COLS, kt * BK, le, full);
      }
    }
    // 1: every CTA of the cluster is done with its gate/up ring, so the
    // down ring (and the others' h tiles) may be written.
    cluster_wait();
    cluster_arrive();  // 2
    if (tid == 0) {
      int it = 0;
      uint32_t epi_parity = 0;
      for (int first = sl.x; first < sl.y; first += DN_BOXES) {
        const int m = min(DN_BOXES, sl.y - first);
        if (first > sl.x) {  // the previous pass's epilogue still stages in the ring
          mbar_wait(bars + 8 * EPI, epi_parity);
          epi_parity ^= 1;
        }
        for (int kt = 0; kt < dn_ktiles; ++kt, ++it) {
          const int s = it % DN_STAGES;
          mbar_wait(bars + 8 * (DEMPTY + s), ((it / DN_STAGES) & 1) ^ 1);
          const uint32_t full = bars + 8 * (DFULL + s);
          mbar_arrive_expect_tx(full, m * BOX_BYTES);
          for (int j = 0; j < m; ++j)
            tma_load_3d(dn_ring + s * DN_STAGE + j * BOX_BYTES, &wdmap, (first + j) * COLS,
                        kt * BK, le, full);
        }
      }
    }
    cluster_wait();  // 2
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int ctid = tid - 128;
  const int w = ctid / 128;
  const int wtid = ctid % 128;
  const bool leader = wtid == 0;
  {
    float g[32], u[32];
    gateup(g, u, region, bars, gu_ktiles, w, leader);
    cluster_arrive();  // 1: this warpgroup is done with its CTA's gate/up ring
#pragma unroll
    for (int d = 0; d < 32; ++d) g[d] = g[d] / (1.0f + expf(-g[d])) * u[d];  // silu(gate) * up
    // 1: every consumer of every CTA has retired its gate/up products, so
    // the ring's memory, which the h tile reuses, may be written here and
    // by the other CTAs.  (The other warpgroup of this CTA may still be
    // reading the ring until then.)
    cluster_wait();
    // h = bf16(silu(gate) * up) into this CTA's h block 2c + w: accumulator
    // element 4 i + 2 h + e is column 16 warp + g + 8 h of the block and row
    // 8 i + 2 t + e.
    const int warp = wtid / 32;
    const int lane = wtid % 32;
    const int gq = lane / 4;
    const int t = lane % 4;
    unsigned char* hb = smem + BAR_BYTES + (2 * c + w) * XTile::BYTES;
#pragma unroll
    for (int i = 0; i < ROWS / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * warp + gq + 8 * hh;
          *reinterpret_cast<bf16*>(hb + XTile::chunk(8 * i + 2 * t + e, col / 8) +
                                   (col % 8) * 2) = __float2bfloat16(g[4 * i + 2 * hh + e]);
        }
  }
  named_sync(2 + w, 128);  // this warpgroup's h block is whole
  {
    const uint32_t hblk = region + (2 * c + w) * XTile::BYTES;
    for (int p = wtid; p < XTile::BYTES / 16; p += 128) {
      const uint4 v = *reinterpret_cast<const uint4*>(smem + BAR_BYTES +
                                                      (2 * c + w) * XTile::BYTES + 16 * p);
      for (int r = 0; r < cl; ++r)
        if (r != c) st_cluster16(cluster_map(hblk + 16 * p, r), v);
    }
  }
  fence_proxy_async_cluster();
  cluster_arrive();  // 2: this warpgroup's h block is in every CTA
  cluster_wait();    // 2: the h tile is whole
  fence_proxy_async();

  int it = 0;
  for (int first = sl.x; first < sl.y; first += DN_BOXES) {
    const int m = min(DN_BOXES, sl.y - first);
    const int nw = (m - w + 1) / 2;  // pass slices w, w + 2, w + 4 below m
    switch (nw) {
      case 0: down_pass<0>(smem, region, bars, dn_ring, dn_ktiles, it, w, ctid); break;
      case 1: down_pass<1>(smem, region, bars, dn_ring, dn_ktiles, it, w, ctid); break;
      case 2: down_pass<2>(smem, region, bars, dn_ring, dn_ktiles, it, w, ctid); break;
      default: down_pass<3>(smem, region, bars, dn_ring, dn_ktiles, it, w, ctid); break;
    }
    named_sync(EPI_BAR, CONSUMERS);
    Staged::store<CONSUMERS>(smem + (dn_ring - bars), a.out, a.D, row0, first * COLS,
                             (first + m) * COLS, ctid);
    // The staging reads and writes come before the producer's next TMA writes.
    fence_proxy_async();
    mbar_arrive(bars + 8 * EPI);
  }
}

int launch(const void* x, const void* wg, const void* wu, const void* wd, const Args& a,
           int m_pad, int num_layers, cudaStream_t stream) {
  const int cl = a.F / CTA_F;
  if (a.D < 128 || a.D % 128 || a.F < CTA_F || a.F % CTA_F || cl > MAX_CLUSTER ||
      m_pad < ROWS || m_pad % ROWS || a.tile_m < ROWS || a.tile_m % ROWS ||
      m_pad % a.tile_m || a.num_experts < 1 || a.layer < 0 || a.layer >= num_layers)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wgmap, wumap, wdmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(a.D), static_cast<cuuint64_t>(m_pad)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(a.D) * 2};
  const cuuint32_t xbox[2] = {BK, ROWS};
  int err = encode_bf16_map(&xmap, x, 2, xdims, xstrides, xbox);
  const uint64_t le = static_cast<uint64_t>(num_layers) * a.num_experts;
  if (!err) err = weight_map(&wgmap, wg, le, a.D, a.F);
  if (!err) err = weight_map(&wumap, wu, le, a.D, a.F);
  if (!err) err = weight_map(&wdmap, wd, le, a.F, a.D);
  if (err) return err;
  const int bytes = smem_bytes(a.F);
  cudaError_t cerr = cudaFuncSetAttribute(
      grouped_ffn_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, m_pad / ROWS, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&xmap, &wgmap, &wumap, &wdmap, const_cast<Args*>(&a)};
  cerr = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(grouped_ffn_fused_kernel),
                             args);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [m_pad, d] = bf16(bf16(silu(x @ wg[layer, e]) * (x @ wu[layer, e])) @
// wd[layer, e]) per 64-row tile; x [m_pad, d]; wg, wu [num_layers *
// num_experts, d, f], wd [num_layers * num_experts, f, d]; d % 128 == 0,
// f % 128 == 0, f <= 1024.  tile_valid: int32 [m_pad / tile_m] or null; a
// tile marked 0 is zero-filled.
int ctdb_grouped_ffn_fused(const void* x, const void* wg, const void* wu,
                           const void* wd, void* out, const int* tile_expert,
                           int m_pad, int d, int f, int num_experts, int num_layers,
                           int layer, int tile_m, const int* tile_valid, void* stream) {
  const Args a{static_cast<bf16*>(out), tile_expert, tile_valid, d, f, num_experts, layer,
               tile_m};
  return launch(x, wg, wu, wd, a, m_pad, num_layers, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
