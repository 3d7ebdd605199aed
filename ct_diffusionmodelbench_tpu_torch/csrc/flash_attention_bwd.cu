// Bidirectional flash-attention backward: dq, and dk/dv summed over the
// query heads of each kv head (GQA).
//
// Replaces (TPU): ct_diffusionmodelbench_tpu/ops/flash_attention_bwd.py
//   flash_attention_bwd -> _dq_kernel  (ctdb_flash_attention_bwd_dq)
//                       -> _dkv_kernel (ctdb_flash_attention_bwd_dkv)
//
// What it computes, per batch b, query head h (kv head h / rep), on q and k
// already rotated (the caller re-rotates them, as the reference does):
//   p_ij  = exp(s_ij * scale + bias_j - lse_i),  s_ij = q_i . k_j  (f32)
//   dp_ij = do_i . v_j                                          (f32)
//   ds_ij = p_ij * (dp_ij - D_i) * scale,  D_i = rowsum(do_i * o_i)  (f32)
//   dq_i  = sum_j bf16(ds_ij) k_j
//   dk_j  = sum_{h of kv head, i} bf16(ds_ij) q_i
//   dv_j  = sum_{h of kv head, i} bf16(p_ij) do_i
// All products accumulate in f32; dq, dk, dv are written in f32.
// Keys past S (the reference's zero keys up to its padded length) are left
// out: a zero key adds nothing to dq, and its dk/dv are never returned.
// Query rows past S carry p = 0 into dk/dv.
// Layout: heads in the last dim of the flat [B, S, H*Dh] / [B, S, KV*Dh]
// tensors (no transposes); lse and D are [B, H, S] f32.
//
// Bound on an H100 SXM at the training shape (B 1, S 2048, H = KV = 32,
// Dh 128): dq does 3 products of 2*S*S*Dh per head (1.03e11 FLOP, 0.104 ms
// at 989 TFLOP/s), dkv 4 (1.37e11 FLOP, 0.139 ms); each moves ~85 MB
// (0.025 ms at 3.35 TB/s).  Both are bound by operations.
//
// Design, dq (Hopper; hopper_mma.cuh has the layouts and instructions): K8's
// structure with a second score product.  A unit is 64 query rows of one
// query head; a block holds two consumer warpgroups, each with one unit of
// the same kv head (its rep query heads times the 64-row query tiles, head
// fastest, as in K8), so every K / V tile brought from L2 serves both; for
// rep 1 the two units are neighbouring row tiles of one head.  Per 64-key
// tile a consumer warpgroup runs
// - S = Q K^T and dP = dO V^T, wgmma m64n64k16 with both operands K-major in
//   shared memory, issued together; both score tiles stay in registers;
// - dS = P (dP - D) scale in registers, P = exp(S scale + bias - lse) from
//   the unrounded S, packed to bf16 in the A-fragment layout;
// - dQ += dS K, wgmma m64n{Dh}k16 with dS from registers and K the MN-major
//   B (as V is in K8's P V).  dQ (64 x Dh f32, Dh/2 registers a thread)
//   stays in registers over the whole key loop and is written once, in f32.
//   The warpgroup waits for dS K before it releases the stage: issuing the
//   next tile's S and dP first made ptxas serialize the products (C7515)
//   and measured slower.  The two warpgroups' products and elementwise
//   work interleave instead.
// A producer warpgroup, of which one thread works, brings Q and dO of each
// unit once and K and V through a 4-stage ring by TMA (3-D maps [B, S,
// heads * Dh], so rows past S read zeros), guarded by full / empty
// mbarriers: no block-wide barrier runs in the key loop.  Each thread loads
// the bias of its 16 keys itself while its products run (a TMA box must
// start 16-byte aligned in device memory, and a row of bias starts at any
// multiple of 4 bytes).  Keys past S carry p = 0.  setmaxnreg leaves the
// producer 40 registers and gives the consumers 232 (dQ 64, S 32, dP 32,
// dS 16 at Dh 128).
// Shared memory at Dh 128: two units' Q and dO (64 KB) and four stages of
// K and V (4 x 32 KB): 193 KB, one block per SM.

// Design, dk/dv (Hopper; hopper_mma.cuh has the layouts and instructions):
// one block of two warpgroups per (64-key tile, kv head, batch) loops over
// the rep query heads of the kv head and their 64-row query tiles, so the
// sum over heads and tiles stays inside the block and needs no atomics.  It
// works on the transposed scores, keys as rows, so each warpgroup's
// accumulator (64 keys x Dh f32, Dh/2 registers per thread) stays in
// registers over the whole loop:
// - warpgroup 0: S^T = K Q^T (wgmma m64n64k16, both operands in shared
//   memory, scores in registers), P^T = exp(S^T scale + bias_key - lse_q) in
//   registers, P^T written once to shared memory for warpgroup 1 (in f32, so
//   that dS^T comes from the unrounded p, as in the reference), then
//   dV += P^T dO (wgmma with P^T from registers as bf16, dO an MN-major
//   operand);
// - warpgroup 1: dP^T = V dO^T, then, after a named barrier on P^T,
//   dS^T = P^T (dP^T - D_q) scale in registers and dK += dS^T Q likewise.
//   dV and dK in one warpgroup would take 128 accumulator registers per
//   thread at Dh 128 besides the scores: the split keeps each near 112.
// - Q, dO, lse and D of the next query tile arrive through a two-stage ring
//   filled by cp.async (16 bytes a thread, straight into the swizzled layout;
//   lse and D per query, 4 bytes a thread) while the current one computes;
//   K and V are copied once.  One proxy fence and one __syncthreads per query
//   tile; the warpgroups meet once more on the named barrier.
// Shared memory at Dh 128: K, V, P^T (16 KB each) and two stages of Q, dO,
// lse and D (2 x 33 KB): 115 KB, one block per SM.
// Deterministic: every block sums its query tiles in one fixed order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace ctdb;

constexpr int TILE = 64;     // query rows and keys per tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// dq (K10); see the design note at the top.
constexpr int DQ_NWG = 2;                      // consumer warpgroups, one unit each
constexpr int DQ_THREADS = 128 * (DQ_NWG + 1);  // warpgroup 0 is the producer
constexpr int DQ_STAGES = 4;
constexpr int DQ_PRODUCER_REGS = 40;
constexpr int DQ_CONSUMER_REGS = 232;

template <int DH>
struct DqLayout {
  using Tile = SwTile<DH>;
  static constexpr int Q = 0;                          // DQ_NWG units' Q
  static constexpr int DO = Q + DQ_NWG * Tile::BYTES;  // and dO
  static constexpr int RING = DO + DQ_NWG * Tile::BYTES;
  // Offsets inside a stage; every tile starts on a 1024-byte boundary.
  static constexpr int K = 0;
  static constexpr int V = K + Tile::BYTES;
  static constexpr int STAGE_BYTES = 2 * Tile::BYTES;
  static constexpr int BARS = RING + DQ_STAGES * STAGE_BYTES;
  static constexpr int BYTES = BARS + (2 * DQ_STAGES + DQ_NWG) * 8 + 1024;  // + alignment
  // The mbarriers, after the ring: a stage's full and empty, a unit's Q / dO.
  __device__ static __forceinline__ uint32_t full_bar(uint32_t base, int s) {
    return base + BARS + 8 * s;
  }
  __device__ static __forceinline__ uint32_t empty_bar(uint32_t base, int s) {
    return base + BARS + 8 * (DQ_STAGES + s);
  }
  __device__ static __forceinline__ uint32_t unit_bar(uint32_t base, int w) {
    return base + BARS + 8 * (2 * DQ_STAGES + w);
  }
  // TMA boxes per tile: Dh / (SW / 2) column blocks of SW / 2 bf16 columns.
  static constexpr int BOX_COLS = Tile::SW / 2;
  static constexpr int BOXES = DH / BOX_COLS;
};

// The 64-row tile of `map` ([B, S, heads * Dh]) at rows [row0, row0 + 64)
// of batch b, columns [col0, col0 + Dh), into the swizzled tile at dst.
template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int col0,
                                         int row0, int b, uint32_t bar) {
  using L = DqLayout<DH>;
#pragma unroll
  for (int blk = 0; blk < L::BOXES; ++blk)
    tma_load_3d(dst + blk * L::Tile::BLOCK, map, col0 + blk * L::BOX_COLS, row0, b, bar);
}

// The consumer warpgroup w's unit: dQ of 64 query rows of one head over
// every key tile of the ring.
template <int DH>
__device__ __forceinline__ void dq_unit(unsigned char* smem, const float* __restrict__ bias,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ dsum,
                                        float* __restrict__ dq, int unit, int w, int g, int b,
                                        int S, int H, int rep, int nkt, float scale) {
  using L = DqLayout<DH>;
  using Tile = typename L::Tile;
  const uint32_t base = smem_u32(smem);

  const int h = g * rep + unit % rep;
  const int q0 = unit / rep * TILE;
  const int wtid = threadIdx.x % 128;
  const int warp = wtid / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  // This thread's query rows and their lse and D (rows >= S: zeros, never
  // written back).
  const int r0 = q0 + warp * 16 + gid;
  const int r1 = r0 + 8;
  const size_t lrow = (static_cast<size_t>(b) * H + h) * S;
  const float l0 = r0 < S ? lse[lrow + r0] : 0.0f;
  const float l1 = r1 < S ? lse[lrow + r1] : 0.0f;
  const float d0 = r0 < S ? dsum[lrow + r0] : 0.0f;
  const float d1 = r1 < S ? dsum[lrow + r1] : 0.0f;
  const uint32_t q_addr = base + L::Q + w * Tile::BYTES;
  const uint32_t do_addr = base + L::DO + w * Tile::BYTES;

  float acc[DH / 2];  // dQ [64 x Dh]
  float s[32];        // S [64 x 64 keys]
  float dp[32];       // dP
  uint32_t fa[4][4];  // dS as the bf16 A operand
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
  mbar_wait(L::unit_bar(base, w), 0);

  const float* biasb = bias + static_cast<size_t>(b) * S;
  for (int t = 0; t < nkt; ++t) {
    const int stage = t % DQ_STAGES;
    const uint32_t st = base + L::RING + stage * L::STAGE_BYTES;
    const int j0 = t * TILE;
    // The bias of this thread's 16 keys, loaded while the products run
    // (keys past S: any value, their p is set to 0).
    float bk[16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 8 * i + 2 * tig + e;
        bk[2 * i + e] = j < S ? biasb[j] : 0.0f;
      }
    mbar_wait(L::full_bar(base, stage), (t / DQ_STAGES) & 1);
    // S = Q K^T and dP = dO V^T, one group.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_m64n64(s, Tile::k_major(q_addr, kk), Tile::k_major(st + L::K, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_m64n64(dp, Tile::k_major(do_addr, kk), Tile::k_major(st + L::V, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - D) scale; keys past S carry p = 0.
    const bool ragged = j0 + TILE > S;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + 2 * tig;
      float p00 = exp2f((fmaf(s[4 * i], scale, bk[2 * i]) - l0) * LOG2E);
      float p01 = exp2f((fmaf(s[4 * i + 1], scale, bk[2 * i + 1]) - l0) * LOG2E);
      float p10 = exp2f((fmaf(s[4 * i + 2], scale, bk[2 * i]) - l1) * LOG2E);
      float p11 = exp2f((fmaf(s[4 * i + 3], scale, bk[2 * i + 1]) - l1) * LOG2E);
      if (ragged) {
        if (j0 + col >= S) p00 = p10 = 0.0f;
        if (j0 + col + 1 >= S) p01 = p11 = 0.0f;
      }
      const float s00 = __fmul_rn(__fmul_rn(p00, __fsub_rn(dp[4 * i], d0)), scale);
      const float s01 = __fmul_rn(__fmul_rn(p01, __fsub_rn(dp[4 * i + 1], d0)), scale);
      const float s10 = __fmul_rn(__fmul_rn(p10, __fsub_rn(dp[4 * i + 2], d1)), scale);
      const float s11 = __fmul_rn(__fmul_rn(p11, __fsub_rn(dp[4 * i + 3], d1)), scale);
      fa[i / 2][(i % 2) * 2] = pack_bf16(s00, s01);
      fa[i / 2][(i % 2) * 2 + 1] = pack_bf16(s10, s11);
    }
    // dQ += dS K; once it has retired, the stage may be refilled.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs<DH>(acc, fa[kk], Tile::mn_major(st + L::K, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) fence_regs(fa[kk]);
    if (wtid == 0) mbar_arrive(L::empty_bar(base, stage));
  }

  // dQ in f32, rows < S.
  const size_t q_stride = static_cast<size_t>(H) * DH;
  float* dst = dq + static_cast<size_t>(b) * S * q_stride + h * DH + 2 * tig;
  if (r0 < S) {
    float* row = dst + static_cast<size_t>(r0) * q_stride;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) = make_float2(acc[4 * i], acc[4 * i + 1]);
  }
  if (r1 < S) {
    float* row = dst + static_cast<size_t>(r1) * q_stride;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <int DH>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const float* __restrict__ bias, const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dq, int S,
                    int H, int KV, float scale) {
  using L = DqLayout<DH>;
  using Tile = typename L::Tile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int nt = (S + TILE - 1) / TILE;  // 64-row query tiles, and 64-key tiles
  const int first_unit = blockIdx.x * DQ_NWG;
  const int active = min(DQ_NWG, rep * nt - first_unit);  // units of this block
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(L::full_bar(base, s), 1);
      mbar_init(L::empty_bar(base, s), active);
    }
    for (int w = 0; w < DQ_NWG; ++w) mbar_init(L::unit_bar(base, w), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dec<DQ_PRODUCER_REGS>();
    if (tid != 0) return;
    tma_prefetch_map(&qmap);
    tma_prefetch_map(&domap);
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
    for (int w = 0; w < active; ++w) {
      const int unit = first_unit + w;
      const int h = g * rep + unit % rep;
      const int q0 = unit / rep * TILE;
      const uint32_t bar = L::unit_bar(base, w);
      mbar_arrive_expect_tx(bar, 2 * Tile::BYTES);
      tma_tile<DH>(base + L::Q + w * Tile::BYTES, &qmap, h * DH, q0, b, bar);
      tma_tile<DH>(base + L::DO + w * Tile::BYTES, &domap, h * DH, q0, b, bar);
    }
    for (int t = 0; t < nt; ++t) {
      const int s = t % DQ_STAGES;
      mbar_wait(L::empty_bar(base, s), ((t / DQ_STAGES) & 1) ^ 1);
      const uint32_t st = base + L::RING + s * L::STAGE_BYTES;
      const uint32_t full = L::full_bar(base, s);
      mbar_arrive_expect_tx(full, L::STAGE_BYTES);
      tma_tile<DH>(st + L::K, &kmap, g * DH, t * TILE, b, full);
      tma_tile<DH>(st + L::V, &vmap, g * DH, t * TILE, b, full);
    }
    return;
  }

  regs_inc<DQ_CONSUMER_REGS>();
  const int w = wg - 1;
  if (w < active)
    dq_unit<DH>(smem, bias, lse, dsum, dq, first_unit + w, w, g, b, S, H, rep, nt, scale);
}

// ---------------------------------------------------------------------------
// dk / dv (K11) on wgmma; see the design note at the top.
constexpr int DKV_THREADS = 256;  // warpgroup 0: P^T and dV; 1: dP^T, dS^T and dK

template <int DH>
struct DkvLayout {
  using Tile = SwTile<DH>;
  static constexpr int K = 0;                    // this block's keys, swizzled
  static constexpr int V = K + Tile::BYTES;
  static constexpr int P = V + Tile::BYTES;      // [64 x 64] f32 P^T, fragment order
  static constexpr int STAGE0 = P + TILE * TILE * 4;
  // Offsets inside a stage of the ring.
  static constexpr int Q = 0;
  static constexpr int DO = Q + Tile::BYTES;
  static constexpr int LSE = DO + Tile::BYTES;   // [64] f32 per query
  static constexpr int DSUM = LSE + TILE * 4;
  static constexpr int STAGE_BYTES = (DSUM + TILE * 4 + 1023) / 1024 * 1024;
  static constexpr int BYTES = STAGE0 + 2 * STAGE_BYTES + 1024;  // + base alignment
};

// Start the copies of query rows [i0, i0 + 64) of one head (q, dO, lse, D)
// into stage `stp` and commit them; rows >= S are zero-filled.
template <int DH>
__device__ __forceinline__ void issue_q_do(unsigned char* stp, const bf16* qb, const bf16* dob,
                                           const float* lse_h, const float* dsum_h,
                                           size_t q_stride, int i0, int S) {
  using L = DkvLayout<DH>;
  using Tile = typename L::Tile;
  constexpr int CH = DH / 8;
  const uint32_t st = smem_u32(stp);
  const int tid = threadIdx.x;
  for (int p = tid; p < TILE * CH; p += DKV_THREADS) {
    const int r = p / CH;
    const int c = p % CH;
    const int i = i0 + r;
    const bool ok = i < S;
    const size_t off = (ok ? i : 0) * q_stride + c * 8;
    cp_async16(st + L::Q + Tile::chunk(r, c), qb + off, ok);
    cp_async16(st + L::DO + Tile::chunk(r, c), dob + off, ok);
  }
  if (tid < TILE) {
    const int i = i0 + tid;
    const bool ok = i < S;
    cp_async4(st + L::LSE + tid * 4, lse_h + (ok ? i : 0), ok);
    cp_async4(st + L::DSUM + tid * 4, dsum_h + (ok ? i : 0), ok);
  }
  cp_async_commit();
}

template <int DH>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int KV, float scale) {
  using L = DkvLayout<DH>;
  using Tile = typename L::Tile;
  constexpr int CH = DH / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* pbuf = reinterpret_cast<float*>(smem + L::P);

  const int j0 = blockIdx.x * TILE;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int nqt = (S + TILE - 1) / TILE;
  const int n_it = rep * nqt;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const bf16* kb = k + static_cast<size_t>(b) * S * kv_stride + g * DH;
  const bf16* vb = v + static_cast<size_t>(b) * S * kv_stride + g * DH;
  const bf16* qbase = q + static_cast<size_t>(b) * S * q_stride;
  const bf16* dobase = dout + static_cast<size_t>(b) * S * q_stride;
  const size_t lse_base = static_cast<size_t>(b) * H * S;

  // K and V of this block's keys travel with the first query tile's group.
  const uint32_t k_addr = smem_u32(smem + L::K);
  const uint32_t v_addr = smem_u32(smem + L::V);
  for (int p = tid; p < TILE * CH; p += DKV_THREADS) {
    const int r = p / CH;
    const int c = p % CH;
    const int j = j0 + r;
    const bool ok = j < S;
    const size_t off = (ok ? j : 0) * kv_stride + c * 8;
    cp_async16(k_addr + Tile::chunk(r, c), kb + off, ok);
    cp_async16(v_addr + Tile::chunk(r, c), vb + off, ok);
  }
  {
    const int h = g * rep;
    issue_q_do<DH>(smem + L::STAGE0, qbase + h * DH, dobase + h * DH,
                   lse + lse_base + static_cast<size_t>(h) * S,
                   dsum + lse_base + static_cast<size_t>(h) * S, q_stride, 0, S);
  }

  // This thread's key rows (within the tile) and their bias.
  const int kr0 = warp * 16 + gid;
  const int kr1 = kr0 + 8;
  const float bk0 = j0 + kr0 < S ? bias[static_cast<size_t>(b) * S + j0 + kr0] : NEG_INF;
  const float bk1 = j0 + kr1 < S ? bias[static_cast<size_t>(b) * S + j0 + kr1] : NEG_INF;

  float acc[DH / 2];  // dV (warpgroup 0) or dK (warpgroup 1), [64 keys x Dh]
  float s[32];        // S^T (warpgroup 0) or dP^T (warpgroup 1), [64 keys x 64 queries]
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    unsigned char* stp = smem + L::STAGE0 + (it & 1) * L::STAGE_BYTES;
    cp_async_wait<0>();
    fence_proxy_async();
    // The tile is in place; both warpgroups are done with the previous one
    // (its stage and P^T may be overwritten).
    __syncthreads();
    if (it + 1 < n_it) {
      const int h = g * rep + (it + 1) / nqt;
      issue_q_do<DH>(smem + L::STAGE0 + ((it + 1) & 1) * L::STAGE_BYTES, qbase + h * DH,
                     dobase + h * DH, lse + lse_base + static_cast<size_t>(h) * S,
                     dsum + lse_base + static_cast<size_t>(h) * S, q_stride,
                     ((it + 1) % nqt) * TILE, S);
    }
    const int i0 = (it % nqt) * TILE;
    const uint32_t q_addr = smem_u32(stp + L::Q);
    const uint32_t do_addr = smem_u32(stp + L::DO);
    uint32_t fa[4][4];  // P^T or dS^T as the bf16 A operand

    if (wg == 0) {
      // S^T = K Q^T, then P^T = exp(S^T * scale + bias_key - lse_query).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_m64n64(s, Tile::k_major(k_addr, kk), Tile::k_major(q_addr, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      const float* ls = reinterpret_cast<const float*>(stp + L::LSE);
      const bool ragged = i0 + TILE > S;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * tig;
        const float2 lq = *reinterpret_cast<const float2*>(ls + col);
        float p00 = exp2f((fmaf(s[4 * i], scale, bk0) - lq.x) * LOG2E);
        float p01 = exp2f((fmaf(s[4 * i + 1], scale, bk0) - lq.y) * LOG2E);
        float p10 = exp2f((fmaf(s[4 * i + 2], scale, bk1) - lq.x) * LOG2E);
        float p11 = exp2f((fmaf(s[4 * i + 3], scale, bk1) - lq.y) * LOG2E);
        if (ragged) {  // query rows past S carry p = 0
          if (i0 + col >= S) p00 = p10 = 0.0f;
          if (i0 + col + 1 >= S) p01 = p11 = 0.0f;
        }
        s[4 * i] = p00;
        s[4 * i + 1] = p01;
        s[4 * i + 2] = p10;
        s[4 * i + 3] = p11;
        fa[i / 2][(i % 2) * 2] = pack_bf16(p00, p01);
        fa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p10, p11);
      }
      // P^T in f32 for warpgroup 1, whose thread wtid holds dP^T at the
      // same positions: thread-major, four floats at a time.
#pragma unroll
      for (int i = 0; i < 8; ++i)
        reinterpret_cast<float4*>(pbuf)[i * 128 + wtid] =
            make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      named_arrive(1, DKV_THREADS);
      // dV += P^T dO
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_rs<DH>(acc, fa[kk], Tile::mn_major(do_addr, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
    } else {
      // dP^T = V dO^T, then dS^T = P^T (dP^T - D_query) scale.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_m64n64(s, Tile::k_major(v_addr, kk), Tile::k_major(do_addr, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      const float* dsq = reinterpret_cast<const float*>(stp + L::DSUM);
      named_sync(1, DKV_THREADS);  // P^T is written
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p = reinterpret_cast<const float4*>(pbuf)[i * 128 + wtid];
        const float2 dq = *reinterpret_cast<const float2*>(dsq + 8 * i + 2 * tig);
        const float d00 = __fmul_rn(__fmul_rn(p.x, __fsub_rn(s[4 * i], dq.x)), scale);
        const float d01 = __fmul_rn(__fmul_rn(p.y, __fsub_rn(s[4 * i + 1], dq.y)), scale);
        const float d10 = __fmul_rn(__fmul_rn(p.z, __fsub_rn(s[4 * i + 2], dq.x)), scale);
        const float d11 = __fmul_rn(__fmul_rn(p.w, __fsub_rn(s[4 * i + 3], dq.y)), scale);
        fa[i / 2][(i % 2) * 2] = pack_bf16(d00, d01);
        fa[i / 2][(i % 2) * 2 + 1] = pack_bf16(d10, d11);
      }
      // dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma_rs<DH>(acc, fa[kk], Tile::mn_major(q_addr, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) fence_regs(fa[kk]);
  }

  // dV from warpgroup 0, dK from warpgroup 1; keys >= S are dropped.
  float* dst = (wg == 0 ? dv : dk) + static_cast<size_t>(b) * S * kv_stride + g * DH + 2 * tig;
  if (j0 + kr0 < S) {
    float* row = dst + static_cast<size_t>(j0 + kr0) * kv_stride;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) = make_float2(acc[4 * i], acc[4 * i + 1]);
  }
  if (j0 + kr1 < S) {
    float* row = dst + static_cast<size_t>(j0 + kr1) * kv_stride;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// The 3-D map [B, S, heads * Dh] of a bf16 q / k / v / dO tensor, read in
// boxes of 64 rows by SW / 2 columns with the tile's swizzle.
template <int DH>
int head_map(CUtensorMap* map, const void* t, int B, int S, int heads) {
  using L = DqLayout<DH>;
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * DH;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {row * 2, row * 2 * S};
  const cuuint32_t box[3] = {L::BOX_COLS, TILE, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, t, 3, dims, strides, box,
                    swizzle_mode(L::Tile::SW));
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const float* bias,
              const void* dout, const float* lse, const float* dsum, float* dq,
              int B, int S, int H, int KV, float scale, cudaStream_t stream) {
  CUtensorMap qmap, domap, kmap, vmap;
  int err = head_map<DH>(&qmap, q, B, S, H);
  if (!err) err = head_map<DH>(&domap, dout, B, S, H);
  if (!err) err = head_map<DH>(&kmap, k, B, S, KV);
  if (!err) err = head_map<DH>(&vmap, v, B, S, KV);
  if (err) return err;
  constexpr int bytes = DqLayout<DH>::BYTES;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int units = (H / KV) * ((S + TILE - 1) / TILE);
  dim3 grid((units + DQ_NWG - 1) / DQ_NWG, KV, B);
  flash_bwd_dq_kernel<DH><<<grid, DQ_THREADS, bytes, stream>>>(
      qmap, domap, kmap, vmap, bias, lse, dsum, dq, S, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, const float* lse, const float* dsum, float* dk,
               float* dv, int B, int S, int H, int KV, float scale,
               cudaStream_t stream) {
  constexpr int bytes = DkvLayout<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + TILE - 1) / TILE, KV, B);
  flash_bwd_dkv_kernel<DH><<<grid, DKV_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<const bf16*>(dout), lse,
      dsum, dk, dv, S, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, dout [B, S, H*Dh] bf16 (q rotated); k, v [B, S, KV*Dh] bf16 (k
// rotated); bias [B, S] f32; lse, dsum [B, H, S] f32; dq [B, S, H*Dh] f32.
int ctdb_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const float* bias, const void* dout,
                                const float* lse, const float* dsum, float* dq,
                                int B, int S, int H, int KV, int head_dim,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_dq<16>(q, k, v, bias, dout, lse, dsum, dq, B, S, H, KV, scale, st);
    case 32:
      return launch_dq<32>(q, k, v, bias, dout, lse, dsum, dq, B, S, H, KV, scale, st);
    case 64:
      return launch_dq<64>(q, k, v, bias, dout, lse, dsum, dq, B, S, H, KV, scale, st);
    case 128:
      return launch_dq<128>(q, k, v, bias, dout, lse, dsum, dq, B, S, H, KV, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above; dk, dv [B, S, KV*Dh] f32, summed over the H / KV query heads
// of each kv head.
int ctdb_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const float* bias, const void* dout,
                                 const float* lse, const float* dsum, float* dk,
                                 float* dv, int B, int S, int H, int KV,
                                 int head_dim, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_dkv<16>(q, k, v, bias, dout, lse, dsum, dk, dv, B, S, H, KV, scale, st);
    case 32:
      return launch_dkv<32>(q, k, v, bias, dout, lse, dsum, dk, dv, B, S, H, KV, scale, st);
    case 64:
      return launch_dkv<64>(q, k, v, bias, dout, lse, dsum, dk, dv, B, S, H, KV, scale, st);
    case 128:
      return launch_dkv<128>(q, k, v, bias, dout, lse, dsum, dk, dv, B, S, H, KV, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
