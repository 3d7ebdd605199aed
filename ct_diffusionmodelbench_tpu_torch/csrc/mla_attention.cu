// Multi-head latent attention (DeepSeek-V3's MLA, models/mla.py): the
// prefill's up-projected block-causal attention and K13, a block of queries
// against the latent cache in the absorbed form.
//
// Replaces (TPU): none.  The JAX package has no latent attention.  Added for
// kanana-2-30B-A3B decoded by block diffusion (models/sdar_cache.py).
//
// ---------------------------------------------------------------------------
// ctdb_mla_prefill_attention: K8's block-causal design
// (csrc/flash_attention.cu) at q/k heads of DQK 192 (128 nope + 64 rope
// dims) and v heads of DV 128, without its fused RoPE (q and k come rotated)
// and with each row's first real key in place of the padding bias.
//
// What it computes, per batch row b and head h (one kv head a query head):
//   q, k [B, S, H, DQK], v [B, S, H, DV] bf16; query i sees keys
//   key_start[b] <= j < (i / block_len + 1) * block_len; s = (q k^T) * scale
//   in f32, online softmax with f32 running max and sum, P cast to bf16 for
//   P V accumulated in f32, out = acc / max(l, 1e-30) in bf16 [B, S, H, DV].
//   A query that sees no key (padding in a block before the row's first real
//   key) gets zeros.
// Bound on an H100 SXM: operations.  At kanana30b-ctx32k's prefill (one row
// of up to 32512 positions, 32 heads) a layer computes ~2 * 0.5 S^2 * 32 *
// (192 + 128) FLOP, ~10.8 TFLOP at S 32512 (~11 ms at 989 TFLOP/s), against
// ~0.5 GB of q, k, v and out (~0.15 ms).
// Design: K8's, shapes aside.  Three consumer warpgroups a block, each a
// unit of 64 query rows of one head, the block's three units consecutive
// rows; K (24 KB) and V (16 KB) tiles of 64 keys flow through a two-stage
// cp.async ring; S = Q K^T by wgmma m64n64k16 over 12 k-steps from shared
// memory, the online softmax on the registers, P packed to bf16 in
// registers as the A operand of O += P V by wgmma m64n128k16.  The key loop
// starts at the tile that holds the row's first real key, so left padding
// costs no tile (every tile before it is skipped; inside it, keys before
// key_start are masked), and stops after the tile that holds the last key
// the block's last row sees.  Masked scores are -inf; a row's max is taken
// as 0 while it is -inf, so its P stays 0 and its sum 0.
// Shared memory: three Q tiles (72 KB) and two stages (80 KB): 153 KB.
//
// ---------------------------------------------------------------------------
// ctdb_mla_cache_attention, K13: the absorbed form of a block of queries
// over one layer's latent cache (the cached denoising step and the commit).
//
// What it computes, per batch row b: q [B, M, DQ] bf16, M = bl * H query
//   rows (position-major: row pos * H + h), each head's query in the latent
//   space (q_nope W_UK, 512 values) then its rotated rope part (64); the
//   cache [B, S, DQ], each key's latent c (512) then its rotated rope key
//   (64); row b's keys key_start[b] .. key_end - 1 (key_end read from device
//   memory, so a CUDA graph of a pass replays at any block); the value of a
//   key is its first DV = 512 values.  s = (q k^T) * scale in f32, P cast to
//   bf16 for P V summed in f32; out [B, M, DV] bf16 = softmax-weighted sum.
// Bound on an H100 SXM: both, near the card's ridge.  At kanana30b-ctx32k's
//   step (B 4, bl 4, H 32: 128 query rows share every key; ~24.6k keys a
//   row) a layer reads 4 x 24.6k x 1152 B of cache, ~113 MB (~34 us at 3.35
//   TB/s), and computes 2 x 128 x 24.6k x 4 x 1088 FLOP, ~27 GFLOP (~28 us at
//   989 TFLOP/s): ~240 FLOP a byte against ~295.
// Design (first design, right and simple; mma.sync, not wgmma):
// - Split-K: a block takes 64 query rows (ROWS) of one batch row and one of
//   SPLITS key ranges of equal length; 2 row tiles x 16 splits x 4 rows =
//   128 blocks at the cell's step, one wave.  The two row tiles of a range
//   run side by side and share its keys through L2.  Each block writes its
//   rows' f32 partial output (normalized by its own sum) and log-sum-exp;
//   the merge kernel (mla_latent_merge_kernel) weighs the splits and writes
//   bf16.  Empty ranges write a log-sum-exp of -inf and are skipped.
// - Keys flow through a two-stage cp.async ring of 32 keys (37 KB a stage);
//   the value is the first 512 columns of the same rows, so one copy serves
//   both products.  Q (64 x 576) stays in shared memory.  Rows are padded to
//   1168 bytes, so ldmatrix's eight row addresses hit distinct banks.
// - Three phases a tile, eight warps: (A) S = Q K^T, warp w the 16 rows
//   16 (w % 4) and the 16 keys 16 (w / 4), 36 k-steps of mma.sync m16n8k16,
//   into shared memory in f32; (B) the online softmax, four threads a row:
//   the running max and sum and each row's rescale factor live in shared
//   memory, P is written there in bf16; (C) O += P V, warp w the rows
//   16 (w % 4) and the 256 value columns 256 (w / 4): 128 f32 registers of
//   O a thread.  Registers, not shared memory, bound the row tile.
// Deterministic: no atomics; the merge sums the splits in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace ctdb;

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- prefill --

constexpr int BQ = 64;    // query rows per warpgroup (unit)
constexpr int BKV = 64;   // keys per K / V tile
constexpr int NWG = 3;    // consumer warpgroups per block
constexpr int PF_THREADS = 128 * NWG;

template <int DQK, int DV>
struct PrefillLayout {
  using QTile = SwTile<DQK>;
  using VTile = SwTile<DV>;
  static constexpr int Q = 0;
  static constexpr int STAGE0 = NWG * QTile::BYTES;
  static constexpr int K = 0;
  static constexpr int V = QTile::BYTES;
  static constexpr int STAGE_BYTES = (QTile::BYTES + VTile::BYTES + 1023) / 1024 * 1024;
  static constexpr int BYTES = STAGE0 + 2 * STAGE_BYTES + 1024;  // + base alignment
};

// The copies of keys [j0, j0 + 64) of one head into a stage, one group;
// keys >= S are zero-filled.
template <int DQK, int DV>
__device__ __forceinline__ void issue_prefill_kv(unsigned char* stp, const bf16* kb,
                                                 const bf16* vb, size_t k_stride,
                                                 size_t v_stride, int j0, int S) {
  using L = PrefillLayout<DQK, DV>;
  const uint32_t st = smem_u32(stp);
  for (int p = threadIdx.x; p < BKV * (DQK / 8); p += PF_THREADS) {
    const int r = p / (DQK / 8);
    const int c = p % (DQK / 8);
    const int j = j0 + r;
    const bool ok = j < S;
    cp_async16(st + L::K + L::QTile::chunk(r, c), kb + (ok ? j : 0) * k_stride + c * 8, ok);
  }
  for (int p = threadIdx.x; p < BKV * (DV / 8); p += PF_THREADS) {
    const int r = p / (DV / 8);
    const int c = p % (DV / 8);
    const int j = j0 + r;
    const bool ok = j < S;
    cp_async16(st + L::V + L::VTile::chunk(r, c), vb + (ok ? j : 0) * v_stride + c * 8, ok);
  }
  cp_async_commit();
}

template <int DQK, int DV>
__global__ void __launch_bounds__(PF_THREADS, 1)
mla_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ key_start,
                   bf16* __restrict__ out, int S, int H, float scale, int block_len) {
  using L = PrefillLayout<DQK, DV>;
  using QTile = typename L::QTile;
  using VTile = typename L::VTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nqt = (S + BQ - 1) / BQ;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int unit = blockIdx.x * NWG + wg;
  const bool active = unit < nqt;
  const int q0 = (active ? unit : 0) * BQ;

  const size_t qk_stride = static_cast<size_t>(H) * DQK;
  const size_t v_stride = static_cast<size_t>(H) * DV;
  const bf16* qb = q + static_cast<size_t>(b) * S * qk_stride + h * DQK;
  const bf16* kb = k + static_cast<size_t>(b) * S * qk_stride + h * DQK;
  const bf16* vb = v + static_cast<size_t>(b) * S * v_stride + h * DV;
  unsigned char* qs = smem + L::Q + wg * QTile::BYTES;
  const uint32_t q_addr = smem_u32(qs);

  const int first = key_start[b];
  const int last_unit = min(static_cast<int>(blockIdx.x) * NWG + NWG - 1, nqt - 1);
  const int q_last = min(last_unit * BQ + BQ, S) - 1;
  const int k_end = min(S, (q_last / block_len + 1) * block_len);
  const int kt0 = first / BKV;
  const int nkt = (k_end + BKV - 1) / BKV;

  if (kt0 < nkt)
    issue_prefill_kv<DQK, DV>(smem + L::STAGE0, kb, vb, qk_stride, v_stride, kt0 * BKV, S);
  if (active) {
    for (int p = wtid; p < BQ * (DQK / 8); p += 128) {
      const int r = p / (DQK / 8);
      const int c = p % (DQK / 8);
      const int i = q0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (i < S) val = *reinterpret_cast<const uint4*>(qb + static_cast<size_t>(i) * qk_stride + c * 8);
      *reinterpret_cast<uint4*>(qs + QTile::chunk(r, c)) = val;
    }
  }

  float o[DV / 2];
  float s[32];
  uint32_t pa[BKV / 16][4];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  const int r0 = q0 + warp * 16 + gid;
  const int end0 = min(S, (r0 / block_len + 1) * block_len);
  const int end1 = min(S, ((r0 + 8) / block_len + 1) * block_len);

  for (int t = kt0; t < nkt; ++t) {
    unsigned char* stp = smem + L::STAGE0 + ((t - kt0) & 1) * L::STAGE_BYTES;
    cp_async_wait<0>();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < nkt)
      issue_prefill_kv<DQK, DV>(smem + L::STAGE0 + ((t + 1 - kt0) & 1) * L::STAGE_BYTES, kb,
                                vb, qk_stride, v_stride, (t + 1) * BKV, S);
    if (!active) continue;

    const uint32_t k_addr = smem_u32(stp + L::K);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      wgmma_ss_m64n64(s, QTile::k_major(q_addr, kk), QTile::k_major(k_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = t * BKV + 8 * i + 2 * tig;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool real = j + e >= first;
        s[4 * i + e] = real && j + e < end0 ? s[4 * i + e] * scale : -INFINITY;
        s[4 * i + 2 + e] = real && j + e < end1 ? s[4 * i + 2 + e] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // A row that has seen no key yet keeps P and its rescale at 0.
    const float mu0 = mx0 == -INFINITY ? 0.0f : mx0;
    const float mu1 = mx1 == -INFINITY ? 0.0f : mx1;
    const float a0 = exp2f((m0 - mu0) * LOG2E);
    const float a1 = exp2f((m1 - mu1) * LOG2E);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p00 = exp2f((s[4 * i] - mu0) * LOG2E);
      const float p01 = exp2f((s[4 * i + 1] - mu0) * LOG2E);
      const float p10 = exp2f((s[4 * i + 2] - mu1) * LOG2E);
      const float p11 = exp2f((s[4 * i + 3] - mu1) * LOG2E);
      rs0 += p00 + p01;
      rs1 += p10 + p11;
      pa[i / 2][(i % 2) * 2] = pack_bf16(p00, p01);
      pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }

    const uint32_t v_addr = smem_u32(stp + L::V);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs<DV>(o, pa[kk], VTile::mn_major(v_addr, kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);

  if (!active) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  const int i1 = r0 + 8;
  bf16* ob = out + static_cast<size_t>(b) * S * v_stride + h * DV + 2 * tig;
  if (r0 < S) {
    uint32_t* row = reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * v_stride);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) row[4 * i] = pack_bf16(o[4 * i] / d0, o[4 * i + 1] / d0);
  }
  if (i1 < S) {
    uint32_t* row = reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(i1) * v_stride);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      row[4 * i] = pack_bf16(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
  }
}

// ------------------------------------------------------------------- K13 --

constexpr int DQ = 576;       // latent key width: c (512) then the rope key (64)
constexpr int DVL = 512;      // value width: c
constexpr int ROWS = 64;      // query rows a block
constexpr int KT = 32;        // keys a tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

struct CacheLayout {
  static constexpr int ROW = DQ * 2 + 16;                 // padded row bytes
  static constexpr int Q = 0;                             // [ROWS] rows
  static constexpr int STAGE0 = ROWS * ROW;
  static constexpr int STAGE_BYTES = KT * ROW;
  static constexpr int S_ROW = KT + 4;                    // f32 scores a row
  static constexpr int SC = STAGE0 + 2 * STAGE_BYTES;     // [ROWS][S_ROW] f32
  static constexpr int P_ROW = (KT + 8) * 2;              // bf16 P row bytes
  static constexpr int P = SC + ROWS * S_ROW * 4;         // [ROWS] rows
  static constexpr int M = P + ROWS * P_ROW;              // running max [ROWS]
  static constexpr int L = M + ROWS * 4;                  // running sum
  static constexpr int A = L + ROWS * 4;                  // rescale of the tile
  static constexpr int BYTES = A + ROWS * 4;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b, m16n8k16, bf16 in, f32 sums.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The copies of keys [k0, k0 + KT) into a stage, one group; keys at or past
// k_hi are zero-filled.
__device__ __forceinline__ void issue_keys(unsigned char* stp, const bf16* cb, int k0,
                                           int k_hi) {
  constexpr int CH = DQ / 8;
  const uint32_t st = smem_u32(stp);
  for (int p = threadIdx.x; p < KT * CH; p += THREADS) {
    const int r = p / CH;
    const int c = p % CH;
    const int j = k0 + r;
    const bool ok = j < k_hi;
    cp_async16(st + r * CacheLayout::ROW + c * 16,
               cb + static_cast<size_t>(ok ? j : 0) * DQ + c * 8, ok);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 1)
mla_latent_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ cache,
                      const int* __restrict__ key_start, const int* __restrict__ key_end,
                      float* __restrict__ part_o, float* __restrict__ part_lse, int S, int M,
                      int rows_pad, float scale) {
  using Ly = CacheLayout;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rt = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int mi = lane / 8;
  const int mr = lane % 8;
  const int rg = warp % 4;     // rows 16 rg .. 16 rg + 15
  const int half = warp / 4;   // phase A: keys 16 half ..; phase C: columns 256 half ..

  const bf16* cb = cache + static_cast<size_t>(b) * S * DQ;
  const int first = key_start[b];
  const int n_keys = min(*key_end, S);
  const int per = ((n_keys - first + splits - 1) / splits + KT - 1) / KT * KT;
  const int k_lo = first + split * per;
  const int k_hi = min(n_keys, k_lo + per);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + KT - 1) / KT : 0;
  const size_t part_row = (static_cast<size_t>(b) * splits + split) * rows_pad + rt * ROWS;

  if (n_tiles == 0) {
    if (tid < ROWS) part_lse[part_row + tid] = -INFINITY;
    return;
  }
  issue_keys(smem + Ly::STAGE0, cb, k_lo, k_hi);
  // The query rows (rows past M are zero), in the first tile's group.
  {
    constexpr int CH = DQ / 8;
    const uint32_t qs = smem_u32(smem + Ly::Q);
    const bf16* qb = q + static_cast<size_t>(b) * M * DQ;
    for (int p = tid; p < ROWS * CH; p += THREADS) {
      const int r = p / CH;
      const int c = p % CH;
      const int row = rt * ROWS + r;
      const bool ok = row < M;
      cp_async16(qs + r * Ly::ROW + c * 16, qb + static_cast<size_t>(ok ? row : 0) * DQ + c * 8,
                 ok);
    }
    cp_async_commit();
  }
  float* sm_s = reinterpret_cast<float*>(smem + Ly::SC);
  float* sm_m = reinterpret_cast<float*>(smem + Ly::M);
  float* sm_l = reinterpret_cast<float*>(smem + Ly::L);
  float* sm_a = reinterpret_cast<float*>(smem + Ly::A);
  if (tid < ROWS) {
    sm_m[tid] = -INFINITY;
    sm_l[tid] = 0.0f;
  }

  float o[32][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  const uint32_t q_lane =
      smem_u32(smem + Ly::Q + (16 * rg + (mi & 1) * 8 + mr) * Ly::ROW + (mi >> 1) * 16);
  const uint32_t p_lane =
      smem_u32(smem + Ly::P + (16 * rg + (mi & 1) * 8 + mr) * Ly::P_ROW + (mi >> 1) * 16);

  for (int c = 0; c < n_tiles; ++c) {
    if (c + 1 < n_tiles) {
      issue_keys(smem + Ly::STAGE0 + ((c + 1) & 1) * Ly::STAGE_BYTES, cb, k_lo + (c + 1) * KT,
                 k_hi);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* stp = smem + Ly::STAGE0 + (c & 1) * Ly::STAGE_BYTES;
    const int k0 = k_lo + c * KT;

    // (A) S = Q K^T: this warp's 16 rows by 16 keys.
    {
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const uint32_t k_lane =
          smem_u32(stp + (16 * half + (mi >> 1) * 8 + mr) * Ly::ROW + (mi & 1) * 16);
#pragma unroll 4
      for (int kk = 0; kk < DQ / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldmatrix_x4(a, q_lane + kk * 32);
        ldmatrix_x4(bk, k_lane + kk * 32);
        mma16816(s[0], a, bk[0], bk[1]);
        mma16816(s[1], a, bk[2], bk[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* row0 = sm_s + (16 * rg + gid) * Ly::S_ROW + 16 * half + 8 * j + 2 * tig;
        row0[0] = s[j][0];
        row0[1] = s[j][1];
        row0[8 * Ly::S_ROW] = s[j][2];
        row0[8 * Ly::S_ROW + 1] = s[j][3];
      }
    }
    __syncthreads();

    // (B) The online softmax: four threads a row, eight keys each.
    {
      const int row = tid / 4;
      const int part = tid % 4;
      const float* sr = sm_s + row * Ly::S_ROW + 8 * part;
      float x[8];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = k0 + 8 * part + e < k_hi ? sr[e] * scale : -INFINITY;
        mx = fmaxf(mx, x[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sm_m[row];
      const float m_new = fmaxf(m_old, mx);   // the tile's first key is real: finite
      float rs = 0.0f;
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float p0 = exp2f((x[e] - m_new) * LOG2E);
        const float p1 = exp2f((x[e + 1] - m_new) * LOG2E);
        rs += p0 + p1;
        packed[e / 2] = pack_bf16(p0, p1);
      }
      *reinterpret_cast<uint4*>(smem + Ly::P + row * Ly::P_ROW + 16 * part) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = exp2f((m_old - m_new) * LOG2E);
        sm_a[row] = alpha;
        sm_l[row] = sm_l[row] * alpha + rs;
        sm_m[row] = m_new;
      }
    }
    __syncthreads();

    // (C) O += P V: this warp's 16 rows by 256 value columns.
    {
      const float a_lo = sm_a[16 * rg + gid];
      const float a_hi = sm_a[16 * rg + gid + 8];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o[i][0] *= a_lo;
        o[i][1] *= a_lo;
        o[i][2] *= a_hi;
        o[i][3] *= a_hi;
      }
      const uint32_t v_lane =
          smem_u32(stp + ((mi & 1) * 8 + mr) * Ly::ROW + (mi >> 1) * 16 + half * 512);
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks) {
        uint32_t pa[4];
        ldmatrix_x4(pa, p_lane + ks * 32);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, v_lane + ks * 16 * Ly::ROW + i * 16);
          mma16816(o[i], pa, bv[0], bv[1]);
          mma16816(o[i + 1], pa, bv[2], bv[3]);
        }
      }
    }
    // Every warp is done with this stage, S and P before they are refilled.
    __syncthreads();
  }

  // This split's rows, normalized by their own sum, and their log-sum-exp.
  const int row0 = 16 * rg + gid;
  const float l_lo = sm_l[row0];
  const float l_hi = sm_l[row0 + 8];
  const float inv_lo = l_lo > 0.0f ? 1.0f / l_lo : 0.0f;
  const float inv_hi = l_hi > 0.0f ? 1.0f / l_hi : 0.0f;
  float* po = part_o + (part_row + row0) * DVL + 256 * half + 2 * tig;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    *reinterpret_cast<float2*>(po + 8 * i) = make_float2(o[i][0] * inv_lo, o[i][1] * inv_lo);
    *reinterpret_cast<float2*>(po + 8 * DVL + 8 * i) =
        make_float2(o[i][2] * inv_hi, o[i][3] * inv_hi);
  }
  if (tid < ROWS) {
    const float l = sm_l[tid];
    part_lse[part_row + tid] = l > 0.0f ? sm_m[tid] + logf(l) : -INFINITY;
  }
}

// One block a query row: the splits' partial outputs weighed by their
// log-sum-exps, in split order, into bf16.
constexpr int MERGE_THREADS = 128;

__global__ void __launch_bounds__(MERGE_THREADS)
mla_latent_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_lse,
                       bf16* __restrict__ out, int M, int rows_pad, int splits) {
  const int row = blockIdx.x;
  const int b = blockIdx.y;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, part_lse[(static_cast<size_t>(b) * splits + s) * rows_pad + row]);
  float acc[DVL / MERGE_THREADS];
#pragma unroll
  for (int i = 0; i < DVL / MERGE_THREADS; ++i) acc[i] = 0.0f;
  float den = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const size_t pr = (static_cast<size_t>(b) * splits + s) * rows_pad + row;
    const float lse = part_lse[pr];
    if (lse == -INFINITY) continue;
    const float w = exp2f((lse - mx) * LOG2E);
    den += w;
    const float4 x = reinterpret_cast<const float4*>(part_o + pr * DVL)[threadIdx.x];
    acc[0] += w * x.x;
    acc[1] += w * x.y;
    acc[2] += w * x.z;
    acc[3] += w * x.w;
  }
  const float inv = den > 0.0f ? 1.0f / den : 0.0f;
  uint2 packed = make_uint2(pack_bf16(acc[0] * inv, acc[1] * inv),
                            pack_bf16(acc[2] * inv, acc[3] * inv));
  reinterpret_cast<uint2*>(out + (static_cast<size_t>(b) * M + row) * DVL)[threadIdx.x] = packed;
}

}  // namespace

extern "C" {

// q, k [B, S, H, dqk], v [B, S, H, dv] bf16; key_start [B] int32; out [B, S,
// H, dv] bf16; (dqk, dv) = (192, 128); block_len >= 1.
int ctdb_mla_prefill_attention(const void* q, const void* k, const void* v,
                               const int* key_start, void* out, int B, int S, int H, int dqk,
                               int dv, int block_len, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || block_len < 1 || dqk != 192 || dv != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  using L = PrefillLayout<192, 128>;
  cudaError_t err = cudaFuncSetAttribute(mla_prefill_kernel<192, 128>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nqt = (S + BQ - 1) / BQ;
  dim3 grid((nqt + NWG - 1) / NWG, H, B);
  mla_prefill_kernel<192, 128><<<grid, PF_THREADS, L::BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_start, static_cast<bf16*>(out), S, H, scale, block_len);
  return static_cast<int>(cudaGetLastError());
}

// q [B, M, dq] bf16 (M = bl * H rows); cache [B, S, dq] bf16 (one layer);
// key_start [B] int32, each row's first key; key_end, one int32 in device
// memory (cut to S); part_o [B, splits, rows_pad, dv] f32 and part_lse [B,
// splits, rows_pad] f32 scratch, rows_pad = M rounded up to 64; out [B, M,
// dv] bf16.  (dq, dv) = (576, 512); 1 <= key_end - key_start[b].
int ctdb_mla_cache_attention(const void* q, const void* cache, const int* key_start,
                             const int* key_end, float* part_o, float* part_lse, void* out,
                             int B, int S, int M, int dq, int dv, int splits, float scale,
                             void* stream) {
  if (B < 1 || S < 1 || M < 1 || splits < 1 || dq != DQ || dv != DVL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      mla_latent_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CacheLayout::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (M + ROWS - 1) / ROWS;
  const int rows_pad = row_tiles * ROWS;
  mla_latent_attn_kernel<<<dim3(row_tiles, splits, B), THREADS, CacheLayout::BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(cache), key_start, key_end, part_o,
      part_lse, S, M, rows_pad, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_latent_merge_kernel<<<dim3(M, B), MERGE_THREADS, 0, st>>>(
      part_o, part_lse, static_cast<bf16*>(out), M, rows_pad, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
