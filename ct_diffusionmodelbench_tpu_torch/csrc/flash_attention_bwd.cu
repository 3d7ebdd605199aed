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
// Design, dq: one block of 8 warps per (64-row q tile, head, batch) loops
// over 64-key tiles; warps 0-3 compute the 16-row slices of S = Q K^T, warps
// 4-7 those of dP = dO V^T (WMMA bf16, f32 accumulators), both go through
// shared memory for the elementwise dS, then each warp adds dS K into half
// of its 16 rows' dQ columns, kept in registers for the whole key loop.
//
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace ctdb;
using namespace nvcuda;

constexpr int TILE = 64;     // query rows and keys per tile
constexpr int THREADS = 256;  // dq: 8 warps
constexpr float NEG_INF = -1e30f;

template <int DH>
struct Smem {
  static constexpr int LDH = DH + 8;    // bf16 [64, Dh] tiles
  static constexpr int LDS = TILE + 4;  // f32 [64, 64] tiles
  static constexpr int LDP = TILE + 8;  // bf16 [64, 64] tiles
  static constexpr int LDO = DH + 4;    // f32 [64, Dh] output staging
  static constexpr int TILE_H = TILE * LDH * 2;
  static constexpr int TILE_S = TILE * LDS * 4;
  static constexpr int TILE_P = TILE * LDP * 2;
  static constexpr int H0 = 0;
  static constexpr int H1 = H0 + TILE_H;
  static constexpr int H2 = H1 + TILE_H;
  static constexpr int H3 = H2 + TILE_H;
  static constexpr int S0 = H3 + TILE_H;
  static constexpr int S1 = S0 + TILE_S;
  static constexpr int P0 = S1 + TILE_S;
  static constexpr int BIAS = P0 + TILE_P;
  static constexpr int LSE = BIAS + TILE * 4;
  static constexpr int DSUM = LSE + TILE * 4;
  static constexpr int BYTES = DSUM + TILE * 4;
  // dq stages its [64, Dh] f32 result over the two score tiles.
  static_assert(TILE * LDO * 4 <= 2 * TILE_S, "dq staging does not fit");
};

// Rows [r0, r0 + 64) of one head (row stride `stride`) into a bf16 tile;
// rows >= S are zero.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int r0, int S) {
  constexpr int LDH = Smem<DH>::LDH;
  for (int p = threadIdx.x; p < TILE * DH / 8; p += THREADS) {
    const int r = p / (DH / 8);
    const int c = (p % (DH / 8)) * 8;
    const int i = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (i < S) val = *reinterpret_cast<const uint4*>(src + i * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// out[16 x 64] (f32, ld LDS) = A[16 x DH] . B^T, B a [64 x DH] tile: the
// scores of one warp's 16 rows against the 64 rows of B.
template <int DH>
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a,
                                                  const bf16* b) {
  constexpr int LDH = Smem<DH>::LDH;
  constexpr int LDS = Smem<DH>::LDS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TILE / 16];
#pragma unroll
  for (int n = 0; n < TILE / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DH; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk, LDH);
#pragma unroll
    for (int n = 0; n < TILE / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, b + n * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc[n], af, bf, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < TILE / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], LDS, wmma::mem_row_major);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dq,
                    int S, int H, int KV, float scale) {
  using L = Smem<DH>;
  constexpr int NF = DH / 16;          // 16-column fragments of a row slice
  constexpr int NACC = (NF + 1) / 2;   // this warp's half of them
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::H0);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::H1);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::H2);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::H3);
  float* Ss = reinterpret_cast<float*>(smem + L::S0);
  float* dPs = reinterpret_cast<float*>(smem + L::S1);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::P0);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* dsum_s = reinterpret_cast<float*>(smem + L::DSUM);

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int rw = warp % 4;    // 16-row slice of the tile
  const int half = warp / 4;  // which product / which output columns

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const size_t head_row = (static_cast<size_t>(b) * H + h) * S;
  const bf16* qb = q + static_cast<size_t>(b) * S * q_stride + h * DH;
  const bf16* dob = dout + static_cast<size_t>(b) * S * q_stride + h * DH;
  const bf16* kb = k + static_cast<size_t>(b) * S * kv_stride + kvh * DH;
  const bf16* vb = v + static_cast<size_t>(b) * S * kv_stride + kvh * DH;
  const float* biasb = bias + static_cast<size_t>(b) * S;

  load_tile<DH>(Qs, qb, q_stride, q0, S);
  load_tile<DH>(dOs, dob, q_stride, q0, S);
  if (tid < TILE) {
    const int i = q0 + tid;
    lse_s[tid] = i < S ? lse[head_row + i] : 0.0f;
    dsum_s[tid] = i < S ? dsum[head_row + i] : 0.0f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) wmma::fill_fragment(acc[a], 0.0f);

  const int nkt = (S + TILE - 1) / TILE;
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * TILE;
    __syncthreads();  // every warp is done with the previous K, V and dS
    load_tile<DH>(Ks, kb, kv_stride, j0, S);
    load_tile<DH>(Vs, vb, kv_stride, j0, S);
    if (tid < TILE) {
      const int j = j0 + tid;
      bias_s[tid] = j < S ? biasb[j] : NEG_INF;
    }
    __syncthreads();

    // S = Q K^T (warps 0-3) and dP = dO V^T (warps 4-7), 16 rows each.
    if (half == 0)
      rows_times_tile_t<DH>(Ss + rw * 16 * L::LDS, Qs + rw * 16 * L::LDH, Ks);
    else
      rows_times_tile_t<DH>(dPs + rw * 16 * L::LDS, dOs + rw * 16 * L::LDH, Vs);
    __syncthreads();

    // dS = P * (dP - D) * scale, rounded to bf16 for the dS K product.
    for (int p = tid; p < TILE * TILE; p += THREADS) {
      const int r = p / TILE;
      const int c = p % TILE;
      const float s = Ss[r * L::LDS + c] * scale + bias_s[c];
      const float pr = expf(s - lse_s[r]);
      const float ds = pr * (dPs[r * L::LDS + c] - dsum_s[r]) * scale;
      dSs[r * L::LDP + c] = __float2bfloat16(ds);
    }
    __syncthreads();

    // dQ[rows of rw, columns of this half] += dS K.
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, dSs + rw * 16 * L::LDP + kk, L::LDP);
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const int n = 2 * a + half;
        if (n < NF) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, Ks + kk * L::LDH + n * 16, L::LDH);
          wmma::mma_sync(acc[a], af, bf, acc[a]);
        }
      }
    }
  }

  // Stage dQ through shared memory (over the score tiles) and write the
  // rows < S.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem + L::S0);
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int n = 2 * a + half;
    if (n < NF)
      wmma::store_matrix_sync(stage + rw * 16 * L::LDO + n * 16, acc[a], L::LDO,
                              wmma::mem_row_major);
  }
  __syncthreads();
  float* dqb = dq + static_cast<size_t>(b) * S * q_stride + h * DH;
  for (int p = tid; p < TILE * DH; p += THREADS) {
    const int r = p / DH;
    const int c = p % DH;
    const int i = q0 + r;
    if (i < S) dqb[i * q_stride + c] = stage[r * L::LDO + c];
  }
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
  constexpr float LOG2E = 1.4426950408889634f;
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

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const float* bias,
              const void* dout, const float* lse, const float* dsum, float* dq,
              int B, int S, int H, int KV, float scale, cudaStream_t stream) {
  constexpr int bytes = Smem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + TILE - 1) / TILE, H, B);
  flash_bwd_dq_kernel<DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<const bf16*>(dout), lse,
      dsum, dq, S, H, KV, scale);
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
