// Bidirectional (non-causal) flash-attention forward with fused RoPE and GQA,
// and its block-causal mode.
//
// Replaces (TPU): ct_diffusionmodelbench_tpu/ops/flash_attention.py
//   flash_attention -> _run_forward -> _flash_kernel, with the optional
//   log-sum-exp output (with_lse) that the backward reads.
//
// Block-causal mode (ctdb_flash_attention_fwd_block_causal; no TPU kernel:
// the SDAR family's prefill, which the JAX package does not have): a query
// in block i / block_len sees the keys of its own and every earlier block,
// keys j < (i / block_len + 1) * block_len, on top of the padding bias.  A
// compile-time specialisation (the template's BLOCK_CAUSAL), so the
// bidirectional instantiation is the code it was.  A block stops its key
// loop after the tile that holds the last key its last query row sees, and
// inside that range each hidden score is set to -2e30, below the padding
// bias's -1e30: a row whose every visible key is padding then averages V
// over its visible keys, as the plain version does, and never over hidden
// ones.
//
// What it computes, per batch b, query head h (kv head h // rep):
//   q, k rotated by rotate-half RoPE in f32 from cos/sin [B, S, Dh/2] (each
//   product and sum rounded on its own, as PyTorch's elementwise ops do),
//   cast to bf16; s = (q k^T) * scale + bias, bias = 0 for a real key and
//   -1e30 for a padding key; online softmax with f32 running max and sum; P
//   cast to bf16 for P V, accumulated in f32; out = acc / max(l, 1e-30) in
//   bf16; with a non-null lse pointer also lse = m + log(max(l, 1e-30)) in
//   f32, [B, H, S] (a null pointer writes nothing extra: the serving path).
// Layout: heads in the last dim of the flat [B, S, H*Dh] / [B, S, KV*Dh]
// projection outputs, so no transpose is ever materialized.
// The reference pads the keys to its tile (kv_len >= S); keys S..kv_len-1
// are zero keys with bias -1e30 here too: their tiles are visited, filled
// with zeros by the copy itself, never read from memory.  They only matter
// for a row whose every key is masked, which averages V over kv_len keys.
//
// Bound on an H100 SXM: at the training shape (B 1, S 2048, H = KV = 32,
// Dh 128) 6.87e10 FLOP of products (0.069 ms at 989 TFLOP/s) against ~34 MB
// (0.010 ms at 3.35 TB/s): bound by operations.  At the decode shape (B 8,
// S 320, H 16, KV 4) 6.7 GFLOP (~7 us) against ~27 MB (~8 us): both tiny,
// so the wave shape and the per-block prologue weigh.
//
// Design (Hopper; hopper_mma.cuh has the layouts and instructions):
// - A block is three consumer warpgroups (384 threads) over three "units" of
//   one kv head; a unit is 64 query rows of one query head.  The units of kv
//   head g are its rep query heads times the 64-row query tiles, taken three
//   by three (head fastest), so all warpgroups read the same K / V tiles: for
//   rep > 1 several query heads share every rotated K tile, for rep 1 the
//   block holds 192 consecutive rows of one head.  Each K / V / cos / sin
//   tile brought from L2 and each rotation thus serves 192 query rows, not
//   128 as with two warpgroups, which is faster at the training and decode
//   shapes (PERF.md).  A warpgroup without a unit (a count that is not a
//   multiple of three) copies and rotates but issues no product.
// - Each warpgroup rotates its Q tile once, 16-byte loads, into shared memory.
// - K, V, the keys' cos / sin rows and the bias flow through a two-stage ring
//   of shared memory filled by cp.async, 16 bytes a thread, while the previous
//   tile computes.  V lands directly in the swizzled layout the wgmma
//   descriptor names.  Each thread rotates in place the K chunk pairs (d and
//   d + Dh/2 sit in different 16-byte chunks) whose bytes and cos / sin it
//   copied itself, so no barrier separates landing from rotating; one proxy
//   fence and one __syncthreads per tile publish the tile to wgmma.
// - S = Q K^T is wgmma m64n64k16 with both operands in shared memory; the f32
//   scores stay in registers (32 per thread).  The online softmax runs on
//   them: a thread holds 16 keys of two rows, the four threads of a quad hold
//   a row, so the row max and sum take two shuffles; the running max, the sum
//   (kept per thread, reduced once at the end) and the alpha rescale of the
//   accumulator stay in registers.
// - P is packed to bf16 in registers in the A-operand layout of the next
//   wgmma (the f32 score fragment maps onto it pair by pair), and O += P V is
//   wgmma m64n{Dh}k16 with A from registers and V an MN-major operand.  O
//   (64 x Dh f32, Dh/2 registers per thread) stays in registers over the
//   whole key loop and is divided by l once, in the epilogue.  P V is not
//   waited for at once: it runs while the next K tile is rotated, and ends
//   before the barrier after which that tile's stage is refilled.
// Registers per thread at Dh 128: O 64, scores 32, P 16, plus the running
// statistics and addresses; __launch_bounds__(384, 1) allows 168 (65536 /
// 384, in steps of 8), and chip_smoke.py prints ptxas's count and spills.
// Shared memory at Dh 128: three rotated Q tiles (48 KB) and two stages of
// K, V, cos, sin and bias (2 x 65 KB): 179 KB, one block per SM.
// Deterministic: no atomics, no split over keys; every block visits its
// keys in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace ctdb;

constexpr int BQ = 64;    // query rows per warpgroup (unit)
constexpr int BKV = 64;   // keys per K / V tile
constexpr int NWG = 3;    // consumer warpgroups per block
constexpr int THREADS = 128 * NWG;
constexpr float NEG_INF = -1e30f;
constexpr float HIDDEN = -2e30f;   // a key past the query's block (block-causal)
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Layout {
  using Tile = SwTile<DH>;
  static constexpr int Q = 0;                      // NWG rotated q tiles
  static constexpr int STAGE0 = NWG * Tile::BYTES;
  // Offsets inside a stage; every tile starts on a 1024-byte boundary.
  static constexpr int K = 0;
  static constexpr int V = K + Tile::BYTES;
  static constexpr int COS = V + Tile::BYTES;      // [64, Dh/2] f32
  static constexpr int SIN = COS + BKV * DH * 2;
  static constexpr int BIAS = SIN + BKV * DH * 2;  // [64] f32
  static constexpr int STAGE_BYTES = (BIAS + BKV * 4 + 1023) / 1024 * 1024;
  static constexpr int BYTES = STAGE0 + 2 * STAGE_BYTES + 1024;  // + base alignment
};

// Start the copies of the K / V tile at keys [j0, j0 + 64) into stage `stp`
// and commit them as one group.  Keys >= S are zero-filled, their bias
// -1e30.  Thread p of the pair loop copies K chunks (r, c) and (r, c + Dh/16)
// and their cos / sin: rotate_k gives it the same pairs.
template <int DH>
__device__ __forceinline__ void issue_kv(unsigned char* stp, const bf16* kb, const bf16* vb,
                                         const float* cb, const float* sb,
                                         const float* biasb, size_t kv_stride, int j0,
                                         int S) {
  using L = Layout<DH>;
  using Tile = typename L::Tile;
  constexpr int CH = DH / 8;   // 16-byte chunks per row
  constexpr int HC = CH / 2;   // chunk pairs per row
  constexpr int HALF = DH / 2;
  const uint32_t st = smem_u32(stp);
  const int tid = threadIdx.x;
  for (int p = tid; p < BKV * HC; p += THREADS) {
    const int r = p / HC;
    const int c = p % HC;
    const int j = j0 + r;
    const bool ok = j < S;
    const size_t row = ok ? j : 0;
    const bf16* src = kb + row * kv_stride + c * 8;
    cp_async16(st + L::K + Tile::chunk(r, c), src, ok);
    cp_async16(st + L::K + Tile::chunk(r, c + HC), src + HALF, ok);
    if (cb != nullptr) {
      const uint32_t off = (r * HALF + c * 8) * 4;
      const float* cs = cb + row * HALF + c * 8;
      const float* ss = sb + row * HALF + c * 8;
      cp_async16(st + L::COS + off, cs, ok);
      cp_async16(st + L::COS + off + 16, cs + 4, ok);
      cp_async16(st + L::SIN + off, ss, ok);
      cp_async16(st + L::SIN + off + 16, ss + 4, ok);
    }
  }
  for (int p = tid; p < BKV * CH; p += THREADS) {
    const int r = p / CH;
    const int c = p % CH;
    const int j = j0 + r;
    const bool ok = j < S;
    cp_async16(st + L::V + Tile::chunk(r, c), vb + (ok ? j : 0) * kv_stride + c * 8, ok);
  }
  if (tid < BKV) {
    const int j = j0 + tid;
    if (j < S)
      cp_async4(st + L::BIAS + tid * 4, biasb + j, true);
    else
      reinterpret_cast<float*>(stp + L::BIAS)[tid] = NEG_INF;
  }
  cp_async_commit();
}

// Rotate, in place, the K chunk pairs this thread copied (issue_kv's pairs).
template <int DH>
__device__ __forceinline__ void rotate_k(unsigned char* stp) {
  using L = Layout<DH>;
  using Tile = typename L::Tile;
  constexpr int HC = DH / 16;
  constexpr int HALF = DH / 2;
  const float* cosr = reinterpret_cast<const float*>(stp + L::COS);
  const float* sinr = reinterpret_cast<const float*>(stp + L::SIN);
  for (int p = threadIdx.x; p < BKV * HC; p += THREADS) {
    const int r = p / HC;
    const int c = p % HC;
    uint4* lo = reinterpret_cast<uint4*>(stp + L::K + Tile::chunk(r, c));
    uint4* hi = reinterpret_cast<uint4*>(stp + L::K + Tile::chunk(r, c + HC));
    float cv[8], sv[8];
    const float4* cp = reinterpret_cast<const float4*>(cosr + r * HALF + c * 8);
    const float4* sp = reinterpret_cast<const float4*>(sinr + r * HALF + c * 8);
    *reinterpret_cast<float4*>(cv) = cp[0];
    *reinterpret_cast<float4*>(cv + 4) = cp[1];
    *reinterpret_cast<float4*>(sv) = sp[0];
    *reinterpret_cast<float4*>(sv + 4) = sp[1];
    uint4 a = *lo, b = *hi;
    rope8(a, b, cv, sv);
    *lo = a;
    *hi = b;
  }
}

// Rows [i0, i0 + 64) of one query head, rotated, into a swizzled tile by the
// 128 threads of one warpgroup (wtid = thread within it); rows >= S are zero.
template <int DH>
__device__ __forceinline__ void load_q(unsigned char* qs, const bf16* qb, size_t q_stride,
                                       const float* cb, const float* sb, int i0, int S,
                                       int wtid) {
  using Tile = SwTile<DH>;
  constexpr int HC = DH / 16;
  constexpr int HALF = DH / 2;
  for (int p = wtid; p < BQ * HC; p += 128) {
    const int r = p / HC;
    const int c = p % HC;
    const int i = i0 + r;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (i < S) {
      const bf16* src = qb + static_cast<size_t>(i) * q_stride + c * 8;
      lo = *reinterpret_cast<const uint4*>(src);
      hi = *reinterpret_cast<const uint4*>(src + HALF);
      if (cb != nullptr) {
        float cv[8], sv[8];
        const float4* cp = reinterpret_cast<const float4*>(cb + static_cast<size_t>(i) * HALF + c * 8);
        const float4* sp = reinterpret_cast<const float4*>(sb + static_cast<size_t>(i) * HALF + c * 8);
        *reinterpret_cast<float4*>(cv) = cp[0];
        *reinterpret_cast<float4*>(cv + 4) = cp[1];
        *reinterpret_cast<float4*>(sv) = sp[0];
        *reinterpret_cast<float4*>(sv + 4) = sp[1];
        rope8(lo, hi, cv, sv);
      }
    }
    *reinterpret_cast<uint4*>(qs + Tile::chunk(r, c)) = lo;
    *reinterpret_cast<uint4*>(qs + Tile::chunk(r, c + HC)) = hi;
  }
}

template <int DH, bool BLOCK_CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ cosb, const float* __restrict__ sinb,
                 bf16* __restrict__ out, float* __restrict__ lse, int S,
                 int kv_len, int H, int KV, float scale, int block_len) {
  using L = Layout<DH>;
  using Tile = typename L::Tile;
  constexpr int HALF = DH / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int nqt = (S + BQ - 1) / BQ;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wtid = tid % 128;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int unit = blockIdx.x * NWG + wg;
  const bool active = unit < rep * nqt;
  const int h = g * rep + (active ? unit % rep : 0);
  const int q0 = (active ? unit / rep : 0) * BQ;

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const bf16* qb = q + static_cast<size_t>(b) * S * q_stride + h * DH;
  const bf16* kb = k + static_cast<size_t>(b) * S * kv_stride + g * DH;
  const bf16* vb = v + static_cast<size_t>(b) * S * kv_stride + g * DH;
  const float* cb = cosb == nullptr ? nullptr : cosb + static_cast<size_t>(b) * S * HALF;
  const float* sb = sinb == nullptr ? nullptr : sinb + static_cast<size_t>(b) * S * HALF;
  const float* biasb = bias + static_cast<size_t>(b) * S;
  unsigned char* qs = smem + L::Q + wg * Tile::BYTES;
  const uint32_t q_addr = smem_u32(qs);

  int nkt = kv_len / BKV;
  if constexpr (BLOCK_CAUSAL) {
    // The block's last unit holds its latest query rows; no row of the
    // block sees a key at or past the end of that row's block.
    const int last = min(static_cast<int>(blockIdx.x) * NWG + NWG - 1, rep * nqt - 1);
    const int q_last = min((last / rep) * BQ + BQ, S) - 1;
    const int k_end = min(S, (q_last / block_len + 1) * block_len);
    nkt = (k_end + BKV - 1) / BKV;
  }
  issue_kv<DH>(smem + L::STAGE0, kb, vb, cb, sb, biasb, kv_stride, 0, S);
  if (active) load_q<DH>(qs, qb, q_stride, cb, sb, q0, S, wtid);

  float o[DH / 2];
  float s[32];
  uint32_t pa[BKV / 16][4];  // P as the bf16 A operand of P V
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  // Running max and this thread's share of the sum, rows gid and gid + 8 of
  // the warp's 16.
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  for (int t = 0; t < nkt; ++t) {
    unsigned char* stp = smem + L::STAGE0 + (t & 1) * L::STAGE_BYTES;
    cp_async_wait<0>();
    if (cb != nullptr) rotate_k<DH>(stp);
    // Tile t - 1's P V ran during the rotation; it reads o, pa and the
    // stage that the copies below overwrite, so it ends before the barrier.
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);
    fence_proxy_async();
    // Tile t is in place for every thread; every warpgroup is done with
    // tile t - 1, whose stage the next copies overwrite.
    __syncthreads();
    if (t + 1 < nkt)
      issue_kv<DH>(smem + L::STAGE0 + ((t + 1) & 1) * L::STAGE_BYTES, kb, vb, cb, sb,
                   biasb, kv_stride, (t + 1) * BKV, S);
    if (!active) continue;

    // S = Q K^T
    const uint32_t k_addr = smem_u32(stp + L::K);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_m64n64(s, Tile::k_major(q_addr, kk), Tile::k_major(k_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Online softmax on the registers.
    const float* bs = reinterpret_cast<const float*>(stp + L::BIAS);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * i + 2 * tig);
      s[4 * i] = fmaf(s[4 * i], scale, bb.x);
      s[4 * i + 1] = fmaf(s[4 * i + 1], scale, bb.y);
      s[4 * i + 2] = fmaf(s[4 * i + 2], scale, bb.x);
      s[4 * i + 3] = fmaf(s[4 * i + 3], scale, bb.y);
      if constexpr (BLOCK_CAUSAL) {
        // Rows q0 + 16 warp + gid (+ 8) see keys below their block's end.
        const int r0 = q0 + warp * 16 + gid;
        const int end0 = (r0 / block_len + 1) * block_len;
        const int end1 = ((r0 + 8) / block_len + 1) * block_len;
        const int j = t * BKV + 8 * i + 2 * tig;
        if (j >= end0) s[4 * i] = HIDDEN;
        if (j + 1 >= end0) s[4 * i + 1] = HIDDEN;
        if (j >= end1) s[4 * i + 2] = HIDDEN;
        if (j + 1 >= end1) s[4 * i + 3] = HIDDEN;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f((m0 - mx0) * LOG2E);
    const float a1 = exp2f((m1 - mx1) * LOG2E);
    m0 = mx0;
    m1 = mx1;
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p00 = exp2f((s[4 * i] - mx0) * LOG2E);
      const float p01 = exp2f((s[4 * i + 1] - mx0) * LOG2E);
      const float p10 = exp2f((s[4 * i + 2] - mx1) * LOG2E);
      const float p11 = exp2f((s[4 * i + 3] - mx1) * LOG2E);
      r0 += p00 + p01;
      r1 += p10 + p11;
      pa[i / 2][(i % 2) * 2] = pack_bf16(p00, p01);
      pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }

    // O += P V, waited for at the top of the next tile (or below).
    const uint32_t v_addr = smem_u32(stp + L::V);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs<DH>(o, pa[kk], Tile::mn_major(v_addr, kk), 1);
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
  const int i0 = q0 + warp * 16 + gid;
  const int i1 = i0 + 8;
  bf16* ob = out + static_cast<size_t>(b) * S * q_stride + h * DH + 2 * tig;
  if (i0 < S) {
    uint32_t* row = reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(i0) * q_stride);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) row[4 * i] = pack_bf16(o[4 * i] / d0, o[4 * i + 1] / d0);
  }
  if (i1 < S) {
    uint32_t* row = reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(i1) * q_stride);
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      row[4 * i] = pack_bf16(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
  }
  if (lse != nullptr && tig == 0) {
    float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
    if (i0 < S) lb[i0] = m0 + logf(d0);
    if (i1 < S) lb[i1] = m1 + logf(d1);
  }
}

template <int DH, bool BLOCK_CAUSAL>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const float* cosb, const float* sinb, void* out, float* lse, int B,
           int S, int kv_len, int H, int KV, float scale, int block_len,
           cudaStream_t stream) {
  constexpr int bytes = Layout<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH, BLOCK_CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = (H / KV) * ((S + BQ - 1) / BQ);
  dim3 grid((units + NWG - 1) / NWG, KV, B);
  flash_fwd_kernel<DH, BLOCK_CAUSAL><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, cosb, sinb, static_cast<bf16*>(out),
      lse, S, kv_len, H, KV, scale, block_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool BLOCK_CAUSAL>
int dispatch(const void* q, const void* k, const void* v, const float* bias,
             const float* cosb, const float* sinb, void* out, float* lse, int B, int S,
             int kv_len, int H, int KV, int head_dim, float scale, int block_len,
             void* stream) {
  if (S < 1 || kv_len < S || kv_len % BKV != 0 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16, BLOCK_CAUSAL>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len,
                                      H, KV, scale, block_len, st);
    case 32:
      return launch<32, BLOCK_CAUSAL>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len,
                                      H, KV, scale, block_len, st);
    case 64:
      return launch<64, BLOCK_CAUSAL>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len,
                                      H, KV, scale, block_len, st);
    case 128:
      return launch<128, BLOCK_CAUSAL>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len,
                                       H, KV, scale, block_len, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [B, S, H*Dh], k/v [B, S, KV*Dh] bf16; bias [B, S] f32; cos/sin
// [B, S, Dh/2] f32 or both null (no RoPE); out [B, S, H*Dh] bf16; lse
// [B, H, S] f32 or null.  kv_len >= S, a multiple of 64: keys S..kv_len-1
// count as zero keys with bias -1e30.
int ctdb_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const float* bias, const float* cosb,
                             const float* sinb, void* out, float* lse, int B,
                             int S, int kv_len, int H, int KV, int head_dim,
                             float scale, void* stream) {
  return dispatch<false>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H, KV,
                         head_dim, scale, 0, stream);
}

// As ctdb_flash_attention_fwd, block-causal over blocks of block_len >= 1
// positions: query i sees keys j < (i / block_len + 1) * block_len.
int ctdb_flash_attention_fwd_block_causal(const void* q, const void* k, const void* v,
                                          const float* bias, const float* cosb,
                                          const float* sinb, void* out, float* lse,
                                          int B, int S, int kv_len, int H, int KV,
                                          int head_dim, float scale, int block_len,
                                          void* stream) {
  if (block_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H, KV,
                        head_dim, scale, block_len, stream);
}

}  // extern "C"
