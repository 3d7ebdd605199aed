// Bidirectional flash-attention forward for keys that fit one kv tile:
// one direct softmax per query row, no running max.
//
// Replaces (TPU): ct_diffusionmodelbench_tpu/ops/flash_attention.py
//   flash_attention -> _run_forward -> _flash_kernel_direct, the opt-in
//   (CTDB_FLASH_DIRECT=1) kernel for calls whose padded key length is one kv
//   tile (sk_pad == tk: every S <= 1024), the B = 1 / short-S serving shape.
//   With a non-null lse pointer it also writes the log-sum-exp, as
//   _flash_kernel_direct does under with_lse.
//
// What it computes, per batch b, query head h (kv head h // rep, any rep):
//   q, k rotated by rotate-half RoPE in f32 from cos/sin [B, S, Dh/2] (each
//   product and sum rounded on its own, as PyTorch's elementwise ops do),
//   cast to bf16; s = (q k^T) * scale + bias over all kv_len keys (bias 0
//   for a real key, -1e30 for padding and for keys S..kv_len-1, which are
//   zero keys); m = max(max_j s, -1e30), the true row max, taken before any
//   exp; p = exp(s - m); l = sum p (f32); P = bf16(p); out = (P V) /
//   max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30)) when asked.  This
//   is the arithmetic of ops/flash_attention.py::flash_attention_plain, max
//   for max, so the kernel holds to one bf16 ulp of it (the online-softmax
//   K8 rescales by running maxima and holds to two).
//
// Bound on an H100 SXM at the single-prompt chat shape (B 1, S 512, H 16,
// KV 4, Dh 128): 2.1 GFLOP of the function's two products (~2.2 us at 989
// TFLOP/s) against ~5 MB of q, k, v, out, bias and RoPE tables (~1.6 us at
// 3.35 TB/s); Dream's H 28 doubles the products.  A few microseconds of
// work: what sets the time is the chain of dependent steps inside one block
// (a block's time does not change between 32 and 128 blocks), and shared
// memory's bandwidth inside a step (PERF.md).
//
// Design (Hopper; hopper_mma.cuh has the layouts and instructions):
// - A unit is 64 query rows of one query head.  A block holds NWG consumer
//   warpgroups over units of one kv head, its rep query heads fastest (as
//   K8 takes them), so each K / V tile brought from L2 and each rotation of
//   a K tile serves every warpgroup of the block.  With K resident (below)
//   NWG is 1 when one unit per block already fits the card's SMs in one wave
//   (the chat shape), else 2 (Dream's rep 7); streamed, always 2.  A
//   warpgroup without a unit copies and rotates but issues no product.
// - Each warpgroup rotates its Q tile once, into shared memory and from
//   there into registers: Q is the register A operand of every Q K^T, which
//   halves that product's shared-memory reads.
// - Two passes over the keys in 64-key tiles.  Pass 1: S = Q K^T on RS
//   wgmma m64n64k16 into 32 registers, scaled and biased in registers; only
//   the row max is kept (per thread over its 16 keys of two rows, reduced
//   over the quad once, at the end of the pass): no exp.  Pass 2: S again;
//   p = exp(s - m) with the final m; l summed per thread and reduced once at
//   the end; P packed to bf16 in registers in the A-operand layout; O += P V
//   on RS wgmma m64n{Dh}k16 with O in registers over the whole row and V an
//   MN-major operand.  Pass 2 costs 1.5x K8's products.
// - Each K tile is rotated in place with cos / sin that each thread loaded
//   from device memory into registers during the step before (they never
//   pass through shared memory).
// - Rotated K stays resident in shared memory through both passes where it
//   fits beside two warpgroups' Q tiles (kv_len * Dh * 2 bytes: every
//   kv_len at Dh <= 64, kv_len <= 512 at Dh 128; "RES").  Then every K tile
//   is copied at the start, pass 1 rotates them one by one, and the
//   four-slot ring holds only V, three tiles ahead.  Otherwise K streams
//   through a two-stage ring of K and V tiles a second time and is rotated
//   again.
// - Copies are cp.async, 16 bytes a thread; each thread rotates in place the
//   K chunk pairs whose bytes it copied itself, so no barrier separates
//   landing from rotating; one proxy fence and one __syncthreads per step
//   publish a tile to wgmma.  P V is not waited for at once: it runs while
//   the next tile is awaited (and, without RES, rotated), and ends before
//   the barrier after which its V slot is refilled.
// - Epilogue: O / max(l, 1e-30) is packed to bf16 into the warpgroup's Q
//   tile and leaves as 16-byte row chunks; lse is written from registers.
// Registers per thread at Dh 128: O 64, Q 32, S 32, P 16, cos / sin 16 per
// K chunk pair it rotates (4 pairs with one warpgroup, 2 with two), plus the
// statistics and addresses; chip_smoke.py prints ptxas's count and spills.
// Shared memory at Dh 128, kv_len 512, two warpgroups: two Q tiles (32 KB),
// resident K (128 KB), four V slots (64 KB), the bias row: 227 KB, one
// block per SM.
// Deterministic: no atomics, no split over keys; every block visits its
// keys in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper_mma.cuh"

namespace {

using namespace ctdb;

constexpr int BQ = 64;            // query rows per warpgroup (unit)
constexpr int BKV = 64;           // keys per K / V tile
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have
constexpr float NEG_INF = -1e30f;

// One stage of the ring without RES: a K tile and a V tile.
template <int DH>
struct Stage {
  static constexpr int K = 0;
  static constexpr int V = SwTile<DH>::BYTES;
  static constexpr int BYTES = 2 * SwTile<DH>::BYTES;
};

// Shared memory of a block: NWG rotated Q tiles; with RES the rotated K of
// the whole row; the ring (with RES four V slots of one tile, else two
// Stages); the bias row.  Every tile starts on a 1024-byte boundary.
template <int DH, int NWG, bool RES>
struct Layout {
  using Tile = SwTile<DH>;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int TB = Tile::BYTES;  // one 64-row bf16 tile
  static constexpr int Q = 0;
  static constexpr int KRES = NWG * TB;
  static constexpr int RING = RES ? 4 * TB : 2 * Stage<DH>::BYTES;
  __host__ __device__ static int ring(int kv_len) {
    return KRES + (RES ? kv_len / BKV * TB : 0);
  }
  __host__ __device__ static int bias(int kv_len) { return ring(kv_len) + RING; }
  static int bytes(int kv_len) { return bias(kv_len) + kv_len * 4 + 1024; }  // + alignment
};

// The copies below start cp.async transfers of the 64 keys at j0 and commit
// nothing; keys >= S are zero-filled.  Thread p of the pair loop copies K
// chunks (r, c) and (r, c + Dh/16) of a tile; CsRegs gives it the same
// pairs, so it rotates only bytes it copied.
template <int DH, int THREADS>
__device__ __forceinline__ void copy_k(uint32_t kt, const bf16* kb, size_t kv_stride, int j0,
                                       int S) {
  using Tile = SwTile<DH>;
  constexpr int HC = DH / 16;
  for (int p = threadIdx.x; p < BKV * HC; p += THREADS) {
    const int r = p / HC;
    const int c = p % HC;
    const int j = j0 + r;
    const bool ok = j < S;
    const bf16* src = kb + (ok ? j : 0) * kv_stride + c * 8;
    cp_async16(kt + Tile::chunk(r, c), src, ok);
    cp_async16(kt + Tile::chunk(r, c + HC), src + DH / 2, ok);
  }
}

template <int DH, int THREADS>
__device__ __forceinline__ void copy_v(uint32_t vt, const bf16* vb, size_t kv_stride, int j0,
                                       int S) {
  using Tile = SwTile<DH>;
  constexpr int CH = DH / 8;
  for (int p = threadIdx.x; p < BKV * CH; p += THREADS) {
    const int r = p / CH;
    const int c = p % CH;
    const int j = j0 + r;
    const bool ok = j < S;
    cp_async16(vt + Tile::chunk(r, c), vb + (ok ? j : 0) * kv_stride + c * 8, ok);
  }
}

// The cos / sin of this thread's K chunk pairs of one tile (the pairs
// copy_k gave it), loaded from device memory into registers a step before
// the rotation needs them, so they never pass through shared memory (zeros
// for keys >= S).
template <int DH, int THREADS>
struct CsRegs {
  static constexpr int HC = DH / 16;
  static constexpr int PAIRS = BKV * HC;
  static constexpr int IT = (PAIRS + THREADS - 1) / THREADS;
  float4 c[IT][2], s[IT][2];

  __device__ __forceinline__ void load(const float* cb, const float* sb, int j0, int S) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int p = threadIdx.x + it * THREADS;
      const int j = j0 + p / HC;
      c[it][0] = c[it][1] = s[it][0] = s[it][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < PAIRS && j < S) {
        const size_t off = static_cast<size_t>(j) * (DH / 2) + (p % HC) * 8;
        c[it][0] = __ldg(reinterpret_cast<const float4*>(cb + off));
        c[it][1] = __ldg(reinterpret_cast<const float4*>(cb + off + 4));
        s[it][0] = __ldg(reinterpret_cast<const float4*>(sb + off));
        s[it][1] = __ldg(reinterpret_cast<const float4*>(sb + off + 4));
      }
    }
  }

  // Rotate this thread's pairs of the K tile at kt in place.
  __device__ __forceinline__ void rotate(unsigned char* kt) const {
    using Tile = SwTile<DH>;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int p = threadIdx.x + it * THREADS;
      if (p >= PAIRS) continue;
      uint4* lo = reinterpret_cast<uint4*>(kt + Tile::chunk(p / HC, p % HC));
      uint4* hi = reinterpret_cast<uint4*>(kt + Tile::chunk(p / HC, p % HC + HC));
      uint4 a = *lo, b = *hi;
      rope8(a, b, reinterpret_cast<const float*>(c[it]), reinterpret_cast<const float*>(s[it]));
      *lo = a;
      *hi = b;
    }
  }
};

// Without RES, step n's copies into stage n & 1: pass 1 (n < nkt) K tile n;
// pass 2 K tile n - nkt again and V.
template <int DH, int NWG>
__device__ __forceinline__ void issue_stream(uint32_t ring, int n, int nkt, const bf16* kb,
                                             const bf16* vb, size_t kv_stride, int S) {
  using St = Stage<DH>;
  constexpr int THREADS = 128 * NWG;
  const uint32_t st = ring + (n & 1) * St::BYTES;
  const int j0 = (n % nkt) * BKV;
  copy_k<DH, THREADS>(st + St::K, kb, kv_stride, j0, S);
  if (n >= nkt) copy_v<DH, THREADS>(st + St::V, vb, kv_stride, j0, S);
  cp_async_commit();
}

// Rows [i0, i0 + 64) of one query head, rotated, into a swizzled tile by the
// 128 threads of one warpgroup (wtid = thread within it); rows >= S are zero.
// Every load is issued before the first rotation, so they travel together.
template <int DH>
__device__ __forceinline__ void load_q(unsigned char* qs, const bf16* qb, size_t q_stride,
                                       const float* cb, const float* sb, int i0, int S,
                                       int wtid) {
  using Tile = SwTile<DH>;
  constexpr int HC = DH / 16;
  constexpr int HALF = DH / 2;
  constexpr int N = BQ * HC;
  constexpr int IT = (N + 127) / 128;
  uint4 lo[IT], hi[IT];
  float4 cv[IT][2], sv[IT][2];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int p = wtid + it * 128;
    const int i = i0 + p / HC;
    lo[it] = hi[it] = make_uint4(0u, 0u, 0u, 0u);
    if (p < N && i < S) {
      const bf16* src = qb + static_cast<size_t>(i) * q_stride + (p % HC) * 8;
      lo[it] = *reinterpret_cast<const uint4*>(src);
      hi[it] = *reinterpret_cast<const uint4*>(src + HALF);
      if (cb != nullptr) {
        const size_t off = static_cast<size_t>(i) * HALF + (p % HC) * 8;
        cv[it][0] = *reinterpret_cast<const float4*>(cb + off);
        cv[it][1] = *reinterpret_cast<const float4*>(cb + off + 4);
        sv[it][0] = *reinterpret_cast<const float4*>(sb + off);
        sv[it][1] = *reinterpret_cast<const float4*>(sb + off + 4);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int p = wtid + it * 128;
    if (p >= N) continue;
    const int r = p / HC;
    const int c = p % HC;
    if (cb != nullptr && i0 + r < S)
      rope8(lo[it], hi[it], reinterpret_cast<const float*>(cv[it]),
            reinterpret_cast<const float*>(sv[it]));
    *reinterpret_cast<uint4*>(qs + Tile::chunk(r, c)) = lo[it];
    *reinterpret_cast<uint4*>(qs + Tile::chunk(r, c + HC)) = hi[it];
  }
}

// This warpgroup's rotated Q tile as the register A operand of Q K^T:
// k-step kk, register 2 u + h holds row 16 warp + gid + 8 h, columns
// 16 kk + 8 u + 2 tig and the next (hopper_mma.cuh's fragment layout).
template <int DH>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[DH / 16][4],
                                             const unsigned char* qs, int warp, int gid,
                                             int tig) {
  using Tile = SwTile<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      qa[kk][j] = *reinterpret_cast<const uint32_t*>(
          qs + Tile::chunk(16 * warp + gid + 8 * (j % 2), 2 * kk + j / 2) + 4 * tig);
}

// Issue S = Q K^T of one 64-key tile into s: Q from registers, the K tile
// a K-major operand in shared memory (asynchronous; one commit).
template <int DH>
__device__ __forceinline__ void qk_issue(float (&s)[32], const uint32_t (&qa)[DH / 16][4],
                                         uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_rs_m64n64<0>(s, qa[kk], SwTile<DH>::k_major(k_addr, kk), kk > 0);
  wgmma_commit();
}

// s = s * scale + bias for the 64 keys at j0 (accumulator layout: a thread
// holds keys 8 i + 2 tig + e of rows gid and gid + 8), rounded as the plain
// version rounds (product, then sum).
__device__ __forceinline__ void scale_bias(float (&s)[32], const float* bias, int j0,
                                           float scale, int tig) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + j0 + 8 * i + 2 * tig);
    s[4 * i] = __fadd_rn(__fmul_rn(s[4 * i], scale), bb.x);
    s[4 * i + 1] = __fadd_rn(__fmul_rn(s[4 * i + 1], scale), bb.y);
    s[4 * i + 2] = __fadd_rn(__fmul_rn(s[4 * i + 2], scale), bb.x);
    s[4 * i + 3] = __fadd_rn(__fmul_rn(s[4 * i + 3], scale), bb.y);
  }
}

// p = exp(s - m) into P (bf16, the A-operand layout of P V) and this
// thread's share of l; then O += P V issued on the V tile at v_addr (one
// commit, not waited for).
template <int DH>
__device__ __forceinline__ void softmax_pv(const float (&s)[32], float m0, float m1,
                                           float& l0, float& l1, uint32_t (&pa)[BKV / 16][4],
                                           float (&o)[DH / 2], uint32_t v_addr) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float p00 = expf(s[4 * i] - m0);
    const float p01 = expf(s[4 * i + 1] - m0);
    const float p10 = expf(s[4 * i + 2] - m1);
    const float p11 = expf(s[4 * i + 3] - m1);
    l0 += p00 + p01;
    l1 += p10 + p11;
    pa[i / 2][(i % 2) * 2] = pack_bf16(p00, p01);
    pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p10, p11);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_rs<DH>(o, pa[kk], SwTile<DH>::mn_major(v_addr, kk), 1);
  wgmma_commit();
}

// Wait for the issued P V products and tie o and P to this point.
template <int N>
__device__ __forceinline__ void wait_pv(float (&o)[N], uint32_t (&pa)[BKV / 16][4]) {
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pa[kk]);
}

// Copy schedule.  Pass 1 visits the K tiles t = 0 .. nkt-1, pass 2 the same
// tiles again; each step has one __syncthreads.
// - With RES: the first cp.async group holds every K tile and the bias, the
//   second V tiles 0-3 (one per ring slot).  Pass-1 step t rotates K tile t
//   with the cos / sin registers loaded during step t - 1, then loads tile
//   t + 1's.  After pass-2 step t's barrier (P V of tile t - 1 done) slot
//   (t - 1) % 4 takes V tile t + 3; every pass-2 step commits one group
//   (maybe empty), so a step waits for all but the newest min(t, 2).
// - Without RES: one stage ahead, a K tile in both passes and V in pass 2;
//   a step waits for all its groups.
template <int DH, int NWG, bool RES>
__global__ void __launch_bounds__(128 * NWG, 1)
flash_direct_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ cosb, const float* __restrict__ sinb,
                    bf16* __restrict__ out, float* __restrict__ lse, int S,
                    int kv_len, int H, int KV, float scale) {
  using L = Layout<DH, NWG, RES>;
  using Tile = typename L::Tile;
  constexpr int THREADS = L::THREADS;
  constexpr int TB = L::TB;
  constexpr int HALF = DH / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int nqt = (S + BQ - 1) / BQ;
  const int nkt = kv_len / BKV;
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
  unsigned char* qs = smem + L::Q + wg * TB;
  [[maybe_unused]] unsigned char* kres = smem + L::KRES;
  unsigned char* ring = smem + L::ring(kv_len);
  const uint32_t ring_a = smem_u32(ring);
  float* bias_s = reinterpret_cast<float*>(smem + L::bias(kv_len));

  // The first group(s): the bias of the real keys (-1e30 stored for the
  // rest) and the first tiles.
  for (int j = tid; j < kv_len; j += THREADS) {
    if (j < S)
      cp_async4(smem_u32(bias_s + j), biasb + j, true);
    else
      bias_s[j] = NEG_INF;
  }
  if constexpr (RES) {
    for (int t = 0; t < nkt; ++t)
      copy_k<DH, THREADS>(smem_u32(kres + t * TB), kb, kv_stride, t * BKV, S);
    cp_async_commit();
    for (int u = 0; u < 4 && u < nkt; ++u)
      copy_v<DH, THREADS>(ring_a + u * TB, vb, kv_stride, u * BKV, S);
    cp_async_commit();
  } else {
    issue_stream<DH, NWG>(ring_a, 0, nkt, kb, vb, kv_stride, S);
  }
  CsRegs<DH, THREADS> csr;
  if (cb != nullptr) csr.load(cb, sb, 0, S);
  uint32_t qa[DH / 16][4];
  if (active) {
    load_q<DH>(qs, qb, q_stride, cb, sb, q0, S, wtid);
    named_sync(1 + wg, 128);
    load_q_frags<DH>(qa, qs, warp, gid, tig);
  }

  float o[DH / 2];
  float s[32];
  uint32_t pa[BKV / 16][4];  // P as the bf16 A operand of P V
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;

  // Pass 1: the row max of rows gid and gid + 8 of the warp's 16.
  float m0 = NEG_INF, m1 = NEG_INF;
  for (int t = 0; t < nkt; ++t) {
    unsigned char* kt;
    if constexpr (RES) {
      if (t == 0) cp_async_wait<1>();  // K and the bias (V may still land)
      kt = kres + t * TB;
    } else {
      cp_async_wait<0>();
      kt = ring + (t & 1) * Stage<DH>::BYTES + Stage<DH>::K;
    }
    // Rotate K tile t; the next rotation is of tile t + 1, or (without RES)
    // of tile 0 again at the start of pass 2.
    if (cb != nullptr) {
      csr.rotate(kt);
      if (!RES || t + 1 < nkt) csr.load(cb, sb, (t + 1) % nkt * BKV, S);
    }
    // Tile t is in place for every warpgroup; without RES every warpgroup
    // is done with tile t - 1, whose stage the next copies overwrite.
    fence_proxy_async();
    __syncthreads();
    if constexpr (!RES) issue_stream<DH, NWG>(ring_a, t + 1, nkt, kb, vb, kv_stride, S);
    if (!active) continue;
    qk_issue<DH>(s, qa, smem_u32(kt));
    wgmma_wait<0>();
    fence_regs(s);
    scale_bias(s, bias_s, t * BKV, scale, tig);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m0 = fmaxf(m0, fmaxf(s[4 * i], s[4 * i + 1]));
      m1 = fmaxf(m1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

  // Pass 2: p = exp(s - m), this thread's share of l, O += P V.
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = 0u;
  for (int t = 0; t < nkt; ++t) {
    unsigned char *kt, *vt;
    if constexpr (RES) {
      if (t == 0)
        cp_async_wait<0>();
      else if (t == 1)
        cp_async_wait<1>();
      else
        cp_async_wait<2>();
      kt = kres + t * TB;
      vt = ring + (t % 4) * TB;
    } else {
      cp_async_wait<0>();
      unsigned char* st = ring + (t & 1) * Stage<DH>::BYTES;  // step nkt + t, nkt even
      kt = st + Stage<DH>::K;
      vt = st + Stage<DH>::V;
      if (cb != nullptr) {
        csr.rotate(kt);
        if (t + 1 < nkt) csr.load(cb, sb, (t + 1) * BKV, S);
      }
    }
    // The previous tile's P V ran meanwhile; it reads o, pa and the V tile
    // whose memory the copies below refill, so it ends before the barrier.
    // (At Dh 16 it ended within its step: in flight across the loop's back
    // edge, its 8 accumulators made ptxas serialize wgmma.)
    constexpr bool pv_in_step = DH == 16;
    if constexpr (!pv_in_step) wait_pv(o, pa);
    fence_proxy_async();
    __syncthreads();
    if constexpr (RES) {
      if (t >= 1 && t + 3 < nkt)
        copy_v<DH, THREADS>(ring_a + ((t + 3) % 4) * TB, vb, kv_stride, (t + 3) * BKV, S);
      cp_async_commit();
    } else if (t + 1 < nkt) {
      issue_stream<DH, NWG>(ring_a, nkt + t + 1, nkt, kb, vb, kv_stride, S);
    }
    if (!active) continue;
    qk_issue<DH>(s, qa, smem_u32(kt));
    wgmma_wait<0>();
    fence_regs(s);
    scale_bias(s, bias_s, t * BKV, scale, tig);
    softmax_pv<DH>(s, m0, m1, l0, l1, pa, o, smem_u32(vt));
    if constexpr (pv_in_step) wait_pv(o, pa);
  }
  wait_pv(o, pa);
  if (!active) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  const int r0 = warp * 16 + gid;
  // O / l as bf16 over this warpgroup's Q tile once all four warps are past
  // their last product (pair 8 i + 2 tig of a row sits in chunk i), then
  // out as 16-byte row chunks.
  named_sync(1 + wg, 128);
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    *reinterpret_cast<uint32_t*>(qs + Tile::chunk(r0, i) + 4 * tig) =
        pack_bf16(o[4 * i] / d0, o[4 * i + 1] / d0);
    *reinterpret_cast<uint32_t*>(qs + Tile::chunk(r0 + 8, i) + 4 * tig) =
        pack_bf16(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
  }
  named_sync(1 + wg, 128);
  constexpr int CH = DH / 8;
  bf16* ob = out + static_cast<size_t>(b) * S * q_stride + h * DH;
  for (int p = wtid; p < BQ * CH; p += 128) {
    const int r = p / CH;
    const int c = p % CH;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(q0 + r) * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(qs + Tile::chunk(r, c));
  }
  if (lse != nullptr && tig == 0) {
    float* lb = lse + (static_cast<size_t>(b) * H + h) * S + q0;
    if (q0 + r0 < S) lb[r0] = m0 + logf(d0);
    if (q0 + r0 + 8 < S) lb[r0 + 8] = m1 + logf(d1);
  }
}

template <int DH, int NWG, bool RES>
int launch_cfg(const void* q, const void* k, const void* v, const float* bias,
               const float* cosb, const float* sinb, void* out, float* lse, int B,
               int S, int kv_len, int H, int KV, float scale, cudaStream_t stream) {
  using L = Layout<DH, NWG, RES>;
  const int bytes = L::bytes(kv_len);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_direct_kernel<DH, NWG, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = (H / KV) * ((S + BQ - 1) / BQ);
  dim3 grid((units + NWG - 1) / NWG, KV, B);
  flash_direct_kernel<DH, NWG, RES><<<grid, L::THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, cosb, sinb, static_cast<bf16*>(out), lse, S,
      kv_len, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, asked of the runtime once per device: K9
// launches thousands of times a generate on a host-bound path.
cudaError_t sm_count(int* sms) {
  constexpr int DEVICES = 64;
  static std::atomic<int> counts[DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < DEVICES && (*sms = counts[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < DEVICES) counts[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// With K resident: one warpgroup per block when every unit then has an SM
// of its own, two (K / V tiles and rotations shared by two units) when that
// would take more than one wave.  Streamed: always two (one is no faster,
// and its 64 cos / sin registers beside O spill at Dh 128).
template <int DH>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const float* cosb, const float* sinb, void* out, float* lse, int B, int S,
           int kv_len, int H, int KV, float scale, cudaStream_t stream) {
  if (Layout<DH, 2, true>::bytes(kv_len) > MAX_SMEM)
    return launch_cfg<DH, 2, false>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H,
                                    KV, scale, stream);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long units = static_cast<long>(B) * H * ((S + BQ - 1) / BQ);
  if (units <= sms)
    return launch_cfg<DH, 1, true>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H,
                                   KV, scale, stream);
  return launch_cfg<DH, 2, true>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H, KV,
                                 scale, stream);
}

}  // namespace

extern "C" {

// The arguments of ctdb_flash_attention_fwd (csrc/flash_attention.cu):
// q [B, S, H*Dh], k/v [B, S, KV*Dh] bf16; bias [B, S] f32; cos/sin
// [B, S, Dh/2] f32 or both null; out [B, S, H*Dh] bf16; lse [B, H, S] f32
// or null.  kv_len: S rounded up to 128, at most 1024 (one kv tile).
int ctdb_flash_attention_direct(const void* q, const void* k, const void* v,
                                const float* bias, const float* cosb,
                                const float* sinb, void* out, float* lse, int B,
                                int S, int kv_len, int H, int KV, int head_dim,
                                float scale, void* stream) {
  if (S < 1 || kv_len % 128 != 0 || kv_len < S || kv_len > 1024 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H, KV,
                        scale, st);
    case 32:
      return launch<32>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H, KV,
                        scale, st);
    case 64:
      return launch<64>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H, KV,
                        scale, st);
    case 128:
      return launch<128>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H, KV,
                         scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
