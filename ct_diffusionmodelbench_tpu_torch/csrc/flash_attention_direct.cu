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
//   cast to bf16; s = (q k^T) * scale + bias over all kv_len keys at once
//   (bias 0 for a real key, -1e30 for padding and for keys S..kv_len-1,
//   which are zero keys); m = max(max_j s, -1e30); p = exp(s - m);
//   l = sum p (f32); P = bf16(p); out = (P V) / max(l, 1e-30) in bf16;
//   lse = m + log(max(l, 1e-30)) when asked.  This is the arithmetic of
//   ops/flash_attention.py::flash_attention_plain, max for max.
//
// Bound on an H100 SXM at the single-prompt chat shape (B 1, S 512, H 16,
// KV 4, Dh 128): 2.1 GFLOP (~2.2 us at 989 TFLOP/s) against ~5 MB of q, k,
// v, out, bias and RoPE tables (~1.6 us at 3.35 TB/s): a few microseconds
// of work, so latency, redundant K / V loads and the block count dominate.
//
// Design: one block of W warps per (16 W-row query tile, head, batch); each
// warp owns 16 query rows.  The whole f32 score row of every query row
// lives in shared memory, 16 W x (kv_len + 4) floats, so W is 4 (64 rows)
// where that fits the 227 KB a block may have (kv_len <= 640: 198 KB at
// 640 with the q tile, one 64-key K/V tile and the bias) and 2 (32 rows)
// above it (162 KB at kv_len 1024; 64 rows would need 263 KB):
//   1. the q tile is rotated once; K streams through in 64-key tiles,
//      rotated as loaded (8 elements a thread, 16-byte loads); WMMA bf16
//      products write the raw scores;
//   2. each warp takes its rows' max, exp and sum with warp shuffles and
//      writes P as bf16 over the first half of each score row, in place;
//   3. V streams through in 64-key tiles; P V accumulates in WMMA f32
//      fragments with no rescaling (the max is final), which are then
//      staged over the warp's own score rows and divided by l.
// Nothing is carried between blocks.  What is left for later: wgmma,
// fewer shared-memory passes over the score row, K/V shared by the rep
// query heads of one kv head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BKV = 64;         // keys per K / V tile
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may have
constexpr float NEG_INF = -1e30f;

template <int DH, int WARPS>
struct Layout {
  static constexpr int TQ = 16 * WARPS;  // query rows per block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LDH = DH + 8;     // bf16 q / k / v tiles
  static constexpr int Q = 0;
  static constexpr int KV = Q + TQ * LDH * 2;
  static constexpr int BIAS = KV + BKV * LDH * 2;
  // f32 scores [TQ, kv_len + 4] follow the kv_len bias floats.
  static int bytes(int kv_len) { return BIAS + kv_len * 4 + TQ * (kv_len + 4) * 4; }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rotate-half RoPE of rows [r0, r0 + ROWS) of one head into a bf16 tile,
// 8 elements of each half per thread (16-byte loads and stores); rows >= S
// are zero.  Rounded as PyTorch's x1*c - x2*s, x2*c + x1*s.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_rotated(bf16* dst, const bf16* src,
                                             size_t stride, const float* cosb,
                                             const float* sinb, int r0, int S) {
  constexpr int HALF = DH / 2;
  constexpr int LDH = DH + 8;
  constexpr int CHUNKS = HALF / 8;
  for (int p = threadIdx.x; p < ROWS * CHUNKS; p += THREADS) {
    const int r = p / CHUNKS;
    const int d = (p % CHUNKS) * 8;
    const int i = r0 + r;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (i < S) {
      lo = *reinterpret_cast<const uint4*>(src + i * stride + d);
      hi = *reinterpret_cast<const uint4*>(src + i * stride + d + HALF);
      if (cosb != nullptr) {
        const bf16* x1 = reinterpret_cast<const bf16*>(&lo);
        const bf16* x2 = reinterpret_cast<const bf16*>(&hi);
        const float* cp = cosb + static_cast<size_t>(i) * HALF + d;
        const float* sp = sinb + static_cast<size_t>(i) * HALF + d;
        float c[8], s[8];
        *reinterpret_cast<float4*>(c) = *reinterpret_cast<const float4*>(cp);
        *reinterpret_cast<float4*>(c + 4) = *reinterpret_cast<const float4*>(cp + 4);
        *reinterpret_cast<float4*>(s) = *reinterpret_cast<const float4*>(sp);
        *reinterpret_cast<float4*>(s + 4) = *reinterpret_cast<const float4*>(sp + 4);
        uint4 o1, o2;
        bf16* y1 = reinterpret_cast<bf16*>(&o1);
        bf16* y2 = reinterpret_cast<bf16*>(&o2);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a = __bfloat162float(x1[j]);
          const float b = __bfloat162float(x2[j]);
          y1[j] = __float2bfloat16(__fsub_rn(__fmul_rn(a, c[j]), __fmul_rn(b, s[j])));
          y2[j] = __float2bfloat16(__fadd_rn(__fmul_rn(b, c[j]), __fmul_rn(a, s[j])));
        }
        lo = o1;
        hi = o2;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + d) = lo;
    *reinterpret_cast<uint4*>(dst + r * LDH + d + HALF) = hi;
  }
}

template <int DH, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_direct_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ cosb, const float* __restrict__ sinb,
                    bf16* __restrict__ out, float* __restrict__ lse, int S,
                    int kv_len, int H, int KV, float scale) {
  using L = Layout<DH, WARPS>;
  constexpr int TQ = L::TQ;
  constexpr int THREADS = L::THREADS;
  constexpr int LDH = L::LDH;
  constexpr int HALF = DH / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* KVs = reinterpret_cast<bf16*>(smem + L::KV);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  float* Ss = reinterpret_cast<float*>(smem + L::BIAS + kv_len * 4);
  const int ld = kv_len + 4;  // f32 score row; as bf16 P, 2 * ld

  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* Sw = Ss + warp * 16 * ld;                  // this warp's 16 rows
  const bf16* Pw = reinterpret_cast<const bf16*>(Sw);

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const bf16* qb = q + static_cast<size_t>(b) * S * q_stride + h * DH;
  const bf16* kb = k + static_cast<size_t>(b) * S * kv_stride + kvh * DH;
  const bf16* vb = v + static_cast<size_t>(b) * S * kv_stride + kvh * DH;
  const float* cb = cosb == nullptr ? nullptr : cosb + static_cast<size_t>(b) * S * HALF;
  const float* sb = sinb == nullptr ? nullptr : sinb + static_cast<size_t>(b) * S * HALF;
  const float* biasb = bias + static_cast<size_t>(b) * S;

  load_rotated<DH, TQ, THREADS>(Qs, qb, q_stride, cb, sb, q0, S);
  for (int j = tid; j < kv_len; j += THREADS) bias_s[j] = j < S ? biasb[j] : NEG_INF;

  // 1. Raw scores q k^T of this warp's rows against every key.
  const int nkt = kv_len / BKV;
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * BKV;
    __syncthreads();  // the previous K tile is consumed (and Qs, bias are in)
    load_rotated<DH, BKV, THREADS>(KVs, kb, kv_stride, cb, sb, j0, S);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BKV / 16];
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(sf[n], 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * LDH + kk, LDH);
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, KVs + n * 16 * LDH + kk, LDH);
        wmma::mma_sync(sf[n], a, kf, sf[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n)
      wmma::store_matrix_sync(Sw + j0 + n * 16, sf[n], ld, wmma::mem_row_major);
  }
  __syncwarp();

  // 2. Direct softmax of each row; P (bf16) overwrites the row's first half.
  // Writing key j's P touches float j / 2, which lanes of this chunk or an
  // earlier one have read: the warp syncs between the reads and the writes.
  float row_m[16], row_l[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    float* srow = Sw + rr * ld;
    bf16* prow = reinterpret_cast<bf16*>(srow);
    float m = NEG_INF;
    for (int j = lane; j < kv_len; j += 32) {
      const float s = __fadd_rn(__fmul_rn(srow[j], scale), bias_s[j]);
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    __syncwarp();
    float l = 0.0f;
    for (int j0 = 0; j0 < kv_len; j0 += 32) {
      const float p = expf(srow[j0 + lane] - m);
      l += p;
      __syncwarp();
      prow[j0 + lane] = __float2bfloat16(p);
    }
    __syncwarp();
    row_m[rr] = m;
    row_l[rr] = warp_sum(l);
  }

  // 3. O = P V, accumulated in fragments over the V tiles.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DH / 16];
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(of[n], 0.0f);
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * BKV;
    __syncthreads();  // every warp is done with the previous K / V tile
    for (int p = tid; p < BKV * DH / 8; p += THREADS) {
      const int r = p / (DH / 8);
      const int c = (p % (DH / 8)) * 8;
      const int j = j0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j < S) val = *reinterpret_cast<const uint4*>(vb + j * kv_stride + c);
      *reinterpret_cast<uint4*>(KVs + r * LDH + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Pw + j0 + kk, 2 * ld);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, KVs + kk * LDH + n * 16, LDH);
        wmma::mma_sync(of[n], a, vf, of[n]);
      }
    }
  }
  __syncwarp();  // this warp's P rows are read: stage O over them
#pragma unroll
  for (int n = 0; n < DH / 16; ++n)
    wmma::store_matrix_sync(Sw + n * 16, of[n], ld, wmma::mem_row_major);
  __syncwarp();

#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int i = q0 + warp * 16 + rr;
    if (i >= S) continue;
    const float denom = fmaxf(row_l[rr], 1e-30f);
    bf16* ob = out + (static_cast<size_t>(b) * S + i) * q_stride + h * DH;
    for (int d = lane; d < DH; d += 32) ob[d] = __float2bfloat16(Sw[rr * ld + d] / denom);
    if (lse != nullptr && lane == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + i] = row_m[rr] + logf(denom);
  }
}

template <int DH, int WARPS>
int launch_warps(const void* q, const void* k, const void* v, const float* bias,
                 const float* cosb, const float* sinb, void* out, float* lse,
                 int B, int S, int kv_len, int H, int KV, float scale,
                 cudaStream_t stream) {
  using L = Layout<DH, WARPS>;
  const int bytes = L::bytes(kv_len);
  cudaError_t err = cudaFuncSetAttribute(
      flash_direct_kernel<DH, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + L::TQ - 1) / L::TQ, H, B);
  flash_direct_kernel<DH, WARPS><<<grid, L::THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, cosb, sinb, static_cast<bf16*>(out),
      lse, S, kv_len, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

// 64-row query tiles where their scores fit, else 32-row ones.
template <int DH>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const float* cosb, const float* sinb, void* out, float* lse, int B,
           int S, int kv_len, int H, int KV, float scale, cudaStream_t stream) {
  if (Layout<DH, 4>::bytes(kv_len) <= MAX_SMEM)
    return launch_warps<DH, 4>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len,
                               H, KV, scale, stream);
  return launch_warps<DH, 2>(q, k, v, bias, cosb, sinb, out, lse, B, S, kv_len, H,
                             KV, scale, stream);
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
  if (kv_len % 128 != 0 || kv_len < S || kv_len > 1024 || H % KV != 0)
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
