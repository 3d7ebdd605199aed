// Bidirectional (non-causal) flash-attention forward with fused RoPE and GQA.
//
// Replaces (TPU): ct_diffusionmodelbench_tpu/ops/flash_attention.py
//   flash_attention -> _run_forward -> _flash_kernel, with the optional
//   log-sum-exp output (with_lse) that the backward reads.
//
// What it computes, per batch b, query head h (kv head h // rep):
//   q, k rotated by rotate-half RoPE in f32 from cos/sin [B, S, Dh/2], cast
//   to bf16; s = (q k^T) * scale + bias, bias = 0 for a real key and -1e30
//   for a padding key; online softmax with f32 running max and sum; P cast
//   to bf16 for P V, accumulated in f32; out = acc / max(l, 1e-30) in bf16;
//   with a non-null lse pointer also lse = m + log(max(l, 1e-30)) in f32,
//   [B, H, S] (a null pointer writes nothing extra: the serving path).
// Layout: heads in the last dim of the flat [B, S, H*Dh] / [B, S, KV*Dh]
// projection outputs, so no transpose is ever materialized.
// The reference pads the keys to its tile (kv_len >= S); keys at S..kv_len
// are zero with bias -1e30 here too, masked in the kernel, never copied.
//
// Bound on an H100 SXM at the main path (B 8, S 320, H 16, KV 4, Dh 128):
// 6.7 GFLOP (~7 us at 989 TFLOP/s) against ~27 MB of q, k, v, out, bias and
// RoPE tables (~8 us at 3.35 TB/s): both tiny; at this size launch latency
// and the 640-block wave shape dominate.
//
// Design: one block of 4 warps per (64-row q tile, head, batch).  The q tile
// is rotated once into shared memory; each 64-key tile of K is rotated as it
// is loaded and V copied beside it.  Each warp owns 16 query rows: Q K^T and
// P V run as WMMA bf16 fragments; scores go through shared memory for the
// row-wise online softmax (warp shuffles), and the f32 output accumulator
// lives in shared memory, rescaled per row before each P V.  K and V are
// read by each of the rep query heads of a kv head (no repeat in memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int DH>
struct Smem {
  static constexpr int LDH = DH + 8;   // bf16 q/k/v tiles
  static constexpr int LDS = BKV + 4;  // f32 scores
  static constexpr int LDP = BKV + 8;  // bf16 probabilities
  static constexpr int LDO = DH + 4;   // f32 output accumulator
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDH * 2;
  static constexpr int V = K + BKV * LDH * 2;
  static constexpr int P = V + BKV * LDH * 2;
  static constexpr int S = P + BQ * LDP * 2;
  static constexpr int O = S + BQ * LDS * 4;
  static constexpr int BIAS = O + BQ * LDO * 4;
  static constexpr int BYTES = BIAS + BKV * 4;
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

// Rotate-half RoPE of rows [r0, r0 + 64) of one head into a bf16 tile.
// src rows have stride `stride`; rows >= S are zero.
template <int DH>
__device__ __forceinline__ void load_rotated(bf16* dst, const bf16* src,
                                             size_t stride, const float* cosb,
                                             const float* sinb, int r0, int S) {
  constexpr int HALF = DH / 2;
  constexpr int LDH = Smem<DH>::LDH;
  for (int p = threadIdx.x; p < 64 * HALF; p += THREADS) {
    const int r = p / HALF;
    const int d = p % HALF;
    const int i = r0 + r;
    float o1 = 0.0f, o2 = 0.0f;
    if (i < S) {
      const float x1 = __bfloat162float(src[i * stride + d]);
      const float x2 = __bfloat162float(src[i * stride + d + HALF]);
      if (cosb != nullptr) {
        const float c = cosb[static_cast<size_t>(i) * HALF + d];
        const float s = sinb[static_cast<size_t>(i) * HALF + d];
        o1 = x1 * c - x2 * s;
        o2 = x2 * c + x1 * s;
      } else {
        o1 = x1;
        o2 = x2;
      }
    }
    dst[r * LDH + d] = __float2bfloat16(o1);
    dst[r * LDH + d + HALF] = __float2bfloat16(o2);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ cosb, const float* __restrict__ sinb,
                 bf16* __restrict__ out, float* __restrict__ lse, int S,
                 int kv_len, int H, int KV, float scale) {
  using L = Smem<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* Os = reinterpret_cast<float*>(smem + L::O);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int HALF = DH / 2;

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const bf16* qb = q + static_cast<size_t>(b) * S * q_stride + h * DH;
  const bf16* kb = k + static_cast<size_t>(b) * S * kv_stride + kvh * DH;
  const bf16* vb = v + static_cast<size_t>(b) * S * kv_stride + kvh * DH;
  const float* cb = cosb == nullptr ? nullptr : cosb + static_cast<size_t>(b) * S * HALF;
  const float* sb = sinb == nullptr ? nullptr : sinb + static_cast<size_t>(b) * S * HALF;
  const float* biasb = bias + static_cast<size_t>(b) * S;

  load_rotated<DH>(Qs, qb, q_stride, cb, sb, q0, S);
  for (int i = tid; i < BQ * L::LDO; i += THREADS) Os[i] = 0.0f;

  // Running max / sum of this warp's 16 rows, replicated in every lane.
  float row_m[16], row_l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    row_m[r] = NEG_INF;
    row_l[r] = 0.0f;
  }

  const int nkt = (kv_len + BKV - 1) / BKV;
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rotated<DH>(Ks, kb, kv_stride, cb, sb, j0, S);
    for (int p = tid; p < BKV * DH / 8; p += THREADS) {
      const int r = p / (DH / 8);
      const int c = (p % (DH / 8)) * 8;
      const int j = j0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j < S) val = *reinterpret_cast<const uint4*>(vb + j * kv_stride + c);
      *reinterpret_cast<uint4*>(Vs + r * L::LDH + c) = val;
    }
    if (tid < BKV) {
      const int j = j0 + tid;
      bias_s[tid] = j < S ? biasb[j] : NEG_INF;
    }
    __syncthreads();

    // Scores of this warp's 16 rows against the 64 keys.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BKV / 16];
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(sf[n], 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDH + kk, L::LDH);
#pragma unroll
        for (int n = 0; n < BKV / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, Ks + n * 16 * L::LDH + kk, L::LDH);
          wmma::mma_sync(sf[n], a, kf, sf[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n)
        wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + n * 16, sf[n],
                                L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax; each lane holds keys lane and lane + 32 of a row.
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float s0 = Ss[r * L::LDS + lane] * scale + bias_s[lane];
      const float s1 = Ss[r * L::LDS + lane + 32] * scale + bias_s[lane + 32];
      const float m_new = fmaxf(row_m[rr], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      Ps[r * L::LDP + lane] = __float2bfloat16(p0);
      Ps[r * L::LDP + lane + 32] = __float2bfloat16(p1);
      const float alpha = expf(row_m[rr] - m_new);
      row_l[rr] = row_l[rr] * alpha + warp_sum(p0 + p1);
      row_m[rr] = m_new;
      for (int d = lane; d < DH; d += 32) Os[r * L::LDO + d] *= alpha;
    }
    __syncwarp();

    // O += P V for this warp's rows.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DH / 16];
#pragma unroll
      for (int n = 0; n < DH / 16; ++n)
        wmma::load_matrix_sync(of[n], Os + warp * 16 * L::LDO + n * 16, L::LDO,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + warp * 16 * L::LDP + kk, L::LDP);
#pragma unroll
        for (int n = 0; n < DH / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vs + kk * L::LDH + n * 16, L::LDH);
          wmma::mma_sync(of[n], a, vf, of[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < DH / 16; ++n)
        wmma::store_matrix_sync(Os + warp * 16 * L::LDO + n * 16, of[n], L::LDO,
                                wmma::mem_row_major);
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int i = q0 + r;
    if (i >= S) continue;
    const float denom = fmaxf(row_l[rr], 1e-30f);
    bf16* ob = out + (static_cast<size_t>(b) * S + i) * q_stride + h * DH;
    for (int d = lane; d < DH; d += 32)
      ob[d] = __float2bfloat16(Os[r * L::LDO + d] / denom);
    if (lse != nullptr && lane == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + i] = row_m[rr] + logf(denom);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const float* bias,
           const float* cosb, const float* sinb, void* out, float* lse, int B,
           int S, int kv_len, int H, int KV, float scale, cudaStream_t stream) {
  constexpr int bytes = Smem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, cosb, sinb, static_cast<bf16*>(out),
      lse, S, kv_len, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, S, H*Dh], k/v [B, S, KV*Dh] bf16; bias [B, S] f32; cos/sin
// [B, S, Dh/2] f32 or both null (no RoPE); out [B, S, H*Dh] bf16; lse
// [B, H, S] f32 or null.  kv_len >= S: keys S..kv_len-1 count as zero keys
// with bias -1e30.
int ctdb_flash_attention_fwd(const void* q, const void* k, const void* v,
                             const float* bias, const float* cosb,
                             const float* sinb, void* out, float* lse, int B,
                             int S, int kv_len, int H, int KV, int head_dim,
                             float scale, void* stream) {
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
