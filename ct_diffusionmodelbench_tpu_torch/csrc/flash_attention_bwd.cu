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
// Design: one block of 8 warps per 64-row tile.  dq: a (q tile, head,
// batch) block loops over 64-key tiles; warps 0-3 compute the 16-row
// slices of S = Q K^T, warps 4-7 those of dP = dO V^T (WMMA bf16, f32
// accumulators), both go through shared memory for the elementwise dS,
// then each warp adds dS K into half of its 16 rows' dQ columns, kept in
// registers for the whole key loop.  dkv: a (key tile, kv head, batch)
// block loops over the rep query heads and their 64-row q tiles and works
// on the transposed scores (S^T = K Q^T, dP^T = V dO^T), so each warp's
// 16 key rows own their dV (warps 0-3) or dK (warps 4-7) accumulators in
// registers; the sum over query heads and q tiles stays inside the block
// and needs no atomics.  Shared memory at Dh 128: four bf16 [64, Dh] tiles,
// two f32 [64, 64] score tiles and two bf16 [64, 64] tiles (121 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TILE = 64;     // query rows and keys per tile
constexpr int THREADS = 256;  // 8 warps
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
  static constexpr int P1 = P0 + TILE_P;
  static constexpr int BIAS = P1 + TILE_P;
  static constexpr int LSE = BIAS + TILE * 4;
  static constexpr int DSUM = LSE + TILE * 4;
  static constexpr int BYTES = DSUM + TILE * 4;
  // dq stages its [64, Dh] f32 result over the two score tiles; dkv stages
  // dV and dK over the whole buffer.
  static_assert(TILE * LDO * 4 <= 2 * TILE_S, "dq staging does not fit");
  static_assert(2 * TILE * LDO * 4 <= BYTES, "dkv staging does not fit");
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

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int KV, float scale) {
  using L = Smem<DH>;
  constexpr int NF = DH / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::H0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::H1);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::H2);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::H3);
  float* St = reinterpret_cast<float*>(smem + L::S0);   // [key, query]
  float* dPt = reinterpret_cast<float*>(smem + L::S1);
  bf16* Pt = reinterpret_cast<bf16*>(smem + L::P0);
  bf16* dSt = reinterpret_cast<bf16*>(smem + L::P1);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* dsum_s = reinterpret_cast<float*>(smem + L::DSUM);

  const int j0 = blockIdx.x * TILE;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int rw = warp % 4;    // 16 key rows of the tile
  const int half = warp / 4;  // 0: dV, 1: dK

  const size_t q_stride = static_cast<size_t>(H) * DH;
  const size_t kv_stride = static_cast<size_t>(KV) * DH;
  const bf16* kb = k + static_cast<size_t>(b) * S * kv_stride + g * DH;
  const bf16* vb = v + static_cast<size_t>(b) * S * kv_stride + g * DH;

  load_tile<DH>(Ks, kb, kv_stride, j0, S);
  load_tile<DH>(Vs, vb, kv_stride, j0, S);
  if (tid < TILE) {
    const int j = j0 + tid;
    bias_s[tid] = j < S ? bias[static_cast<size_t>(b) * S + j] : NEG_INF;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[n], 0.0f);

  const int nqt = (S + TILE - 1) / TILE;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const size_t head_row = (static_cast<size_t>(b) * H + h) * S;
    const bf16* qb = q + static_cast<size_t>(b) * S * q_stride + h * DH;
    const bf16* dob = dout + static_cast<size_t>(b) * S * q_stride + h * DH;
    for (int qt = 0; qt < nqt; ++qt) {
      const int i0 = qt * TILE;
      __syncthreads();  // every warp is done with the previous Q, dO, P, dS
      load_tile<DH>(Qs, qb, q_stride, i0, S);
      load_tile<DH>(dOs, dob, q_stride, i0, S);
      if (tid < TILE) {
        const int i = i0 + tid;
        lse_s[tid] = i < S ? lse[head_row + i] : 0.0f;
        dsum_s[tid] = i < S ? dsum[head_row + i] : 0.0f;
      }
      __syncthreads();

      // S^T = K Q^T (warps 0-3) and dP^T = V dO^T (warps 4-7).
      if (half == 0)
        rows_times_tile_t<DH>(St + rw * 16 * L::LDS, Ks + rw * 16 * L::LDH, Qs);
      else
        rows_times_tile_t<DH>(dPt + rw * 16 * L::LDS, Vs + rw * 16 * L::LDH, dOs);
      __syncthreads();

      // P^T and dS^T in bf16; query rows past S get p = 0.
      for (int p = tid; p < TILE * TILE; p += THREADS) {
        const int rk = p / TILE;  // key
        const int c = p % TILE;   // query
        float pr = 0.0f;
        if (i0 + c < S) {
          const float s = St[rk * L::LDS + c] * scale + bias_s[rk];
          pr = expf(s - lse_s[c]);
        }
        const float ds = pr * (dPt[rk * L::LDS + c] - dsum_s[c]) * scale;
        Pt[rk * L::LDP + c] = __float2bfloat16(pr);
        dSt[rk * L::LDP + c] = __float2bfloat16(ds);
      }
      __syncthreads();

      // dV += P^T dO (warps 0-3), dK += dS^T Q (warps 4-7).
      const bf16* a_src = half == 0 ? Pt : dSt;
      const bf16* b_src = half == 0 ? dOs : Qs;
#pragma unroll
      for (int kk = 0; kk < TILE; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
        wmma::load_matrix_sync(af, a_src + rw * 16 * L::LDP + kk, L::LDP);
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, b_src + kk * L::LDH + n * 16, L::LDH);
          wmma::mma_sync(acc[n], af, bf, acc[n]);
        }
      }
    }
  }

  // Stage dV (rows 0..63) then dK (rows 64..127) and write the keys < S.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < NF; ++n)
    wmma::store_matrix_sync(stage + (half * TILE + rw * 16) * L::LDO + n * 16,
                            acc[n], L::LDO, wmma::mem_row_major);
  __syncthreads();
  float* dkb = dk + static_cast<size_t>(b) * S * kv_stride + g * DH;
  float* dvb = dv + static_cast<size_t>(b) * S * kv_stride + g * DH;
  for (int p = tid; p < 2 * TILE * DH; p += THREADS) {
    const int r = p / DH;
    const int c = p % DH;
    const int j = j0 + (r % TILE);
    if (j < S) {
      float* dst = r < TILE ? dvb : dkb;
      dst[j * kv_stride + c] = stage[r * L::LDO + c];
    }
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
  constexpr int bytes = Smem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + TILE - 1) / TILE, KV, B);
  flash_bwd_dkv_kernel<DH><<<grid, THREADS, bytes, stream>>>(
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
