// K12: attention of one block of queries over an exact KV cache (the SDAR
// family's cached denoising step and commit).
//
// Replaces (TPU): none.  The JAX package has no block-causal family and no
// exact cache; its dual cache's block-over-cache attention is the plain
// reference attention.  Added for the SDAR decode (models/sdar_cache.py),
// whose every pass but the prefill runs a block of bl positions against the
// cache.
//
// What it computes, per batch row b and query head h (kv head g = h / rep):
//   q [B, bl, H, Dh] bf16, rotated; k, v [B, S, KV, Dh] bf16, k rotated, the
//   row's keys being positions key_start[b] .. key_end - 1 (the row's first
//   real token to the end of the current block, which the caller has just
//   written; key_end is read from device memory, so a CUDA graph of a pass
//   replays at any block); s = (q k^T) * scale in f32, p = exp(s - max) in
//   f32, the sum l of the f32 p, P cast to bf16 for P V accumulated in f32,
//   out = acc / l in bf16.  Every key in the range is real: left padding lies before
//   key_start, the cache past key_end is never read.
//
// Bound on an H100 SXM: bytes.  At sdar30b-eval's step (B 32, bl 4, H 32,
// KV 4, Dh 128, ~700 keys a row) a layer reads 32 rows x 4 kv heads x ~700
// keys x 512 B of K and V, ~46 MB (~14 us at 3.35 TB/s), for ~0.75 GFLOP
// (~0.8 us at 989 TFLOP/s): 32 query rows share each key, so ~32 FLOP a byte
// against the card's ~295.
//
// Design (first design, right and simple):
// - One CTA per (kv head, batch row): the bl positions times the rep query
//   heads of kv head g are packed into one tile of at most 32 query rows
//   (row r = position r / rep, head g * rep + r % rep; rows past bl * rep are
//   zero and never written), so each key and value of the cache is read from
//   device memory once per row and kv head.  128 CTAs at sdar30b-eval's
//   step, one wave on 132 SMs.
// - Keys flow through a two-stage ring of shared memory, 128 keys a stage,
//   K and V by cp.async 16 bytes a thread (keys past key_end zero-filled),
//   the next chunk's copies in flight while the current one computes.
// - Eight warps: warp w takes query rows 16 (w % 2) .. + 15 and keys
//   32 (w / 2) .. + 31 of each chunk, so a chunk's keys are split four ways
//   and each warp keeps its own running max, sum and O over its keys.
//   S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 in, f32 sums) with
//   ldmatrix fragments (.trans for V); P becomes the A fragment of P V in
//   registers, as in flash attention.  Rows are padded to Dh * 2 + 16 bytes
//   in shared memory, so ldmatrix's eight row addresses hit distinct banks.
// - At the end the four key quarters of each row are merged in shared
//   memory (max, rescaled sums and O) and written as bf16.
// Deterministic: no atomics; the merge runs in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace ctdb;

constexpr int ROWS = 32;      // packed query rows
constexpr int CHUNK = 128;    // keys a stage
constexpr int QUARTER = 32;   // keys a warp takes of a chunk
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Smem {
  static constexpr int ROW = DH * 2 + 16;                   // padded row bytes
  static constexpr int Q = 0;                               // [ROWS] rows
  static constexpr int STAGE0 = ROWS * ROW;
  static constexpr int K = 0;                               // in a stage: [CHUNK] rows
  static constexpr int V = CHUNK * ROW;
  static constexpr int STAGE_BYTES = 2 * CHUNK * ROW;
  // After the key loop the stages hold the merge: m and l [4][ROWS], O
  // [4][ROWS][DH] f32.
  static constexpr int RED_M = STAGE0;
  static constexpr int RED_L = RED_M + 4 * ROWS * 4;
  static constexpr int RED_O = RED_L + 4 * ROWS * 4;
  static constexpr int BYTES = STAGE0 + 2 * STAGE_BYTES;
  static_assert(RED_O + 4 * ROWS * DH * 4 <= BYTES, "merge does not fit the stages");
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

// d += a b, m16n8k16, bf16 in, f32 sums; a row-major 16x16, b column-major
// 16x8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies of keys [k0, k0 + CHUNK) of one kv head into a stage; keys at or
// past n_keys (key_end cut to S) are zero-filled.
template <int DH>
__device__ __forceinline__ void issue_chunk(unsigned char* stp, const bf16* kb,
                                            const bf16* vb, size_t key_stride, int k0,
                                            int n_keys) {
  using L = Smem<DH>;
  constexpr int CH = DH / 8;   // 16-byte chunks a row
  const uint32_t st = smem_u32(stp);
  for (int p = threadIdx.x; p < CHUNK * CH; p += THREADS) {
    const int r = p / CH;
    const int c = p % CH;
    const int j = k0 + r;
    const bool ok = j < n_keys;
    const size_t off = static_cast<size_t>(ok ? j : 0) * key_stride + c * 8;
    cp_async16(st + L::K + r * L::ROW + c * 16, kb + off, ok);
    cp_async16(st + L::V + r * L::ROW + c * 16, vb + off, ok);
  }
  cp_async_commit();
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
cache_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ key_start,
                  const int* __restrict__ key_end, bf16* __restrict__ out, int S, int bl,
                  int H, int KV, float scale) {
  using L = Smem<DH>;
  constexpr int NT = DH / 8;   // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem[];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / KV;
  const int n_rows = bl * rep;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int mt = warp % 2;     // query rows 16 mt .. 16 mt + 15
  const int kq = warp / 2;     // keys 32 kq .. 32 kq + 31 of each chunk

  const size_t key_stride = static_cast<size_t>(KV) * DH;
  const bf16* kb = k + static_cast<size_t>(b) * S * key_stride + g * DH;
  const bf16* vb = v + static_cast<size_t>(b) * S * key_stride + g * DH;
  const int n_keys = min(*key_end, S);
  const int first = key_start[b];
  const int n_chunks = (n_keys - first + CHUNK - 1) / CHUNK;

  issue_chunk<DH>(smem + L::STAGE0, kb, vb, key_stride, first, n_keys);

  // The packed query rows into shared memory; rows past bl * rep are zero.
  for (int p = tid; p < ROWS * (DH / 8); p += THREADS) {
    const int r = p / (DH / 8);
    const int c = p % (DH / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) {
      const int pos = r / rep;
      const int h = g * rep + r % rep;
      val = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(b) * bl + pos) * H * DH + h * DH + c * 8);
    }
    *reinterpret_cast<uint4*>(smem + L::Q + r * L::ROW + c * 16) = val;
  }

  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  // This lane's ldmatrix rows: matrix mi = lane / 8, row lane % 8 of it.
  const int mi = lane / 8;
  const int mr = lane % 8;
  const uint32_t q_lane =
      smem_u32(smem + L::Q + (16 * mt + (mi & 1) * 8 + mr) * L::ROW + (mi >> 1) * 16);

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      issue_chunk<DH>(smem + L::STAGE0 + ((c + 1) & 1) * L::STAGE_BYTES, kb, vb,
                      key_stride, first + (c + 1) * CHUNK, n_keys);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* stp = smem + L::STAGE0 + (c & 1) * L::STAGE_BYTES;
    const int k0 = first + c * CHUNK + kq * QUARTER;   // this warp's first key

    if (k0 < n_keys) {
      // S = Q K^T over this warp's 32 keys: four n-tiles of 8 keys.
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const uint32_t k_lane = smem_u32(
          stp + L::K + (kq * QUARTER + (mi >> 1) * 8 + mr) * L::ROW + (mi & 1) * 16);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, q_lane + kk * 32);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, k_lane + j * 8 * L::ROW + kk * 32);
          mma16816(s[j], a, bk[0], bk[1]);
          mma16816(s[j + 1], a, bk[2], bk[3]);
        }
      }

      // Online softmax of rows gid and gid + 8 over the 32 keys.
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 8 * j + 2 * tig;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = key + e < n_keys;
          s[j][e] = ok ? s[j][e] * scale : -INFINITY;
          s[j][2 + e] = ok ? s[j][2 + e] * scale : -INFINITY;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // The first key of every warp's range is real, so mx is finite here.
      const float a0 = exp2f((m0 - mx0) * LOG2E);
      const float a1 = exp2f((m1 - mx1) * LOG2E);
      m0 = mx0;
      m1 = mx1;
      uint32_t pa[2][4];   // P as the A fragments of two k-steps of 16 keys
      float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p00 = exp2f((s[j][0] - mx0) * LOG2E);
        const float p01 = exp2f((s[j][1] - mx0) * LOG2E);
        const float p10 = exp2f((s[j][2] - mx1) * LOG2E);
        const float p11 = exp2f((s[j][3] - mx1) * LOG2E);
        r0 += p00 + p01;
        r1 += p10 + p11;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * a0 + r0;
      l1 = l1 * a1 + r1;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        o[i][0] *= a0;
        o[i][1] *= a0;
        o[i][2] *= a1;
        o[i][3] *= a1;
      }

      // O += P V: two k-steps of 16 keys, V's fragments by ldmatrix.trans.
      const uint32_t v_lane = smem_u32(
          stp + L::V + (kq * QUARTER + (mi & 1) * 8 + mr) * L::ROW + (mi >> 1) * 16);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int i = 0; i < NT; i += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, v_lane + ks * 16 * L::ROW + i * 16);
          mma16816(o[i], pa[ks], bv[0], bv[1]);
          mma16816(o[i + 1], pa[ks], bv[2], bv[3]);
        }
      }
    }
    // Every warp is done with this stage before the next copies refill it.
    __syncthreads();
  }

  // Merge the four key quarters of each row.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* red_m = reinterpret_cast<float*>(smem + L::RED_M);
  float* red_l = reinterpret_cast<float*>(smem + L::RED_L);
  float* red_o = reinterpret_cast<float*>(smem + L::RED_O);
  const int row0 = 16 * mt + gid;
  if (tig == 0) {
    red_m[kq * ROWS + row0] = m0;
    red_m[kq * ROWS + row0 + 8] = m1;
    red_l[kq * ROWS + row0] = l0;
    red_l[kq * ROWS + row0 + 8] = l1;
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float* o0 = red_o + (kq * ROWS + row0) * DH + 8 * i + 2 * tig;
    o0[0] = o[i][0];
    o0[1] = o[i][1];
    o0[8 * DH] = o[i][2];
    o0[8 * DH + 1] = o[i][3];
  }
  __syncthreads();

  // Eight threads a row, DH / 8 values each.
  const int r = tid / 8;
  const int d0 = (tid % 8) * (DH / 8);
  if (r >= n_rows) return;
  float mm = -INFINITY;
#pragma unroll
  for (int w = 0; w < 4; ++w) mm = fmaxf(mm, red_m[w * ROWS + r]);
  float wt[4];
  float ll = 0.0f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float mw = red_m[w * ROWS + r];
    wt[w] = mw == -INFINITY ? 0.0f : exp2f((mw - mm) * LOG2E);
    ll += wt[w] * red_l[w * ROWS + r];
  }
  const int pos = r / rep;
  const int h = g * rep + r % rep;
  bf16* ob = out + (static_cast<size_t>(b) * bl + pos) * H * DH + h * DH + d0;
#pragma unroll
  for (int d = 0; d < DH / 8; d += 2) {
    float x0 = 0.0f, x1 = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* ow = red_o + (w * ROWS + r) * DH + d0 + d;
      x0 += wt[w] * ow[0];
      x1 += wt[w] * ow[1];
    }
    *reinterpret_cast<uint32_t*>(ob + d) = pack_bf16(x0 / ll, x1 / ll);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const int* key_start,
           const int* key_end, void* out, int B, int S, int bl, int H, int KV, float scale,
           cudaStream_t stream) {
  constexpr int bytes = Smem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      cache_attn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KV, B);
  cache_attn_kernel<DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), key_start, key_end, static_cast<bf16*>(out), S, bl, H,
      KV, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, bl, H*Dh] bf16; k, v [B, S, KV*Dh] bf16 (one layer of the cache);
// key_start [B] int32, each row's first key; key_end, one int32 in device
// memory: keys key_start[b] .. key_end - 1 are read (key_end is cut to S),
// 1 <= key_end - key_start[b]; out [B, bl, H*Dh] bf16.  bl * (H / KV) <= 32.
int ctdb_cache_attention(const void* q, const void* k, const void* v, const int* key_start,
                         const int* key_end, void* out, int B, int S, int bl, int H, int KV,
                         int head_dim, float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || bl < 1 || bl * (H / KV) > ROWS || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, key_start, key_end, out, B, S, bl, H, KV, scale, st);
    case 32:
      return launch<32>(q, k, v, key_start, key_end, out, B, S, bl, H, KV, scale, st);
    case 64:
      return launch<64>(q, k, v, key_start, key_end, out, B, S, bl, H, KV, scale, st);
    case 128:
      return launch<128>(q, k, v, key_start, key_end, out, B, S, bl, H, KV, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
