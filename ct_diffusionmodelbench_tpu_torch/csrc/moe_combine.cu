// G3: the MoE layer's weighted combine after the down product (K2), the
// unsort of the expert rows back to their tokens.
//
// Replaces (TPU): no Pallas kernel.  The reference's combine
//   (ops/grouped_gemm_pallas.py::_combine, its default "kloop" form) is k
//   gathers of the padded rows, each scaled by its slot's probability and
//   added to an f32 sum, which XLA fuses.  Eager PyTorch ran it as a
//   chain per layer (ops/grouped_gemm_cuda.py::combine_plain): a zero f32
//   [N, D], k index_selects over a strided index column, k addcmul_s on a
//   strided probability column (the non-vectorised elementwise path) and a
//   cast: 2k + 2 small kernels, each bound by its latency.
//
// What it computes: rows [m_pad, D] (bf16 or f32), dest [N * k] int64 (the
//   padded row of routing slot (n, j) at n * k + j), probs [N, k] f32 (any
//   strides, as the router's top-k slice comes); out [N, D] (bf16 or f32)
//   with
//     acc = 0.0f;  for j = 0 .. k-1:  acc = fmaf(f32(rows[dest[n*k+j]]), probs[n, j], acc)
//     out = round(acc)
//   in f32, the slots in the chain's order.  addcmul_ on the card rounds
//   self + t1 * t2 once, as one fused multiply-add: with PyTorch 2.11 (CUDA
//   12.8) on an H100 it equalled fmaf on all of 8.4 M elements and differed
//   from a multiply and then an add on 12 % of them.  So the kernel writes
//   __fmaf_rn, and its output is bit-equal to the chain's (a cuda test holds
//   it to the chain run on the card).
//
// Bound on an H100 SXM: bytes.  A token reads k rows of D and writes one,
// two flops an element read.  At sdar30b-eval's cached pass (N 128, k 8,
// D 2048, bf16) that is 4 MB in and 0.5 MB out, 1.4 us at 3.35 TB/s; the
// rows were just written by K2 and mostly sit in the 50 MB L2.  Small as
// it is, the time is the launch and two dependent trips to memory.
//
// Design: one thread a token and 8 columns (16 bytes of a bf16 row, 32 of
// an f32 one), threads of a token side by side, so a warp reads 512
// contiguous bytes of each slot's row; blocks of 128 threads over N * D / 8
// items, so the grid follows N and D and nothing else (128 x 2048 -> 256
// blocks, two an SM; LLaDA-MoE's N 2560 -> 5120).  The slots go in groups
// of eight: all indices and probabilities of a group load first, then all
// rows (eight independent 16-byte loads in flight a thread), then the sums
// in slot order.  An index outside [0, m_pad) traps, as index_select's
// device assert would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kCols = 8;      // columns a thread
constexpr int kGroup = 8;     // slots whose rows load together
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace

// Outside the anonymous namespace, so that a profile reads
// ctdb_moe_combine_kernel<...>.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
ctdb_moe_combine_kernel(const TIn* __restrict__ rows, const long long* __restrict__ dest,
                        const float* __restrict__ probs, TOut* __restrict__ out, int n,
                        int k, int d, long long m_pad, long long p_row, long long p_col) {
  constexpr int kIn = kCols * static_cast<int>(sizeof(TIn)) / 16;  // words a row chunk
  constexpr int kPer = 16 / static_cast<int>(sizeof(TIn));
  const int chunks = d / kCols;
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item >= static_cast<long long>(n) * chunks) return;
  const long long tok = item / chunks;
  const int col = static_cast<int>(item % chunks) * kCols;
  const long long* slot = dest + tok * k;
  const float* p_tok = probs + tok * p_row;

  float acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = 0.0f;
  for (int j0 = 0; j0 < k; j0 += kGroup) {
    const int g = k - j0 < kGroup ? k - j0 : kGroup;
    long long r[kGroup];
    float p[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < g) {
        r[j] = slot[j0 + j];
        p[j] = p_tok[(j0 + j) * p_col];
      }
    }
    uint4 raw[kGroup][kIn];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < g) {
        if (r[j] < 0 || r[j] >= m_pad) __trap();
        const uint4* src = reinterpret_cast<const uint4*>(rows + r[j] * d + col);
#pragma unroll
        for (int w = 0; w < kIn; ++w) raw[j][w] = src[w];
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < g) {
#pragma unroll
        for (int w = 0; w < kIn; ++w) {
          const TIn* v = reinterpret_cast<const TIn*>(&raw[j][w]);
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            const int c = w * kPer + e;
            acc[c] = __fmaf_rn(to_f32(v[e]), p[j], acc[c]);
          }
        }
      }
    }
  }

  constexpr int kOut = kCols * static_cast<int>(sizeof(TOut)) / 16;
  constexpr int kPerOut = 16 / static_cast<int>(sizeof(TOut));
  uint4* dst = reinterpret_cast<uint4*>(out + tok * d + col);
#pragma unroll
  for (int w = 0; w < kOut; ++w) {
    uint4 word;
    TOut* o = reinterpret_cast<TOut*>(&word);
#pragma unroll
    for (int e = 0; e < kPerOut; ++e) o[e] = from_f32<TOut>(acc[w * kPerOut + e]);
    dst[w] = word;
  }
}

namespace {

template <typename TIn, typename TOut>
int launch(const void* rows, const long long* dest, const float* probs, void* out, int n,
           int k, int d, long long m_pad, long long p_row, long long p_col,
           cudaStream_t st) {
  const long long items = static_cast<long long>(n) * (d / kCols);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ctdb_moe_combine_kernel<TIn, TOut><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const TIn*>(rows), dest, probs, static_cast<TOut*>(out), n, k, d, m_pad,
      p_row, p_col);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_out(const void* rows, const long long* dest, const float* probs, void* out,
               int n, int k, int d, long long m_pad, long long p_row, long long p_col,
               int out_dtype, cudaStream_t st) {
  if (out_dtype == kBF16)
    return launch<TIn, __nv_bfloat16>(rows, dest, probs, out, n, k, d, m_pad, p_row, p_col,
                                      st);
  if (out_dtype == kF32)
    return launch<TIn, float>(rows, dest, probs, out, n, k, d, m_pad, p_row, p_col, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// rows [m_pad, d] in rows_dtype, contiguous and 16-byte aligned; dest [n * k]
// int64; probs [n, k] f32, element (i, j) at i * p_row + j * p_col; out
// [n, d] in out_dtype, contiguous and 16-byte aligned; dtypes 0 f32, 1 bf16;
// d a multiple of 8, n and k at least 1.
int ctdb_moe_combine(const void* rows, const long long* dest, const float* probs, void* out,
                     int n, int k, int d, long long m_pad, long long p_row, long long p_col,
                     int rows_dtype, int out_dtype, void* stream) {
  if (n < 1 || k < 1 || d < kCols || d % kCols != 0 || m_pad < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_dtype == kBF16)
    return launch_out<__nv_bfloat16>(rows, dest, probs, out, n, k, d, m_pad, p_row, p_col,
                                     out_dtype, st);
  if (rows_dtype == kF32)
    return launch_out<float>(rows, dest, probs, out, n, k, d, m_pad, p_row, p_col,
                             out_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
