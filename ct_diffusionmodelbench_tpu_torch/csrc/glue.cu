// The model step's elementwise glue: RMSNorm and the SwiGLU activation.
//
// Replaces (TPU): no Pallas kernel.  On the TPU, XLA fuses the reference's
//   models/layers.py::rms_norm and the silu(gate) * up of models/layers.py::
//   swiglu into the neighbouring products, so the JAX package never wrote
//   them by hand.  In eager PyTorch each is a chain of elementwise kernels
//   over f32 copies: rms_norm's upcast, x*x, mean, *rsqrt, *scale and
//   downcast move about 40 bytes per element; silu, the product and the cast
//   of swiglu about 26.  These kernels make one pass instead.
//
// What they compute, in the composites' order of operations (each product
// and sum rounded on its own, no fast-math, round-to-nearest-even at the
// end):
//   ctdb_rms_norm_kernel   y = cast(f32(x) * rsqrt(mean(f32(x)^2) + eps)
//                          * f32(scale)) over the last dim D of x [rows, D],
//                          x bf16 or f32, scale bf16 or f32 [D], y in x's
//                          dtype; the mean is the sum of the rounded squares
//                          times PyTorch's factor rows / (rows * D), so only
//                          the order of the sum differs from the composite.
//   ctdb_swiglu_act_kernel out = cast(silu(gate) * up), gate and up f32,
//                          silu(g) = g / (1 + expf(-g)) as PyTorch's CUDA
//                          silu computes it, out bf16 or f32: bit-equal to
//                          (F.silu(gate) * up).to(out dtype).
//
// Bound on an H100 SXM: bytes.  Each element takes a few flops against 4-12
// bytes, far below the card's 295 flops a byte.  At the dense8b-eval shape
// (rows 3328): rms_norm over D 4096 in bf16 reads and writes 54.5 MB (16.3 us
// at 3.35 TB/s); swiglu_act over F 12288 reads 327 MB of f32 and writes 82 MB
// of bf16 (122 us).
//
// Design: every byte crosses device memory once, in 16-byte accesses.
// - rms_norm keeps its row in registers between the sum and the scaling, so
//   x is read once; as loaded, 16 bytes a vector (f32 copies of the row took
//   1.12x the time: PERF.md).  D > 1024: one block a row, each thread up to
//   four 16-byte vectors (threads = D / 8 / 4 in bf16, 128 at D 4096), the
//   sum reduced by warp shuffles and one barrier, after which every warp
//   sums the warps' partials alike.  At D 4096 it takes 1.11x the time of a
//   device copy of the same bytes; a persistent grid that loads a block's
//   next row ahead took 1.1x its time, a 32-register cap spilled (1.8x), two
//   vectors a thread gained under 1 % (PERF.md).  D <= 1024
//   (the qk-norm over a head dim of 128, on [B, S, H, Dh] rows): one warp a
//   row, eight rows a block, the sum reduced by shuffles alone; at
//   [4, 832, 16, 128] it takes half the time of a block a row, whose 16
//   vectors a row leave most of its threads idle (PERF.md).  The launch
//   shape follows D and nothing else.
// - swiglu_act is a grid-stride loop over 8 elements a thread an iteration:
//   two 16-byte loads from each of gate and up, one 16-byte store of 8 bf16
//   (two in f32), which the down product reads next; eight blocks of 256
//   threads an SM keep ~128 KB an SM in flight.  (Streaming, evict-first
//   loads were 4 % slower; unrolling two iterations gained nothing.)  A tail
//   of numel % 8 elements is taken one a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

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

// The VEC = 16 / sizeof(T) elements of T in one 16-byte word, widened to f32.
template <typename T>
__device__ __forceinline__ void unpack_f32(const uint4& raw, float (&out)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) out[j] = to_f32(e[j]);
}

// N consecutive elements of T at p (aligned to min(16, N * sizeof(T)) bytes)
// widened to f32, in 16-byte loads (one 8-byte load for a smaller run).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes >= 16) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      float part[kPer];
      unpack_f32<T>(reinterpret_cast<const uint4*>(p)[c], part);
#pragma unroll
      for (int j = 0; j < kPer; ++j) out[c * kPer + j] = part[j];
    }
  } else {
    static_assert(kBytes == 8, "a run of 8 or a multiple of 16 bytes");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
  }
}

// N f32 values rounded to T and stored at p as whole 16-byte words.
template <typename T, int N>
__device__ __forceinline__ void store_from_f32(T* p, const float (&v)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes % 16 == 0, "whole 16-byte words");
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int c = 0; c < kBytes / 16; ++c) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = from_f32<T>(v[c * kPer + j]);
    reinterpret_cast<uint4*>(p)[c] = raw;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// g / (1 + expf(-g)), as PyTorch's CUDA silu kernel computes it in f32.
__device__ __forceinline__ float silu(float g) {
  return __fdiv_rn(g, __fadd_rn(1.0f, expf(-g)));
}

}  // namespace

// The kernels sit outside the anonymous namespace so that their names in a
// profile read ctdb_rms_norm_kernel<...> and ctdb_swiglu_act_kernel<...>.

// One row of x [rows, d] per block (kWarpRow false) or per warp (true); each
// thread holds up to VPT 16-byte vectors of its row, vector c of the row at
// c = lane + i * (threads of the row).
template <typename T, typename S, int VPT, bool kWarpRow>
__global__ void __launch_bounds__(1024)
ctdb_rms_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                     T* __restrict__ y, long long rows, int d, float mean_factor,
                     float eps) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int nvec = d / VEC;
  long long row;
  int tid, nthreads;
  if constexpr (kWarpRow) {
    row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
    if (row >= rows) return;  // the whole warp leaves; no block barrier below
    tid = threadIdx.x % 32;
    nthreads = 32;
  } else {
    row = blockIdx.x;
    tid = threadIdx.x;
    nthreads = blockDim.x;
  }
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  T* yr = y + row * d;

  // The row stays in registers as loaded (16 bytes a vector, whatever T),
  // which leaves room for more blocks an SM than f32 copies would.
  uint4 raw[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * nthreads;
    if (c < nvec) raw[i] = xr[c];
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * nthreads;
    if (c < nvec) {
      float v[VEC];
      unpack_f32<T>(raw[i], v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
    }
  }
  ss = warp_sum(ss);
  if constexpr (!kWarpRow) {
    __shared__ float part[32];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    // Every warp sums the partials alike: one barrier, the same total.
    ss = warp_sum(lane < static_cast<int>(blockDim.x / 32) ? part[lane] : 0.0f);
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, mean_factor), eps));

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = tid + i * nthreads;
    if (c < nvec) {
      float v[VEC], s[VEC], o[VEC];
      unpack_f32<T>(raw[i], v);
      load_f32<S, VEC>(scale + c * VEC, s);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = __fmul_rn(__fmul_rn(v[j], r), s[j]);
      store_from_f32<T, VEC>(yr + c * VEC, o);
    }
  }
}

template <typename O>
__global__ void __launch_bounds__(256)
ctdb_swiglu_act_kernel(const float* __restrict__ gate, const float* __restrict__ up,
                       O* __restrict__ out, long long n) {
  const long long nvec = n / 8;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float4* g4 = reinterpret_cast<const float4*>(gate);
  const float4* u4 = reinterpret_cast<const float4*>(up);
  for (long long i = first; i < nvec; i += stride) {
    const float4 ga = g4[2 * i], gb = g4[2 * i + 1];
    const float4 ua = u4[2 * i], ub = u4[2 * i + 1];
    const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    const float u[8] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
    float h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = __fmul_rn(silu(g[j]), u[j]);
    store_from_f32<O, 8>(out + 8 * i, h);
  }
  const long long t = nvec * 8 + first;
  if (t < n) out[t] = from_f32<O>(__fmul_rn(silu(gate[t]), up[t]));
}

namespace {

template <typename T, typename S>
int launch_rms_norm(const void* x, const void* scale, void* y, long long rows, int d,
                    float mean_factor, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const T* xt = static_cast<const T*>(x);
  const S* st_scale = static_cast<const S*>(scale);
  T* yt = static_cast<T*>(y);
  if (d <= 1024) {
    constexpr int VPT = 1024 / VEC / 32;
    constexpr int kRowsPerBlock = 8;
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    ctdb_rms_norm_kernel<T, S, VPT, true>
        <<<static_cast<unsigned>(blocks), 32 * kRowsPerBlock, 0, st>>>(
            xt, st_scale, yt, rows, d, mean_factor, eps);
  } else {
    constexpr int VPT = 4;
    const int nvec = d / VEC;
    const int threads = ((nvec + VPT - 1) / VPT + 31) / 32 * 32;
    if (threads > 1024 || rows > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    ctdb_rms_norm_kernel<T, S, VPT, false>
        <<<static_cast<unsigned>(rows), threads, 0, st>>>(xt, st_scale, yt, rows, d,
                                                         mean_factor, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y [rows, d] contiguous, 16-byte aligned, in x_dtype (0 f32, 1 bf16);
// scale [d] in scale_dtype; d a multiple of 8, at most 4096 16-byte vectors
// (32768 in bf16, 16384 in f32); mean_factor = f32(rows) / f32(rows * d).
int ctdb_rms_norm(const void* x, const void* scale, void* y, long long rows, int d,
                  int x_dtype, int scale_dtype, float mean_factor, float eps,
                  void* stream) {
  if (rows < 1 || d < 8 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16 && scale_dtype == kBF16)
    return launch_rms_norm<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d,
                                                         mean_factor, eps, st);
  if (x_dtype == kBF16 && scale_dtype == kF32)
    return launch_rms_norm<__nv_bfloat16, float>(x, scale, y, rows, d, mean_factor,
                                                 eps, st);
  if (x_dtype == kF32 && scale_dtype == kBF16)
    return launch_rms_norm<float, __nv_bfloat16>(x, scale, y, rows, d, mean_factor,
                                                 eps, st);
  if (x_dtype == kF32 && scale_dtype == kF32)
    return launch_rms_norm<float, float>(x, scale, y, rows, d, mean_factor, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gate, up [n] f32, out [n] in out_dtype (0 f32, 1 bf16), all contiguous
// and 16-byte aligned; blocks of 256 threads, at most 8 an SM.
int ctdb_swiglu_act(const float* gate, const float* up, void* out, long long n,
                    int out_dtype, int sm_count, void* stream) {
  if (n < 1 || sm_count < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  const long long want = (n / 8 + kThreads - 1) / kThreads;
  const long long cap = 8LL * sm_count;
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  if (out_dtype == kBF16)
    ctdb_swiglu_act_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        gate, up, static_cast<__nv_bfloat16*>(out), n);
  else if (out_dtype == kF32)
    ctdb_swiglu_act_kernel<float><<<blocks, kThreads, 0, st>>>(
        gate, up, static_cast<float*>(out), n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
