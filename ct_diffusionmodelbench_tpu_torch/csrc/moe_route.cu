// G4 and G5: the MoE layer's routing, from the router's f32 logits to the
// expert kernels' (K1/K2) inputs.
//
// Replaces (TPU): no Pallas kernel.  The reference routes with XLA: a
//   softmax, `lax.top_k` and the renormalisation (models/moe.py), then the
//   padded layout and its row gather (ops/grouped_gemm_pallas.py), which XLA
//   fuses.  Eager PyTorch ran them as some forty small kernels a layer
//   (ops/grouped_gemm_cuda.py: router_topk_plain, counting_layout,
//   gather_rows, valid_tiles), each bound by its latency: at sdar30b-eval's
//   cached pass (N 128 tokens, k 8, E 128: 1024 routing slots) about 110 us a
//   layer for a few kilobytes of indices and 128 rows of 4 KB.
//
// G4, ctdb_moe_topk_kernel<kIter>: logits [N, E] f32 -> probs [N, E] f32
//   (the softmax), topk_probs [N, k] f32, topk_idx [N, k] int64.  One warp a
//   row, lane l holding columns l + 32 i.  It repeats the arithmetic of the
//   chain on the card, so that every output is bit-equal to it:
//   - the softmax is PyTorch's warp softmax for rows of at most 1024
//     (aten/src/ATen/native/cuda/PersistentSoftmax.cuh, softmax_warp_forward):
//     -inf past E, the max, expf(v - max), each lane's sum from 0.0f in
//     column order, an xor butterfly 16, 8, 4, 2, 1, one divide (a lane past
//     E adds exact zeros, so a row narrower than the warp sums as PyTorch's
//     narrower warp does);
//   - the top-k is k rounds of a warp arg-max: larger first, NaN first, a
//     tie to the lower column, as a stable descending sort orders them;
//   - the renormalisation repeats PyTorch's sum over the k-slice (Reduce.cuh:
//     last_pow2(k) lanes, lane t adding columns t and t + last_pow2(k), then a
//     shfl_down tree from the widest offset) and one divide.
//
// G5, ctdb_moe_layout: topk_idx [N, k] int64 (any strides), x [N, D] ->
//   dest [N k] int64, tile_expert, tile_valid [m_pad / tile_m] int32, sizes
//   [E] int32, x_padded [m_pad, D]: counting_layout's padded layout, row for
//   row (each expert's slots in slot order, its group rounded up to whole
//   tiles, the dropped group of expert parallelism last; tile_expert clamped
//   to E - 1), valid_tiles' pad-skip vector, and gather_rows' real rows.  The
//   pad rows of x_padded are left unwritten: they feed only rows of K1/K2's
//   outputs that the combine (G3) never reads, and a tile with no real row is
//   skipped by tile_valid.  (GroupedFFN's backward gathers its own rows: a pad
//   row there meets a zero cotangent, and NaN times zero would reach the
//   weight gradients.)
//   Three kernels, one grid shape whatever M = N k is:
//   - count: a CTA of 1024 threads a chunk of 2048 slots, in steps of 1024
//     slots in order; __match_any_sync ranks a slot among its warp's slots of
//     the same expert, per-warp counts in shared memory are scanned over the
//     warps per expert, so the rank within the chunk is stable; it writes
//     the chunk's ranks into dest and its counts;
//   - scan: one CTA turns the chunks' counts into each chunk's first row
//     per expert and builds sizes, tile_expert and tile_valid; with one
//     chunk (M <= 2048, every cached pass) the count CTA does this itself and
//     this launch is left out;
//   - gather: a CTA a token adds its chunk's base to its k slots' ranks and
//     copies its row to its k rows, 16 bytes a thread, the row read once.
//
// Bound on an H100 SXM: bytes, and at these sizes latency.  At the cached
// pass G4 reads 64 KB and writes 72 KB, G5 reads 8 KB of indices and 0.5 MB
// of rows and writes 4 MB of rows: ~1.3 us of the 3.35 TB/s together; the
// time is the launches and a few dependent trips to memory.  At SDAR's
// prefill (M 147 456, tile_m 128) the gather writes 604 MB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kTopkThreads = 128;            // four rows a block
constexpr int kMaxTopK = 32;
constexpr int kLayoutThreads = 1024;
constexpr int kLayoutWarps = kLayoutThreads / kWarp;
constexpr int kChunk = 2048;                 // routing slots a count CTA
constexpr int kMaxGroups = 512;              // experts, plus the dropped group
constexpr int kCountRow = kMaxGroups + 2;    // 257 words: a column read hits 32 banks
constexpr int kGatherThreads = 128;
constexpr int kMaxSlots = 64;                // k of the gather

// a before b in a stable descending sort of (value, column): NaN first, then
// the larger value, a tie to the lower column.
__device__ __forceinline__ bool ahead(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

}  // namespace

// Outside the anonymous namespace, so that a profile reads the ctdb_ names.
template <int kIter>
__global__ void __launch_bounds__(kTopkThreads)
ctdb_moe_topk_kernel(const float* __restrict__ logits, float* __restrict__ probs,
                     float* __restrict__ topk_probs, long long* __restrict__ topk_idx, int n,
                     int e, int k, int norm) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kTopkThreads / kWarp) + threadIdx.x / kWarp;
  if (row >= n) return;  // a whole warp
  const float* src = logits + row * e;
  float v[kIter];
  unsigned live = 0;
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int c = lane + it * kWarp;
    v[it] = c < e ? src[c] : -INFINITY;
    if (c < e) live |= 1u << it;
  }
  float mx = v[0];
#pragma unroll
  for (int it = 0; it < kIter; ++it) mx = mx > v[it] ? mx : v[it];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(kFull, mx, off);
    mx = mx < o ? o : mx;
  }
  float sum = 0.0f;
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    v[it] = expf(v[it] - mx);
    sum = __fadd_rn(sum, v[it]);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
  float* dst = probs + row * e;
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    v[it] = sum == 0.0f ? NAN : __fdiv_rn(v[it], sum);
    const int c = lane + it * kWarp;
    if (c < e) dst[c] = v[it];
  }

  // k rounds of a warp arg-max; round r's winner stays in lane r.
  float mine = 0.0f;
  int mine_idx = 0;
  for (int r = 0; r < k; ++r) {
    float bv = 0.0f;
    int bi = -1;
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
      const int c = lane + it * kWarp;
      if (((live >> it) & 1u) && (bi < 0 || ahead(v[it], c, bv, bi))) {
        bv = v[it];
        bi = c;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (oi >= 0 && (bi < 0 || ahead(ov, oi, bv, bi))) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi % kWarp == lane) live &= ~(1u << (bi / kWarp));
    if (lane == r) {
      mine = bv;
      mine_idx = bi;
    }
  }

  float out = mine;
  if (norm) {
    int width = 1;
    while (width * 2 <= k) width *= 2;
    const float upper = __shfl_down_sync(kFull, mine, width);
    float s = lane + width < k ? __fadd_rn(mine, upper) : mine;
    for (int off = width / 2; off > 0; off /= 2)
      s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
    out = __fdiv_rn(mine, __shfl_sync(kFull, s, 0));
  }
  if (lane < k) {
    topk_probs[row * k + lane] = out;
    topk_idx[row * k + lane] = mine_idx;
  }
}

// G4's sigmoid mode (DeepSeek-V3's noaux_tc router with one group):
// logits [N, E] f32 -> probs [N, E] the sigmoid scores, topk_idx the k
// columns of the largest scores + bias[c] (bias null: + nothing), in the
// stable descending order of ctdb_moe_topk_kernel, topk_probs the chosen
// unbiased scores, with norm divided by their sum + 1e-20 (PyTorch's
// k-slice sum, as above), times scale.  Each step is the chain's op on the
// card: 1 / (1 + expf(-x)) for torch.sigmoid, one f32 add for the bias,
// __fadd_rn / __fdiv_rn / __fmul_rn for the renormalisation and the scale.
template <int kIter>
__global__ void __launch_bounds__(kTopkThreads)
ctdb_moe_topk_sigmoid_kernel(const float* __restrict__ logits, const float* __restrict__ bias,
                             float* __restrict__ probs, float* __restrict__ topk_probs,
                             long long* __restrict__ topk_idx, int n, int e, int k, int norm,
                             float scale) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kTopkThreads / kWarp) + threadIdx.x / kWarp;
  if (row >= n) return;  // a whole warp
  const float* src = logits + row * e;
  float* dst = probs + row * e;
  float v[kIter];   // the scores
  float u[kIter];   // the selection values
  unsigned live = 0;
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int c = lane + it * kWarp;
    v[it] = 0.0f;
    u[it] = 0.0f;
    if (c < e) {
      v[it] = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-src[c])));
      u[it] = bias == nullptr ? v[it] : __fadd_rn(v[it], bias[c]);
      dst[c] = v[it];
      live |= 1u << it;
    }
  }

  float mine = 0.0f;
  int mine_idx = 0;
  for (int r = 0; r < k; ++r) {
    float bu = 0.0f, bv = 0.0f;
    int bi = -1;
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
      const int c = lane + it * kWarp;
      if (((live >> it) & 1u) && (bi < 0 || ahead(u[it], c, bu, bi))) {
        bu = u[it];
        bv = v[it];
        bi = c;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const float ou = __shfl_xor_sync(kFull, bu, off);
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (oi >= 0 && (bi < 0 || ahead(ou, oi, bu, bi))) {
        bu = ou;
        bv = ov;
        bi = oi;
      }
    }
    if (bi % kWarp == lane) live &= ~(1u << (bi / kWarp));
    if (lane == r) {
      mine = bv;
      mine_idx = bi;
    }
  }

  float out = mine;
  if (norm) {
    int width = 1;
    while (width * 2 <= k) width *= 2;
    const float upper = __shfl_down_sync(kFull, mine, width);
    float s = lane + width < k ? __fadd_rn(mine, upper) : mine;
    for (int off = width / 2; off > 0; off /= 2)
      s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
    out = __fdiv_rn(mine, __fadd_rn(__shfl_sync(kFull, s, 0), 1e-20f));
  }
  out = __fmul_rn(out, scale);
  if (lane < k) {
    topk_probs[row * k + lane] = out;
    topk_idx[row * k + lane] = mine_idx;
  }
}

namespace {

// The layout's tail, by one CTA, from each group's size in shared memory:
// the groups' first padded rows (pstart[g], pstart[groups] = the last end),
// sizes [e], tile_expert and tile_valid.
__device__ void finish_layout(const int* size, int* pstart, int groups, int e, int tile_m,
                              int tiles, int* __restrict__ sizes,
                              int* __restrict__ tile_expert, int* __restrict__ tile_valid) {
  const int lane = threadIdx.x % kWarp;
  if (threadIdx.x < kWarp) {
    int carry = 0;
    for (int g0 = 0; g0 < groups; g0 += kWarp) {
      const int g = g0 + lane;
      const int padded = g < groups ? (size[g] + tile_m - 1) / tile_m * tile_m : 0;
      int inc = padded;
#pragma unroll
      for (int off = 1; off < kWarp; off *= 2) {
        const int o = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += o;
      }
      if (g < groups) pstart[g] = carry + inc - padded;
      carry += __shfl_sync(kFull, inc, kWarp - 1);
    }
    if (lane == 0) pstart[groups] = carry;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < e; g += blockDim.x) sizes[g] = size[g];
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int start = t * tile_m;
    int lo = 0, hi = groups;  // lo: the groups that end at or before start
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (pstart[mid + 1] <= start) lo = mid + 1;
      else hi = mid;
    }
    const int te = lo < e - 1 ? lo : e - 1;
    tile_expert[t] = te;
    tile_valid[t] = start < pstart[te] + size[te] ? 1 : 0;
  }
}

}  // namespace

__global__ void __launch_bounds__(kLayoutThreads)
ctdb_moe_layout_count_kernel(const long long* __restrict__ idx, long long row_stride,
                             long long col_stride, int k, int m, int groups, int e,
                             int tile_m, int tiles, long long* __restrict__ dest,
                             int* __restrict__ base, int* __restrict__ sizes,
                             int* __restrict__ tile_expert, int* __restrict__ tile_valid) {
  __shared__ __align__(16) unsigned short warp_count[kLayoutWarps * kCountRow];
  __shared__ int total[kMaxGroups];
  __shared__ int pstart[kMaxGroups + 1];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  for (int g = threadIdx.x; g < groups; g += kLayoutThreads) total[g] = 0;
  __syncthreads();
  const int begin = blockIdx.x * kChunk;
  const int end = min(m, begin + kChunk);
  for (int s0 = begin; s0 < end; s0 += kLayoutThreads) {
    uint4* words = reinterpret_cast<uint4*>(warp_count);
    for (int i = threadIdx.x; i < kLayoutWarps * kCountRow / 8; i += kLayoutThreads)
      words[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    const int s = s0 + threadIdx.x;
    const bool here = s < end;
    int g = -1;
    if (here) {
      const long long id = idx[(s / k) * row_stride + (s % k) * col_stride];
      if (id < 0 || id >= groups) __trap();  // as index_select's device assert
      g = static_cast<int>(id);
    }
    const unsigned peers = __match_any_sync(kFull, g);
    const int before = __popc(peers & lanes_below());
    if (here && before == 0) warp_count[warp * kCountRow + g] = __popc(peers);
    __syncthreads();
    // Per expert, the warps' counts -> each warp's first rank (warp w scans
    // experts w, w + 32, ...; lane l reads warp l's count).
    for (int gg = warp; gg < groups; gg += kLayoutWarps) {
      const int c = warp_count[lane * kCountRow + gg];
      int inc = c;
#pragma unroll
      for (int off = 1; off < kWarp; off *= 2) {
        const int o = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += o;
      }
      const int run = total[gg];
      __syncwarp();
      warp_count[lane * kCountRow + gg] = static_cast<unsigned short>(run + inc - c);
      if (lane == kWarp - 1) total[gg] = run + inc;
    }
    __syncthreads();
    if (here) dest[s] = warp_count[warp * kCountRow + g] + before;
    __syncthreads();
  }
  if (gridDim.x > 1) {
    for (int gg = threadIdx.x; gg < groups; gg += kLayoutThreads)
      base[blockIdx.x * groups + gg] = total[gg];
    return;
  }
  finish_layout(total, pstart, groups, e, tile_m, tiles, sizes, tile_expert, tile_valid);
  for (int gg = threadIdx.x; gg < groups; gg += kLayoutThreads) base[gg] = pstart[gg];
}

__global__ void __launch_bounds__(kLayoutThreads)
ctdb_moe_layout_scan_kernel(int* __restrict__ base, int chunks, int groups, int e, int tile_m,
                            int tiles, int* __restrict__ sizes, int* __restrict__ tile_expert,
                            int* __restrict__ tile_valid) {
  __shared__ int size[kMaxGroups];
  __shared__ int pstart[kMaxGroups + 1];
  for (int g = threadIdx.x; g < groups; g += kLayoutThreads) {
    int run = 0;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) {
      const int v = base[c * groups + g];
      base[c * groups + g] = run;
      run += v;
    }
    size[g] = run;
  }
  __syncthreads();
  finish_layout(size, pstart, groups, e, tile_m, tiles, sizes, tile_expert, tile_valid);
  for (int g = threadIdx.x; g < groups; g += kLayoutThreads) {
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) base[c * groups + g] += pstart[g];
  }
}

__global__ void __launch_bounds__(kGatherThreads)
ctdb_moe_layout_gather_kernel(const long long* __restrict__ idx, long long row_stride,
                              long long col_stride, int k, int groups,
                              const int* __restrict__ base, long long* __restrict__ dest,
                              const uint4* __restrict__ x, uint4* __restrict__ x_padded,
                              int row_words) {
  __shared__ long long rows[kMaxSlots];
  const long long tok = blockIdx.x;
  if (threadIdx.x < k) {
    const long long s = tok * k + threadIdx.x;
    const int g = static_cast<int>(idx[tok * row_stride + threadIdx.x * col_stride]);
    const long long r = dest[s] + base[(s / kChunk) * groups + g];
    dest[s] = r;
    rows[threadIdx.x] = r;
  }
  __syncthreads();
  const uint4* src = x + tok * row_words;
  for (int w = threadIdx.x; w < row_words; w += kGatherThreads) {
    const uint4 word = src[w];
    for (int j = 0; j < k; ++j) x_padded[rows[j] * row_words + w] = word;
  }
}

namespace {

template <int kIter>
int launch_topk(const float* logits, float* probs, float* topk_probs, long long* topk_idx,
                int n, int e, int k, int norm, cudaStream_t st) {
  constexpr int rows = kTopkThreads / kWarp;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + rows - 1) / rows);
  ctdb_moe_topk_kernel<kIter><<<blocks, kTopkThreads, 0, st>>>(logits, probs, topk_probs,
                                                               topk_idx, n, e, k, norm);
  return static_cast<int>(cudaGetLastError());
}

template <int kIter>
int launch_topk_sigmoid(const float* logits, const float* bias, float* probs, float* topk_probs,
                        long long* topk_idx, int n, int e, int k, int norm, float scale,
                        cudaStream_t st) {
  constexpr int rows = kTopkThreads / kWarp;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + rows - 1) / rows);
  ctdb_moe_topk_sigmoid_kernel<kIter><<<blocks, kTopkThreads, 0, st>>>(
      logits, bias, probs, topk_probs, topk_idx, n, e, k, norm, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// As ctdb_moe_topk, in G4's sigmoid mode: bias [e] f32 or null, scale the
// routed scaling factor.
int ctdb_moe_topk_sigmoid(const float* logits, const float* bias, float* probs,
                          float* topk_probs, long long* topk_idx, int n, int e, int k, int norm,
                          float scale, void* stream) {
  if (n < 1 || e < 1 || e > 32 * kWarp || k < 1 || k > e || k > kMaxTopK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_lane = (e + kWarp - 1) / kWarp;
#define CTDB_TOPK_SIGMOID(I)                                                                  \
  return launch_topk_sigmoid<I>(logits, bias, probs, topk_probs, topk_idx, n, e, k, norm, scale, \
                                st)
  if (per_lane <= 1) CTDB_TOPK_SIGMOID(1);
  if (per_lane <= 2) CTDB_TOPK_SIGMOID(2);
  if (per_lane <= 4) CTDB_TOPK_SIGMOID(4);
  if (per_lane <= 8) CTDB_TOPK_SIGMOID(8);
  if (per_lane <= 16) CTDB_TOPK_SIGMOID(16);
  CTDB_TOPK_SIGMOID(32);
#undef CTDB_TOPK_SIGMOID
}

// logits [n, e] f32 contiguous; probs [n, e], topk_probs [n, k] f32 and
// topk_idx [n, k] int64, contiguous; 1 <= e <= 1024, 1 <= k <= min(e, 32).
int ctdb_moe_topk(const float* logits, float* probs, float* topk_probs, long long* topk_idx,
                  int n, int e, int k, int norm, void* stream) {
  if (n < 1 || e < 1 || e > 32 * kWarp || k < 1 || k > e || k > kMaxTopK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_lane = (e + kWarp - 1) / kWarp;
  if (per_lane <= 1) return launch_topk<1>(logits, probs, topk_probs, topk_idx, n, e, k, norm, st);
  if (per_lane <= 2) return launch_topk<2>(logits, probs, topk_probs, topk_idx, n, e, k, norm, st);
  if (per_lane <= 4) return launch_topk<4>(logits, probs, topk_probs, topk_idx, n, e, k, norm, st);
  if (per_lane <= 8) return launch_topk<8>(logits, probs, topk_probs, topk_idx, n, e, k, norm, st);
  if (per_lane <= 16)
    return launch_topk<16>(logits, probs, topk_probs, topk_idx, n, e, k, norm, st);
  return launch_topk<32>(logits, probs, topk_probs, topk_idx, n, e, k, norm, st);
}

// idx [n, k] int64, element (t, j) at t * row_stride + j * col_stride, each
// in [0, groups); x [n, row_words * 16 bytes] and x_padded [m_pad, the same]
// contiguous and 16-byte aligned, m_pad = tiles * tile_m; dest [n * k] int64,
// sizes [e], tile_expert and tile_valid [tiles] int32; base, the chunks'
// counts, holds base_len >= max(1, ceil(n * k / 2048)) * groups int32;
// groups is e, or e + 1 with the dropped group, at most 512; k at most 64.
int ctdb_moe_layout(const long long* idx, long long row_stride, long long col_stride,
                    const void* x, void* x_padded, long long* dest, int* base, long long base_len,
                    int* sizes, int* tile_expert, int* tile_valid, int n, int k, int groups,
                    int e, int tile_m, int tiles, int row_words, void* stream) {
  const long long m = static_cast<long long>(n) * k;
  const long long chunks = m > kChunk ? (m + kChunk - 1) / kChunk : 1;
  if (n < 0 || k < 1 || k > kMaxSlots || e < 1 || groups < e || groups > e + 1 ||
      groups > kMaxGroups || tile_m < 1 || row_words < 1 ||
      static_cast<long long>(tiles) * tile_m < m ||
      static_cast<long long>(tiles) * tile_m > 0x7fffffffLL ||
      chunks * groups > base_len)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ctdb_moe_layout_count_kernel<<<static_cast<unsigned>(chunks), kLayoutThreads, 0, st>>>(
      idx, row_stride, col_stride, k, static_cast<int>(m), groups, e, tile_m, tiles, dest, base,
      sizes, tile_expert, tile_valid);
  if (chunks > 1)
    ctdb_moe_layout_scan_kernel<<<1, kLayoutThreads, 0, st>>>(
        base, static_cast<int>(chunks), groups, e, tile_m, tiles, sizes, tile_expert, tile_valid);
  if (n > 0)
    ctdb_moe_layout_gather_kernel<<<static_cast<unsigned>(n), kGatherThreads, 0, st>>>(
        idx, row_stride, col_stride, k, groups, base, dest, static_cast<const uint4*>(x),
        static_cast<uint4*>(x_padded), row_words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
