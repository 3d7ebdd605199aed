"""The dense products' least time over the device time of the GEMM
kernels, in the traced decode batch.

The products of a forward pass, over its N real tokens (padding not counted):
per layer the QKV projection, ``wo``, the dense FFN or the shared expert
(gate and up, then down), and the router (float32: the program routes in
float32); per pass the LM head over the positions it asked for in each
row (one block, in the LLaDA sampler).  Each product
reads its inputs once and writes its output once (bf16, the router's and
the head's logits float32); its least time is the larger of FLOPs over the
peak of its dtype and bytes over the memory's peak, and the products'
least times add up.  The device time is that of the kernels whose names
hold one of ``PATTERNS`` and none of ``EXCLUDE`` (cuBLAS's and CUTLASS's
GEMM kernels; the expert and attention kernels are the port's own)."""

PATTERNS = ("nvjet", "gemm", "gemv", "xmma", "cutlass", "splitKreduce")
EXCLUDE = ("grouped_gemm_kernel", "grouped_ffn_fused_kernel", "grouped_gemm_q_kernel",
           "flash_")


def _product(m, k, n, peak, in_bytes, out_bytes, peaks):
    flops = 2.0 * m * k * n
    moved = in_bytes * (m * k + k * n) + out_bytes * m * n
    return max(flops / peak, moved / peaks["bytes"])


def least_seconds(s, calls, peaks):
    D, L = s["hidden_size"], s["num_layers"]
    q, kv = s["num_heads"] * s["head_dim"], s["num_kv_heads"] * s["head_dim"]
    bf, f32 = peaks["bf16"], peaks["f32"]
    if s["num_experts"]:
        F = s["moe_intermediate_size"] * s["num_shared_experts"]
    else:
        F = s["intermediate_size"]
    total = 0.0
    for c in calls:
        n = sum(c.rows)
        layer = (_product(n, D, q + 2 * kv, bf, 2, 2, peaks)
                 + _product(n, q, D, bf, 2, 2, peaks))
        if s["num_experts"]:
            layer += _product(n, D, s["num_experts"], f32, 4, 4, peaks)
        if F:
            layer += (_product(n, D, 2 * F, bf, 2, 2, peaks)
                      + _product(n, F, D, bf, 2, 2, peaks))
        head = _product(len(c.rows) * c.head, D, s["vocab_size"], bf, 2, 4, peaks)
        total += L * layer + head
    return total


def read(run):
    sl = run.slice
    if sl is None or not run.slice_calls or run.peaks is None:
        return None
    spent = sl.seconds(*PATTERNS, exclude=EXCLUDE)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run.sizes, run.slice_calls, run.peaks) / spent
