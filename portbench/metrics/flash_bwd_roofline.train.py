"""The flash attention backward's least time over the summed device time
of its kernels (dq; dk and dv), in the traced training step.

Counted a layer and micro-batch row of S tokens: S = QKᵀ recomputed once,
dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K and dK = dSᵀ·Q, 10 · S² · H · Dh FLOPs;
q, o and dO (H heads), k and v (KV heads) read once in bf16 with the
float32 log-sum-exp rows, dq, dk and dv written once in bf16.  Least time:
the larger of FLOPs over the bf16 peak and bytes over the memory's peak."""

KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def least_seconds(s, calls, peaks):
    H, KV, Dh = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    total = 0.0
    for c in calls:
        for n in c.rows:
            flops = 10.0 * n * n * H * Dh
            moved = 2 * n * Dh * ((3 * H + 2 * KV) + (H + 2 * KV)) + 4 * n * H
            total += max(flops / peaks["bf16"], moved / peaks["bytes"])
    return s["num_layers"] * total


def read(run):
    sl = run.slice
    if sl is None or not run.slice_calls or run.peaks is None:
        return None
    spent = sl.seconds(*KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run.sizes, run.slice_calls, run.peaks) / spent
