"""The flash attention forward's least time over its summed device time,
in the traced decode batch.

Counted at each row's unpadded length S: QKᵀ and PV, 4 · S² · H · Dh
FLOPs a row and layer; q, k and v read once and the output written once,
in bf16.  Least time: the larger of FLOPs over the bf16 peak and bytes
over the memory's peak, per layer and forward pass."""

KERNELS = ("flash_fwd_kernel", "flash_direct_kernel")
BYTES = 2   # bf16


def least_seconds(s, calls, peaks):
    H, KV, Dh = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    total = 0.0
    for c in calls:
        flops = sum(4.0 * n * n * H * Dh for n in c.rows)
        moved = BYTES * sum(n * (2 * H + 2 * KV) * Dh for n in c.rows)
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
