"""The routed expert FFN's least time over the grouped expert kernels'
summed device time, in the traced decode batch.

Counted for the whole routed FFN of a layer, whatever kernels a version
of the program splits it into: the routed rows' three products (gate, up,
down: 6 · N · k · D · Fm FLOPs for N real tokens routed to k experts each),
each input read once (the N token rows, the weights of the experts hit,
which is all of them once N · k passes the expert count) and the output
written once, in bf16.  Least time: the larger of FLOPs over the bf16 peak
and bytes over the memory's peak, per layer and forward pass."""

KERNELS = ("grouped_gemm_kernel", "grouped_ffn_fused_kernel", "grouped_gemm_q_kernel")
BYTES = 2   # bf16


def least_seconds(s, calls, peaks):
    D, Fm, k, E = (s["hidden_size"], s["moe_intermediate_size"],
                   s["num_experts_per_tok"], s["num_experts"])
    total = 0.0
    for c in calls:
        n = sum(c.rows)
        flops = 6.0 * n * k * D * Fm
        hit = min(E, n * k)
        moved = BYTES * (2.0 * n * D + hit * 3.0 * D * Fm)
        total += max(flops / peaks["bf16"], moved / peaks["bytes"])
    return s["num_layers"] * total


def read(run):
    sl = run.slice
    if sl is None or not run.slice_calls or run.peaks is None or not run.sizes["num_experts"]:
        return None
    spent = sl.seconds(*KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run.sizes, run.slice_calls, run.peaks) / spent
