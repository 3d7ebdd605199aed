"""The routed expert FFN's least time over the grouped expert kernels'
summed device time, in the traced decode batch, for a configuration file
in DeepSeek-V3's keys (``model_type`` ``deepseek_v3``).

``grouped_ffn_roofline.decode``'s count, read from the file's own names:
``n_routed_experts`` experts of ``moe_intermediate_size``, top
``num_experts_per_tok``, in the layers after the first
``first_k_dense_replace`` (those are dense, and their FFN is a dense
product).  Per expert layer and pass: the routed rows' three products (6 ·
N · k · D · Fm FLOPs for N real tokens), each input read once (the N token
rows, the weights of the experts hit) and the output written once, in
bf16.  The experts hit are counted as N tokens choosing k of E experts
each at random hit them, E · (1 - (1 - k / E)^N), not as min(E, N · k):
at a cached pass's 16 rows top-6 of 128 that is 68.6 experts, not 96, and
the kernels read no weights of an expert that no row chose (with
min(E, N · k) this share read 104-106 % on an H100).  The shared experts
are dense products.  Least time: the larger of FLOPs over the bf16 peak
and bytes over the memory's peak."""

KERNELS = ("grouped_gemm_kernel", "grouped_ffn_fused_kernel", "grouped_gemm_q_kernel")
BYTES = 2   # bf16


def least_seconds(conf, calls, peaks):
    D, Fm, k, E = (conf["hidden_size"], conf["moe_intermediate_size"],
                   conf["num_experts_per_tok"], conf["n_routed_experts"])
    layers = conf["num_hidden_layers"] - conf.get("first_k_dense_replace", 0)
    total = 0.0
    for c in calls:
        n = sum(c.rows)
        flops = 6.0 * n * k * D * Fm
        hit = E * (1.0 - (1.0 - k / E) ** n)
        moved = BYTES * (2.0 * n * D + hit * 3.0 * D * Fm)
        total += max(flops / peaks["bf16"], moved / peaks["bytes"])
    return layers * total


def read(run):
    sl, conf = run.slice, run.cell.config
    if (sl is None or not run.slice_calls or run.peaks is None
            or not conf.get("n_routed_experts")):
        return None
    spent = sl.seconds(*KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(conf, run.slice_calls, run.peaks) / spent
