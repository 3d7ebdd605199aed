"""The latent-attention prefill kernel's least time over its summed device
time, in the traced decode batch: the up-projected block-causal attention
of every prompt (K8's design at q/k heads of 192 and v heads of 128).

Counted from the program's prefill counters of the traced batch
(``run.span_slice``): ``mla.prefill_pairs``, the block-causal query-key
pairs over real queries and real keys alone (the kernel skips the left
padding's tiles), and ``mla.prefill_queries``, the real prompt tokens.  Per
layer: 2 · pairs · H · (Dqk + Dv) FLOPs (QKᵀ over 192 dims, PV over 128);
q, k, v read once and the output written once for the real tokens (tokens
· H · (2 · Dqk + 2 · Dv) values), in bf16.  Least time: the larger of
FLOPs over the bf16 peak and bytes over the memory's peak (bound by
operations: a 16k-32k-token row)."""

KERNELS = ("mla_prefill_kernel",)
BYTES = 2   # bf16


def least_seconds(conf, counters, peaks):
    H, L = conf["num_attention_heads"], conf["num_hidden_layers"]
    dqk = conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"]
    dv = conf["v_head_dim"]
    flops = 2.0 * counters["mla.prefill_pairs"] * H * (dqk + dv)
    moved = BYTES * counters["mla.prefill_queries"] * H * 2.0 * (dqk + dv)
    return L * max(flops / peaks["bf16"], moved / peaks["bytes"])


def read(run):
    sl, sp = run.slice, getattr(run, "span_slice", None)
    if (sl is None or sp is None or run.peaks is None
            or not sp.counters.get("mla.prefill_pairs")):
        return None
    spent = sl.seconds(*KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run.cell.config, sp.counters, run.peaks) / spent
