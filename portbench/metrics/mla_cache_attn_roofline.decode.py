"""K13's least time over its summed device time, in the traced decode
batch: latent attention's absorbed form of a block against the latent
cache, in every denoising step and commit (its split kernel and its merge).

Counted from the program's latent-cache counters of the traced batch (its
spans joined to the same trace, ``run.span_slice``): ``mla.keys``, the keys
the passes' attention reads summed over rows; ``mla.queries``, their query
positions; ``mla.pairs``, the query-key pairs.  Per layer: 2 · pairs · H ·
(576 + 512) FLOPs (QKᵀ over the latent key and its rope part, PV over the
latent value); each key's latent row read once a row (keys · 576 values),
q read once (queries · H · 576) and the output written once (queries · H ·
512), in bf16.  Least time: the larger of FLOPs over the bf16 peak and
bytes over the memory's peak, of the batch's sums (near the card's ridge:
the 128 query rows of a row share every key)."""

KERNELS = ("mla_latent_attn_kernel", "mla_latent_merge_kernel")
BYTES = 2   # bf16


def least_seconds(conf, counters, peaks):
    H, L = conf["num_attention_heads"], conf["num_hidden_layers"]
    key, value = conf["kv_lora_rank"] + conf["qk_rope_head_dim"], conf["kv_lora_rank"]
    flops = 2.0 * counters["mla.pairs"] * H * (key + value)
    moved = BYTES * (counters["mla.keys"] * key
                     + counters["mla.queries"] * H * (key + value))
    return L * max(flops / peaks["bf16"], moved / peaks["bytes"])


def read(run):
    sl, sp = run.slice, getattr(run, "span_slice", None)
    if sl is None or sp is None or run.peaks is None or not sp.counters.get("mla.keys"):
        return None
    spent = sl.seconds(*KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run.cell.config, sp.counters, run.peaks) / spent
