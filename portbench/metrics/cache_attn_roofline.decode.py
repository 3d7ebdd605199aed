"""K12's least time over its summed device time, in the traced decode
batch: the SDAR family's attention of a block against the exact KV cache,
in every denoising step and commit.

Counted from the program's cache counters of the traced batch (its spans
joined to the same trace, ``run.span_slice``): ``cache.keys``, the keys
the passes' attention reads summed over rows; ``cache.queries``, their
query positions; ``cache.pairs``, the query-key pairs.  Per layer: 4 ·
pairs · H · Dh FLOPs (QKᵀ and PV); each kv head's K and V of a row read
once (2 · keys · KV · Dh values) and q and the output once (2 · queries · H
· Dh), in bf16.  Least time: the larger of FLOPs over the bf16 peak and
bytes over the memory's peak, of the batch's sums (every pass is bound by
bytes: 32 query rows share a key, ~32 FLOPs a byte against the card's
~295)."""

KERNELS = ("cache_attn_kernel",)
BYTES = 2   # bf16


def least_seconds(s, counters, peaks):
    H, KV, Dh = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    flops = 4.0 * counters["cache.pairs"] * H * Dh
    moved = BYTES * (2.0 * counters["cache.keys"] * KV * Dh
                     + 2.0 * counters["cache.queries"] * H * Dh)
    return s["num_layers"] * max(flops / peaks["bf16"], moved / peaks["bytes"])


def read(run):
    sl, sp = run.slice, getattr(run, "span_slice", None)
    if sl is None or sp is None or run.peaks is None or not sp.counters.get("cache.keys"):
        return None
    spent = sl.seconds(*KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run.sizes, sp.counters, run.peaks) / spent
