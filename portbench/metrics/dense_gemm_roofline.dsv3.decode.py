"""The dense products' least time over the device time of the GEMM
kernels, in the traced decode batch, for a configuration file in
DeepSeek-V3's keys (``model_type`` ``deepseek_v3``: multi-head latent
attention, a dense first ``first_k_dense_replace`` layers, then routed and
shared experts).

``dense_gemm_roofline.decode``'s count, with that layer's products, over a
pass's N real tokens (padding not counted): per layer q (D → H·(Dn + Dr)),
the latent row (D → R + Dr) and ``wo`` (H·Dv → D); the latent attention's
own products, which run outside its kernels as library products: in the
prefill (a pass whose rows are longer than a block) the up-projection of
every key (R → H·(Dn + Dv)), in a step or commit the absorbed form's two
(each head's q_nope · W_UK, Dn → R, and its output · W_UV, R → Dv, whose
weights are read once a pass); the dense FFN of the first layers (gate and
up, then down, ``intermediate_size``); in the rest the router (float32:
the program routes in float32) and the shared experts as one SwiGLU of
``n_shared_experts`` · ``moe_intermediate_size``; per pass the LM head over
the positions it asked for in each row.  Each product reads its inputs
once and writes its output once (bf16, the router's and the head's logits
float32); its least time is the larger of FLOPs over the peak of its dtype
and bytes over the memory's peak, and the least times add up.  The device
time is that of the kernels whose names hold one of ``PATTERNS`` and none
of ``EXCLUDE`` (cuBLAS's and CUTLASS's GEMM kernels; the expert and
attention kernels are the port's own)."""

PATTERNS = ("nvjet", "gemm", "gemv", "xmma", "cutlass", "splitKreduce")
EXCLUDE = ("grouped_gemm_kernel", "grouped_ffn_fused_kernel", "grouped_gemm_q_kernel",
           "flash_", "mla_")


def _product(m, k, n, peak, in_bytes, out_bytes, peaks):
    flops = 2.0 * m * k * n
    moved = in_bytes * (m * k + k * n) + out_bytes * m * n
    return max(flops / peak, moved / peaks["bytes"])


def least_seconds(conf, calls, peaks):
    D, L, H = conf["hidden_size"], conf["num_hidden_layers"], conf["num_attention_heads"]
    R, Dn, Dr, Dv = (conf["kv_lora_rank"], conf["qk_nope_head_dim"],
                     conf["qk_rope_head_dim"], conf["v_head_dim"])
    k, E = conf.get("first_k_dense_replace", 0), conf["n_routed_experts"]
    F, Fs = conf["intermediate_size"], conf["moe_intermediate_size"] * conf["n_shared_experts"]
    bl = conf["block_length"]
    bf, f32 = peaks["bf16"], peaks["f32"]
    total = 0.0
    for c in calls:
        n = sum(c.rows)
        layer = (_product(n, D, H * (Dn + Dr), bf, 2, 2, peaks)
                 + _product(n, D, R + Dr, bf, 2, 2, peaks)
                 + _product(n, H * Dv, D, bf, 2, 2, peaks))
        if max(c.rows) > bl:
            layer += _product(n, R, H * (Dn + Dv), bf, 2, 2, peaks)
        else:
            layer += H * (_product(n, Dn, R, bf, 2, 2, peaks)
                          + _product(n, R, Dv, bf, 2, 2, peaks))
        dense = _product(n, D, 2 * F, bf, 2, 2, peaks) + _product(n, F, D, bf, 2, 2, peaks)
        moe = (_product(n, D, E, f32, 4, 4, peaks)
               + _product(n, D, 2 * Fs, bf, 2, 2, peaks) + _product(n, Fs, D, bf, 2, 2, peaks))
        head = _product(len(c.rows) * c.head, D, conf["vocab_size"], bf, 2, 4, peaks)
        total += L * layer + k * dense + (L - k) * moe + head
    return total


def read(run):
    sl, conf = run.slice, run.cell.config
    if (sl is None or not run.slice_calls or run.peaks is None
            or not conf.get("kv_lora_rank") or not conf.get("n_routed_experts")):
        return None
    spent = sl.seconds(*PATTERNS, exclude=EXCLUDE)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(conf, run.slice_calls, run.peaks) / spent
