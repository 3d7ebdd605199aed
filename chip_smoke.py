#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # needs one card

Phases, in order:

1. card name and power limit (nvidia-smi), then build of every CUDA kernel
   from ``ct_diffusionmodelbench_tpu_torch/csrc`` (one nvcc per source, all
   started together).
2. kernels: each kernel at the main path's shapes against its plain PyTorch
   version on the same inputs, timed with CUDA events beside the plain
   version, one PyTorch library call where one exists, and its bound.
3. slice: full-width, full-depth ``llada-moe-7b`` (random weights from a
   seeded generator) decoding greedily through ``llada_generate`` at batch 8,
   prompt 64, gen 256, steps 128, block 32; launch counts read around that
   run; no mask id may remain; a repeated forward must give identical logits.
4. reduced depth: a 2-layer forward at full width with the kernels against
   the same forward on the kernels' plain versions.
5. int8 kernels: ``ModelRunner.random_init("llada-moe-7b", quant="int8")``
   (each weight quantized as it is built); the int8 gate/up and down
   kernels on the layer-1 routing of a full-size int8 forward, with the
   stacked [18, 64, ...] int8 experts, against their plain versions, timed
   beside them and beside ``torch._grouped_mm`` on weights dequantized to
   bf16 beforehand.
6. int8 slice: ``ModelRunner.generate_ids`` at the bf16 slice's shape and
   prompt; launch counts read around that run (the int8 pair and flash, not
   the bf16 pair); no mask id may remain; a repeated forward must give
   identical logits.
7. int8 quantization check: at 2 layers of the full width, the int8 forward
   against the bf16 forward on the dequantized weights (the same function),
   and against itself on the int8 kernels' plain versions.
8. training kernels: the flash forward with lse and the two backward kernels
   at the training shape (B 1, S 2048, H = KV = 32, Dh 128, RoPE) against
   their plain versions, timed beside them and beside SDPA's forward and
   backward; also a GQA case (H 16, KV 4) and a padded-mask case.
9. training slice: 8-layer, full-width ``llada-8b`` (random weights) trained
   5 optimizer steps by ``Trainer`` (seq 2048, micro-batch 1, grad-accum 4,
   remat, CE chunk 512, AdamW) on seeded token rows; s/step over steps 2-5,
   tokens/s, train MFU, peak memory, save seconds; launch counts per step.
10. training gradients: a 2-layer full-width loss and every parameter's
   gradient with the kernels against the same on their plain versions.

The bf16 MoE weights are freed before phase 5, the int8 ones before
phase 8.  Prints the ``{"kernels": [...]}`` line and, last, the
``{"ok": true, ...}`` line.  Exits non-zero, printing no result, without a
card or if any phase fails.
"""

from __future__ import annotations

import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time

import torch

# Peak rates of an H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Main path: llada-moe-7b, batch 8, prompt 64, gen 256, steps 128, block 32.
BATCH, PROMPT, GEN, STEPS, BLOCK = 8, 64, 256, 128, 32
SEQ = PROMPT + GEN

# Tolerances, kernel against plain version on identical bf16 inputs.  Both
# accumulate products in f32 and round once to bf16; they differ only in the
# order of the f32 sums, which moves a result across a bf16 rounding boundary
# at most once: one bf16 ulp, 2**-7 relative, plus an absolute floor for
# results near zero.  Flash also casts P to bf16 against a running max that
# the kernel's 64-key tiles update in steps and the plain version takes over
# all keys at once, so P's rounding differs: two ulps.
GROUPED_TOL = dict(rtol=2 ** -7, atol=1e-3)
FLASH_TOL = dict(rtol=2 ** -6, atol=4e-3)
# Two-layer forward: each layer rounds its activations to bf16 a dozen times,
# so one-ulp differences inside the kernels move the f32 logits by about one
# bf16 ulp (2**-7) of their largest magnitude; the tolerance is four such
# ulps.  A one-ulp difference at a router input also decides near-ties of the
# 8th and 9th expert (a few tokens in a hundred per layer with random
# weights) and then moves that token's logits by far more than any kernel
# error.  So the plain run takes the kernel run's expert choice in every
# layer, and the tolerance holds at every position.
LOGITS_RTOL_OF_MAX = 2 ** -5
# The int8 forward against the bf16 forward on dequantized weights holds to
# the same tolerance: dequantizing rounds each q·s to bf16 (one bf16 ulp of
# the weight), which moves the products no more than a kernel's ulp does.

SERVING_KERNELS = ("grouped_gateup", "grouped_down", "flash_attention_fwd")
INT8_SERVING_KERNELS = ("grouped_gateup_q", "grouped_down_q", "flash_attention_fwd")
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")

# Training shape: llada-8b at full width, 8 of its 32 layers; seq 2048,
# micro-batch 1, grad-accum 4, prompt 64; 5 optimizer steps of 20 rows.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_PROMPT, TRAIN_STEPS = 8, 2048, 4, 64, 5
# Kernel against plain version at the training shape.  The forward output
# keeps FLASH_TOL.  lse is f32 from scores that can differ by one bf16 ulp
# of a rotated q/k element (the kernel may fuse the rotation's multiply-add
# where PyTorch rounds twice): a few 1e-4 at most, checked at 2e-3.  The
# backward's f32 outputs sum products of bf16-rounded P and dS whose f32
# sources differ in their last bits; a flipped rounding moves one term by
# one bf16 ulp (2**-8 relative), so each element stays within 2**-6 of
# itself plus 2**-8 of the tensor's largest magnitude.
LSE_ATOL = 2e-3
BWD_RTOL, BWD_ATOL_OF_MAX = 2 ** -6, 2 ** -8
# Two-layer gradients, kernels against plain: one-ulp differences inside the
# attention backward (and the bf16 attention output they feed) reach every
# gradient through a dozen bf16 roundings per layer; expected relative L2
# error per leaf about 2**-8, limit four bf16 ulps (2**-5).  The loss is one
# f32 sum over the masked tokens: 2**-7 relative.
GRAD_REL_L2 = 2 ** -5
LOSS_RTOL = 2 ** -7


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    print(f"  {name}: max_abs_err {max_err:.3e} (rtol {rtol:.3g}, atol {atol:.3g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_err


def kernel_phase(cfg, params, dev):
    """Each kernel at the main path's shapes against its plain version."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope, rope_angles
    from ct_diffusionmodelbench_tpu_torch.models.moe import router_probs
    from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    D, E, K, Fm = (cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok,
                   cfg.moe_intermediate_size)
    blocks = params["blocks"]
    li = 1
    wg, wu, wd = blocks["we_gate"], blocks["we_up"], blocks["we_down"]
    n = BATCH * SEQ
    x = torch.randn((n, D), generator=gen, device=dev, dtype=torch.bfloat16)
    topk_probs, topk_idx, _ = router_probs(x, blocks["router"][li], K,
                                           cfg.norm_topk_prob)
    dest, tile_expert, sizes, m_pad = gg.counting_layout(topk_idx, E, gg.TILE_M)
    xs = gg.gather_rows(x, dest, K, m_pad)
    m = n * K
    used = int((sizes > 0).sum())
    print(f"  routing: N {n}, M {m}, m_pad {m_pad}, tiles {m_pad // gg.TILE_M}, "
          f"experts used {used}/{E}, largest group {int(sizes.max())}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []
    pend = torch.cumsum(gg._round_up(sizes, gg.TILE_M), 0, dtype=torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)

    # gate/up
    h_k = gg.grouped_gateup(xs, wg, wu, tile_expert, gg.TILE_M, li)
    h_p = gg.grouped_gateup_plain(xs, wg, wu, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = compare("grouped_gateup", h_k, h_p, **GROUPED_TOL)
    h_out = torch.empty_like(h_k)
    k_ms = time_ms(lambda: gg.GATEUP_KERNEL(
        xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), h_out.data_ptr(),
        tile_expert.data_ptr(), m_pad, D, Fm, E, li, gg.TILE_M, stream), 20)
    p_ms = time_ms(lambda: gg.grouped_gateup_plain(
        xs, wg, wu, tile_expert, gg.TILE_M, li), 3, warmup=1)
    lib_ms = None
    if grouped_mm is not None:
        w_gu = torch.cat([wg[li], wu[li]], dim=-1)
        lib_ms = time_ms(lambda: grouped_mm(xs, w_gu, offs=pend), 20)
        del w_gu
    # Work and bytes of the m routed rows only: the m_pad - m padding rows
    # copy token 0 and carry combine weight 0.
    bf16 = xs.element_size()
    b_ms, b_by = bound_ms(4.0 * m * D * Fm,
                          m * (D + Fm) * bf16 + nbytes(tile_expert)
                          + used * 2 * D * Fm * bf16)
    results.append(dict(
        name="grouped_gateup", route="cuda",
        source="ct_diffusionmodelbench_tpu_torch/csrc/grouped_gemm.cu",
        replaces="ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py:901",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms))

    # down projection, on the plain gate/up output for both
    o_k = gg.grouped_down(h_p, wd, tile_expert, gg.TILE_M, li)
    o_p = gg.grouped_down_plain(h_p, wd, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = compare("grouped_down", o_k, o_p, **GROUPED_TOL)
    o_out = torch.empty_like(o_k)
    k_ms = time_ms(lambda: gg.DOWN_KERNEL(
        h_p.data_ptr(), wd.data_ptr(), o_out.data_ptr(), tile_expert.data_ptr(),
        m_pad, Fm, D, E, li, gg.TILE_M, stream), 20)
    p_ms = time_ms(lambda: gg.grouped_down_plain(
        h_p, wd, tile_expert, gg.TILE_M, li), 3, warmup=1)
    lib_ms = None
    if grouped_mm is not None:
        wd_l = wd[li]
        lib_ms = time_ms(lambda: grouped_mm(h_p, wd_l, offs=pend), 20)
    b_ms, b_by = bound_ms(2.0 * m * Fm * D,
                          m * (Fm + D) * bf16 + nbytes(tile_expert)
                          + used * Fm * D * bf16)
    results.append(dict(
        name="grouped_down", route="cuda",
        source="ct_diffusionmodelbench_tpu_torch/csrc/grouped_gemm.cu",
        replaces="ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py:969",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms))
    del h_k, h_p, o_k, o_p, h_out, o_out, xs

    # flash attention: B 8, S 320, H 16, KV 4, Dh 128, RoPE, left padding
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn((BATCH, SEQ, H, Dh), generator=gen, device=dev, dtype=torch.bfloat16)
    k = torch.randn((BATCH, SEQ, KV, Dh), generator=gen, device=dev, dtype=torch.bfloat16)
    v = torch.randn((BATCH, SEQ, KV, Dh), generator=gen, device=dev, dtype=torch.bfloat16)
    mask = torch.ones((BATCH, SEQ), dtype=torch.int32, device=dev)
    for b in range(BATCH):
        mask[b, :4 * b] = 0  # left padding of 0, 4, ..., 28 tokens
    cos, sin = rope_angles(token_positions(mask, BATCH, SEQ, dev), Dh, cfg.rope_theta)
    a_k = fa.flash_attention(q, k, v, mask=mask, rope=(cos, sin))
    a_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=(cos, sin))
    torch.cuda.synchronize()
    err = compare("flash_attention_fwd", a_k, a_p, **FLASH_TOL)
    bias = fa.mask_bias(mask, BATCH, SEQ, dev)
    a_out = torch.empty_like(a_k)
    kv_len = fa.kv_tile_len(SEQ)
    k_ms = time_ms(lambda: fa.FLASH_KERNEL(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), a_out.data_ptr(), None, BATCH, SEQ, kv_len, H, KV, Dh,
        Dh ** -0.5, stream), 50)
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, mask=mask, rope=(cos, sin)), 10)
    qr = apply_rope(q, cos, sin).transpose(1, 2)
    kr = apply_rope(k, cos, sin).transpose(1, 2)
    vt = v.transpose(1, 2)
    keep = mask.bool()[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(qr, kr, vt, attn_mask=keep, enable_gqa=True), 50)
    b_ms, b_by = bound_ms(4.0 * BATCH * H * SEQ * SEQ * Dh,
                          nbytes(q, k, v, a_k, bias, cos, sin))
    results.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="ct_diffusionmodelbench_tpu_torch/csrc/flash_attention.cu",
        replaces="ct_diffusionmodelbench_tpu/ops/flash_attention.py:312",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms))
    for r in results:
        r["kernel_ms"] = r["ms"]
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    return results


def slice_phase(cfg, params, dev):
    """Full-size greedy decode through the port's entry points."""
    from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    prompt = torch.randint(10, 100000, (BATCH, PROMPT), generator=gen, device=dev)
    fwd = make_forward_fn(cfg)
    kw = dict(steps=STEPS, gen_length=GEN, block_length=BLOCK,
              mask_id=cfg.mask_token_id)
    llada_generate(fwd, params, prompt, **kw)  # warm-up (cuBLAS plans, libs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = llada_generate(fwd, params, prompt, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"  generate: {secs:.4f} s, {BATCH * GEN / secs:.2f} tok/s "
          f"(B {BATCH}, prompt {PROMPT}, gen {GEN}, steps {STEPS}, block {BLOCK})",
          flush=True)
    print(f"  peak memory: {peak / 2**30:.3f} GiB", flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    want = cfg.num_layers * STEPS
    bad = {n: c for n, c in launches.items()
           if c != (want if n in SERVING_KERNELS else 0)}
    if bad:
        raise AssertionError(f"expected {want} launches of each serving kernel "
                             f"and none of the backward kernels, got {bad}")
    left = int((out[:, PROMPT:] == cfg.mask_token_id).sum())
    print(f"  mask ids left: {left}", flush=True)
    if left:
        raise AssertionError(f"{left} mask ids remain after decoding")
    l1, _ = fwd(params, out, logit_start=PROMPT, logit_length=BLOCK)
    l2, _ = fwd(params, out, logit_start=PROMPT, logit_length=BLOCK)
    same = torch.equal(l1, l2)
    print(f"  repeated forward bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("two forwards on the same input differ")
    if not torch.isfinite(l1).all():
        raise AssertionError("non-finite logits")
    return dict(seconds=secs, tokens_per_s=BATCH * GEN / secs,
                peak_gib=peak / 2**30, launches=launches, prompt=prompt, out=out)


def pinned_compare(label, cfg2, ids, dev, params_a, params_b, seams_b):
    """Logits of a forward of ``params_a`` (``cfg2``, through the kernels)
    against a forward of ``params_b`` with ``seams_b`` ((module, name, fn)
    swapped in for that run), the second run given the first one's expert
    choice in every layer.  Fails past ``LOGITS_RTOL_OF_MAX``."""
    from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.models import moe

    router_probs = moe.router_probs
    chosen, flipped = [], []  # per layer: run a's top-k; tokens whose own
                              # run-b choice differs from it

    def recording_router(x, w, top_k, norm_topk):
        out = router_probs(x, w, top_k, norm_topk)
        chosen.append(out[1])
        return out

    def pinned_router(x, w, top_k, norm_topk):
        _, own, probs = router_probs(x, w, top_k, norm_topk)
        idx = chosen[len(flipped)]
        flipped.append((own.sort(dim=-1).values
                        != idx.sort(dim=-1).values).any(dim=-1))
        topk_probs = probs.gather(-1, idx)
        if norm_topk:
            topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True)
        return topk_probs, idx, probs

    seams = [(moe, "router_probs", pinned_router)] + list(seams_b)
    saved = [getattr(mod, name) for mod, name, _ in seams]
    kw = dict(logit_start=PROMPT, logit_length=BLOCK)
    try:
        moe.router_probs = recording_router
        la, _ = make_forward_fn(cfg2)(params_a, ids, **kw)
        for mod, name, fn in seams:
            setattr(mod, name, fn)
        lb, _ = make_forward_fn(cfg2)(params_b, ids, **kw)
    finally:
        for (mod, name, _), fn in zip(seams, saved):
            setattr(mod, name, fn)
    print(f"  {label}: tokens whose own expert choice differs (pinned to the "
          "first run's choice): "
          + ", ".join(f"layer {i} {int(f.sum())}/{f.numel()}"
                      for i, f in enumerate(flipped)), flush=True)
    if not torch.isfinite(la).all():
        raise AssertionError(f"{label}: non-finite logits")
    err_p = (la - lb).abs().amax(dim=-1).flatten()      # per position
    scale = float(lb.abs().max())
    tol = LOGITS_RTOL_OF_MAX * scale
    top2 = lb.topk(2, dim=-1).values.flatten(0, 1)
    gap = top2[:, 0] - top2[:, 1]
    differ = (la.argmax(-1) != lb.argmax(-1)).flatten()
    # The argmax form of the tolerance: it may move only where the second
    # run's top-2 logits lie within 2 * tol of each other.
    clear_moves = int((differ & (gap > 2 * tol)).sum())
    q = torch.quantile(err_p.float(), torch.tensor([0.5, 0.9, 0.99], device=dev))
    print(f"  {label}: max |logit| {scale:.4e}, tolerance {tol:.4e}: "
          f"per-position max_abs_err median {float(q[0]):.4e}, p90 {float(q[1]):.4e}, "
          f"p99 {float(q[2]):.4e}, max {float(err_p.max()):.4e}; "
          f"{int((err_p > tol).sum())}/{err_p.numel()} positions past tolerance; "
          f"argmax differs at {int(differ.sum())} ({int((gap <= 2 * tol).sum())} "
          f"positions have a top-2 gap within 2 * tolerance; {clear_moves} "
          f"moved outside them)", flush=True)
    if float(err_p.max()) > tol or clear_moves:
        raise AssertionError(f"{label}: the two forwards disagree")
    return float(err_p.max())


def depth_phase(cfg, params, ids, dev):
    """2-layer full-width forward: kernels against their plain versions, the
    plain run on the kernel run's expert choice."""
    from ct_diffusionmodelbench_tpu_torch.ops import attention
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    # The plain run swaps each kernel's wrapper for its plain version at the
    # one name the model calls it by.
    seams = [(attention, "flash_attention", fa.flash_attention_plain),
             (gg, "grouped_gateup", gg.grouped_gateup_plain),
             (gg, "grouped_down", gg.grouped_down_plain)]
    cfg2 = cfg.replace(num_layers=2)  # the first two layers of the full stacks
    return pinned_compare("2-layer logits, kernels vs plain", cfg2, ids, dev,
                          params, params, seams)


def tree_bytes(tree) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def int8_kernel_phase(runner, dev):
    """The int8 pair at the main path's shapes, on the layer-1 routing of a
    full-size int8 forward, against their plain versions."""
    from ct_diffusionmodelbench_tpu_torch.models import moe
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
    from ct_diffusionmodelbench_tpu_torch.ops.quant import dequantize_tensor

    cfg, params = runner.cfg, runner.params
    D, E, K, Fm = (cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok,
                   cfg.moe_intermediate_size)
    li = 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    ids = torch.randint(10, 100000, (BATCH, SEQ), generator=gen, device=dev)
    seen = []
    router_probs = moe.router_probs

    def recording_router(x, w, top_k, norm_topk):
        out = router_probs(x, w, top_k, norm_topk)
        seen.append((x, out[1]))
        return out

    try:
        moe.router_probs = recording_router
        runner.forward_fn(params, ids, logit_start=PROMPT, logit_length=BLOCK)
    finally:
        moe.router_probs = router_probs
    x, topk_idx = seen[li]
    del seen
    blocks = params["blocks"]
    qg, qu, qd = blocks["we_gate"], blocks["we_up"], blocks["we_down"]
    dest, tile_expert, sizes, m_pad = gg.counting_layout(topk_idx, E, gg.TILE_M)
    xs = gg.gather_rows(x, dest, K, m_pad)
    m = x.shape[0] * K
    used = int((sizes > 0).sum())
    print(f"  routing of layer {li} in a full-size int8 forward: N {x.shape[0]}, "
          f"M {m}, m_pad {m_pad}, experts used {used}/{E}, largest group "
          f"{int(sizes.max())}, smallest {int(sizes.min())}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pend = torch.cumsum(gg._round_up(sizes, gg.TILE_M), 0, dtype=torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    bf16 = xs.element_size()
    src = "ct_diffusionmodelbench_tpu_torch/csrc/grouped_gemm_q.cu"
    ref = "ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py"
    results = []

    def layer_deq(w):
        return dequantize_tensor({"q": w["q"][li], "s": w["s"][li]}, torch.bfloat16)

    # gate/up
    h_k = gg.grouped_gateup_q(xs, qg, qu, tile_expert, gg.TILE_M, li)
    h_p = gg.grouped_gateup_q_plain(xs, qg, qu, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = compare("grouped_gateup_q", h_k, h_p, **GROUPED_TOL)
    h_out = torch.empty_like(h_k)
    k_ms = time_ms(lambda: gg.GATEUP_Q_KERNEL(
        xs.data_ptr(), qg["q"].data_ptr(), qu["q"].data_ptr(), qg["s"].data_ptr(),
        qu["s"].data_ptr(), h_out.data_ptr(), tile_expert.data_ptr(), m_pad, D, Fm,
        E, li, gg.TILE_M, stream), 20)
    p_ms = time_ms(lambda: gg.grouped_gateup_q_plain(
        xs, qg, qu, tile_expert, gg.TILE_M, li), 3, warmup=1)
    lib_ms = None
    if grouped_mm is not None:
        w_gu = torch.cat([layer_deq(qg), layer_deq(qu)], dim=-1)
        lib_ms = time_ms(lambda: grouped_mm(xs, w_gu, offs=pend), 20)
        del w_gu
    # The m routed rows' bytes (padding rows copy token 0, weight 0), each
    # used expert's two int8 matrices and their f32 scales once.
    b_ms, b_by = bound_ms(4.0 * m * D * Fm,
                          m * (D + Fm) * bf16 + nbytes(tile_expert)
                          + used * 2 * (D * Fm + 4 * Fm))
    results.append(dict(
        name="grouped_gateup_q", route="cuda", source=src, replaces=f"{ref}:1172",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms))

    # down, on the plain gate/up output for both
    o_k = gg.grouped_down_q(h_p, qd, tile_expert, gg.TILE_M, li)
    o_p = gg.grouped_down_q_plain(h_p, qd, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = compare("grouped_down_q", o_k, o_p, **GROUPED_TOL)
    o_out = torch.empty_like(o_k)
    k_ms = time_ms(lambda: gg.DOWN_Q_KERNEL(
        h_p.data_ptr(), qd["q"].data_ptr(), qd["s"].data_ptr(), o_out.data_ptr(),
        tile_expert.data_ptr(), m_pad, Fm, D, E, li, gg.TILE_M, stream), 20)
    p_ms = time_ms(lambda: gg.grouped_down_q_plain(
        h_p, qd, tile_expert, gg.TILE_M, li), 3, warmup=1)
    lib_ms = None
    if grouped_mm is not None:
        wd_l = layer_deq(qd)
        lib_ms = time_ms(lambda: grouped_mm(h_p, wd_l, offs=pend), 20)
        del wd_l
    b_ms, b_by = bound_ms(2.0 * m * Fm * D,
                          m * (Fm + D) * bf16 + nbytes(tile_expert)
                          + used * (Fm * D + 4 * D))
    results.append(dict(
        name="grouped_down_q", route="cuda", source=src, replaces=f"{ref}:1242",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms))
    for r in results:
        r["kernel_ms"] = r["ms"]
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library (torch._grouped_mm on weights dequantized to bf16 "
              f"beforehand, not timed) {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return results


def int8_slice_phase(runner, dev):
    """Full-size int8 greedy decode through ``ModelRunner.generate_ids``."""
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts

    cfg = runner.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)   # the bf16 slice's prompt
    prompt = torch.randint(10, 100000, (BATCH, PROMPT), generator=gen,
                           device=dev).cpu().numpy()
    kw = dict(steps=STEPS, gen_length=GEN, block_length=BLOCK)
    runner.generate_ids(prompt, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = runner.generate_ids(prompt, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"  generate_ids: {secs:.4f} s, {BATCH * GEN / secs:.2f} tok/s "
          f"(B {BATCH}, prompt {PROMPT}, gen {GEN}, steps {STEPS}, block {BLOCK})",
          flush=True)
    print(f"  peak memory: {peak / 2**30:.3f} GiB", flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    want = cfg.num_layers * STEPS
    bad = {n: c for n, c in launches.items()
           if c != (want if n in INT8_SERVING_KERNELS else 0)}
    if bad:
        raise AssertionError(f"expected {want} launches of each int8 serving "
                             f"kernel and none of the others, got {bad}")
    left = int((out[:, PROMPT:] == runner.mask_id).sum())
    print(f"  mask ids left: {left}", flush=True)
    if left:
        raise AssertionError(f"{left} mask ids remain after decoding")
    ids = torch.from_numpy(out).to(dev)
    l1, _ = runner.forward_fn(runner.params, ids, logit_start=PROMPT, logit_length=BLOCK)
    l2, _ = runner.forward_fn(runner.params, ids, logit_start=PROMPT, logit_length=BLOCK)
    same = torch.equal(l1, l2)
    print(f"  repeated forward bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("two forwards on the same input differ")
    if not torch.isfinite(l1).all():
        raise AssertionError("non-finite logits")
    return dict(seconds=secs, tokens_per_s=BATCH * GEN / secs,
                peak_gib=peak / 2**30, launches=launches, out=ids)


def quant_phase(cfg, qparams, ids, dev):
    """2 layers at full width: the int8 forward against the bf16 forward on
    the dequantized weights (the same function), and the int8 kernels
    against their plain versions; expert choice shared in both."""
    from ct_diffusionmodelbench_tpu_torch.ops import attention
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
    from ct_diffusionmodelbench_tpu_torch.ops.quant import dequantize_tensor, is_quantized

    def first2(v):
        return {"q": v["q"][:2], "s": v["s"][:2]} if is_quantized(v) else v[:2]

    dt = qparams["embed"].dtype   # the model dtype: bf16 on the card

    def deq(v):
        return dequantize_tensor(v, dt) if is_quantized(v) else v

    cfg2 = cfg.replace(num_layers=2)
    q2 = dict(qparams, blocks={k: first2(v) for k, v in qparams["blocks"].items()})
    d2 = {k: deq(v) for k, v in q2.items() if k != "blocks"}
    d2["blocks"] = {k: deq(v) for k, v in q2["blocks"].items()}
    err_deq = pinned_compare("2-layer logits, int8 vs bf16 on the dequantized "
                             "weights", cfg2, ids, dev, q2, d2, [])
    del d2
    seams = [(attention, "flash_attention", fa.flash_attention_plain),
             (gg, "grouped_gateup_q", gg.grouped_gateup_q_plain),
             (gg, "grouped_down_q", gg.grouped_down_q_plain)]
    err_plain = pinned_compare("2-layer int8 logits, kernels vs plain", cfg2, ids,
                               dev, q2, q2, seams)
    return err_deq, err_plain


def attention_case(dev, b, s, h, kv, dh, seed, pad=0):
    """Seeded bf16 q, k, v, dO; a mask with ``pad`` left-padding keys in the
    last row (or none); RoPE tables at llada-8b's theta."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import rope_angles
    from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, do = (torch.randn((b, s, h, dh), generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, s, kv, dh), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    mask = None
    if pad:
        mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        mask[-1, :pad] = 0
    rope = rope_angles(token_positions(mask, b, s, dev), dh, 500000.0)
    return q, k, v, do, mask, rope


def compare_bwd(name, got, want):
    return max(compare(f"{name} {label}", g, w, BWD_RTOL,
                       BWD_ATOL_OF_MAX * float(w.abs().max()))
               for label, g, w in zip(("dq", "dk", "dv"), got, want))


def train_kernel_phase(dev):
    """The flash forward with lse and the two backward kernels against their
    plain versions; timed at the training shape."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab

    S, Dh = TRAIN_SEQ, 128
    cases = [("GQA H 16, KV 4", 1, 16, 4, 0), ("padded mask", 2, 32, 32, 300),
             ("training shape", 1, 32, 32, 0)]
    for label, b, h, kv, pad in cases:
        q, k, v, do, mask, rope = attention_case(dev, b, S, h, kv, Dh, 10 + b + h, pad)
        out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope, with_lse=True)
        out_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=rope,
                                                with_lse=True)
        torch.cuda.synchronize()
        err_fwd = max(compare(f"{label} fwd out", out, out_p, **FLASH_TOL),
                      compare(f"{label} fwd lse", lse, lse_p, 0.0, LSE_ATOL))
        qr, kr = apply_rope(q, *rope), apply_rope(k, *rope)
        bias = fa.mask_bias(mask, b, S, dev)
        got = fab.flash_attention_bwd(qr, kr, v, bias, out, do, lse)
        want = fab.flash_attention_bwd_plain(qr, kr, v, bias, out, do, lse)
        torch.cuda.synchronize()
        err_bwd = compare_bwd(label, got, want)
        del out_p, lse_p, got, want

    # Times at the training shape (the last case): B 1, S 2048, H = KV = 32.
    B, H, KV = 1, 32, 32
    cos, sin = rope
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale = Dh ** -0.5
    o_buf, l_buf = torch.empty_like(out), torch.empty_like(lse)
    fwd_ms = time_ms(lambda: fa.FLASH_KERNEL(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), o_buf.data_ptr(), l_buf.data_ptr(), B, S,
        fa.kv_tile_len(S), H, KV, Dh, scale, stream), 20)
    fwd_plain_ms = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, rope=rope, with_lse=True), 3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2)
    fwd_lib_ms = time_ms(lambda: sdpa(qt, kt, vt), 20)
    fwd_bound = bound_ms(4.0 * B * H * S * S * Dh,
                         nbytes(q, k, v, out, lse, bias, cos, sin))

    dsum = fab.row_dot(out, do)
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=dev)
                  for t in (q, k, v))
    common = (qr.data_ptr(), kr.data_ptr(), v.data_ptr(), bias.data_ptr(),
              do.data_ptr(), lse.data_ptr(), dsum.data_ptr())
    dq_ms = time_ms(lambda: fab.DQ_KERNEL(
        *common, dq.data_ptr(), B, S, H, KV, Dh, scale, stream), 20)
    dkv_ms = time_ms(lambda: fab.DKV_KERNEL(
        *common, dk.data_ptr(), dv.data_ptr(), B, S, H, KV, Dh, scale, stream), 20)
    bwd_plain_ms = time_ms(lambda: fab.flash_attention_bwd_plain(
        qr, kr, v, bias, out, do, lse), 3, warmup=1)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    s_out = sdpa(qg, kg, vg)
    dot = do.transpose(1, 2)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        s_out, (qg, kg, vg), dot, retain_graph=True), 20)
    ins = nbytes(qr, kr, v, do, lse, dsum, bias)
    dq_bound = bound_ms(6.0 * B * H * S * S * Dh, ins + nbytes(dq))
    dkv_bound = bound_ms(8.0 * B * H * S * S * Dh, ins + nbytes(dk, dv))
    print(f"  training shape B {B}, S {S}, H {H}, KV {KV}, Dh {Dh}: "
          f"fwd+lse kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, SDPA fwd "
          f"{fwd_lib_ms:.4f} ms, bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}); "
          f"dq kernel {dq_ms:.4f} ms, bound {dq_bound[0]:.4f} ms ({dq_bound[1]}); "
          f"dkv kernel {dkv_ms:.4f} ms, bound {dkv_bound[0]:.4f} ms ({dkv_bound[1]}); "
          f"dq + dkv {dq_ms + dkv_ms:.4f} ms against SDPA backward "
          f"{sdpa_bwd_ms:.4f} ms; plain backward (dq, dk, dv in one call) "
          f"{bwd_plain_ms:.4f} ms", flush=True)
    src = "ct_diffusionmodelbench_tpu_torch/csrc/flash_attention_bwd.cu"
    ref = "ct_diffusionmodelbench_tpu/ops/flash_attention_bwd.py"
    results = [
        dict(name="flash_attention_bwd_dq", route="cuda", source=src,
             replaces=f"{ref}:93", max_abs_err=err_bwd, ms=dq_ms, kernel_ms=dq_ms,
             plain_ms=bwd_plain_ms, bound_ms=dq_bound[0], bound_by=dq_bound[1],
             library_ms=None, sdpa_backward_ms=sdpa_bwd_ms),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=src,
             replaces=f"{ref}:93", max_abs_err=err_bwd, ms=dkv_ms, kernel_ms=dkv_ms,
             plain_ms=bwd_plain_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
             library_ms=None, sdpa_backward_ms=sdpa_bwd_ms),
    ]
    fwd_train = dict(shape=f"B {B}, S {S}, H {H}, KV {KV}, Dh {Dh}, RoPE, lse",
                     max_abs_err=err_fwd, ms=fwd_ms, plain_ms=fwd_plain_ms,
                     bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                     library_ms=fwd_lib_ms)
    return results, fwd_train


def train_slice_phase(dev):
    """8-layer full-width llada-8b trained 5 steps through ``Trainer``."""
    import numpy as np

    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config("llada-8b").replace(num_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    print(f"  init {TRAIN_LAYERS}-layer llada-8b: {n_params / 1e9:.3f} G params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(3)
    rows = [{"input_ids": r.tolist(), "prompt_lengths": TRAIN_PROMPT}
            for r in rng.integers(10, 100000, (TRAIN_STEPS * TRAIN_ACCUM, TRAIN_SEQ))]
    out_dir = tempfile.mkdtemp(prefix="ctdb-train-")
    try:
        tcfg = TrainConfig(output_dir=out_dir, num_epochs=1, batch_size=1,
                           grad_accum=TRAIN_ACCUM, max_length=TRAIN_SEQ, remat=True,
                           ce_chunk=512, variable_length=False, logging_steps=1,
                           seed=0)
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, params, tcfg, rows)
        reset_launch_counts()
        trainer.train()
        launches = {name: k.launches for name, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    tokens = TRAIN_ACCUM * TRAIN_SEQ
    secs = sum(trainer.step_times[1:]) / (len(trainer.step_times) - 1)
    mfu = 6.0 * n_params * tokens / secs / PEAK_BF16_FLOPS
    logs = [e for e in trainer.training_logs if "grad_norm" in e]
    print(f"  steps: {len(trainer.step_times)}, s/step (steps 2-{TRAIN_STEPS}) "
          f"{secs:.4f}, each {[round(t, 4) for t in trainer.step_times]}; "
          f"{tokens / secs:.2f} tokens/s; train MFU {mfu:.4f} (6·P·tokens / s / "
          f"989 TFLOP/s, P {n_params}); peak memory {peak / 2**30:.3f} GiB; save "
          f"{trainer.save_times[-1]:.2f} s", flush=True)
    print("  loss / grad_norm per step: " + ", ".join(
        f"{e['loss']:.5f} / {e['grad_norm']:.5f}" for e in logs), flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    if len(logs) != TRAIN_STEPS or not all(
            np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"]) and e["grad_norm"] > 0
            for e in logs):
        raise AssertionError("non-finite loss or grad_norm, or a zero gradient")
    per_step = TRAIN_LAYERS * TRAIN_ACCUM
    want = {n: 0 for n in KERNELS}
    want.update({"flash_attention_fwd": 2 * per_step * TRAIN_STEPS,
                 "flash_attention_bwd_dq": per_step * TRAIN_STEPS,
                 "flash_attention_bwd_dkv": per_step * TRAIN_STEPS})
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    params = trainer.params
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(cfg=cfg, params=params, launches=launches, seconds_per_step=secs,
                tokens_per_s=tokens / secs, mfu=mfu, peak_gib=peak / 2**30)


def train_depth_phase(cfg, params, dev):
    """2-layer full-width loss and gradients: kernels against plain."""
    from functools import partial

    from ct_diffusionmodelbench_tpu_torch.models.transformer import forward, lm_head_logits
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts
    from ct_diffusionmodelbench_tpu_torch.train.diffusion_loss import diffusion_sft_loss
    from ct_diffusionmodelbench_tpu_torch.train.optim import flatten_params, unflatten_params

    cfg2 = cfg.replace(num_layers=2)
    p2 = dict(params, blocks={k: v[:2] for k, v in params["blocks"].items()})
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    ids = torch.randint(10, 100000, (1, TRAIN_SEQ), generator=gen, device=dev)
    plens = torch.full((1,), TRAIN_PROMPT, device=dev)
    noise = (torch.rand((1,), generator=gen, device=dev),
             torch.rand((1, TRAIN_SEQ), generator=gen, device=dev))

    def fwd(p, x, m=None, *, return_hidden=False):
        return forward(cfg2, p, x, attn_mask=m, return_hidden=return_hidden, remat=True)

    def loss_and_grads():
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in flatten_params(p2).items()}
        with torch.enable_grad():
            loss, _ = diffusion_sft_loss(
                fwd, unflatten_params(leaves), ids, plens, cfg2.mask_token_id,
                noise, aux_coef=0.0, head_fn=lm_head_logits, ce_chunk=512)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), dict(zip(leaves, grads))

    reset_launch_counts()
    loss_k, grads_k = loss_and_grads()
    launches = {n: KERNELS[n].launches for n in ("flash_attention_fwd",) + BWD_KERNELS}
    # The plain run swaps the forward and backward at the names the autograd
    # wrapper calls them by.
    seams = [(fa, "flash_attention_fwd"), (fab, "flash_attention_bwd")]
    saved = [getattr(mod, name) for mod, name in seams]
    plain = [partial(fa.flash_attention_plain, with_lse=True),
             fab.flash_attention_bwd_plain]
    try:
        for (mod, name), fn in zip(seams, plain):
            setattr(mod, name, fn)
        loss_p, grads_p = loss_and_grads()
    finally:
        for (mod, name), fn in zip(seams, saved):
            setattr(mod, name, fn)
    print(f"  launches with kernels: {json.dumps(launches)}", flush=True)
    print(f"  loss: kernels {loss_k:.6f}, plain {loss_p:.6f}", flush=True)
    worst, zero = 0.0, []
    for name, gk in grads_k.items():
        gk, gp = gk.float(), grads_p[name].float()
        nk, np_ = float(gk.norm()), float(gp.norm())
        rel = float((gk - gp).norm()) / max(np_, 1e-30)
        cos = float((gk * gp).sum()) / max(nk * np_, 1e-30)
        worst = max(worst, rel)
        if nk == 0.0:
            zero.append(name)
        print(f"  grad {name}: norm {nk:.4e} (plain {np_:.4e}), rel L2 err "
              f"{rel:.3e}, cosine {cos:.6f}", flush=True)
    print(f"  largest rel L2 err {worst:.3e} (limit {GRAD_REL_L2:.3e})", flush=True)
    if launches != {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 2,
                    "flash_attention_bwd_dkv": 2}:
        raise AssertionError(f"2-layer gradient run launched {launches}")
    if zero:
        raise AssertionError(f"zero gradient with the kernels: {zero}")
    if worst > GRAD_REL_L2 or abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
        raise AssertionError("2-layer gradients with kernels disagree with plain")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
    from ct_diffusionmodelbench_tpu_torch.ops import (
        flash_attention, flash_attention_bwd, grouped_gemm_cuda)
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, build_all

    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    libs = [grouped_gemm_cuda.LIBRARY, grouped_gemm_cuda.LIBRARY_Q,
            flash_attention.LIBRARY, flash_attention_bwd.LIBRARY]
    build_s = build_all(libs)
    print(f"kernel build: {build_s:.2f} s", flush=True)
    for lib in libs:
        for line in lib.path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib.source.name}: {line.strip()}", flush=True)

    cfg = get_config("llada-moe-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    print(f"init llada-moe-7b: {n_params / 1e9:.3f} G params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    print("kernels:", flush=True)
    results = kernel_phase(cfg, params, dev)
    print("slice:", flush=True)
    sl = slice_phase(cfg, params, dev)
    print("reduced depth:", flush=True)
    depth_phase(cfg, params, sl["out"], dev)
    for r in results:
        r["launches"] = sl["launches"][r["name"]]
    del params, sl
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    runner = ModelRunner.random_init("llada-moe-7b", seed=0, quant="int8")
    torch.cuda.synchronize()
    print(f"init int8 llada-moe-7b (ModelRunner.random_init, quant='int8'): "
          f"{tree_bytes(runner.params) / 1e9:.3f} GB of weights, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print("int8 kernels:", flush=True)
    q_results = int8_kernel_phase(runner, dev)
    print("int8 slice:", flush=True)
    isl = int8_slice_phase(runner, dev)
    print("int8 quantization check:", flush=True)
    quant_phase(runner.cfg, runner.params, isl["out"], dev)
    for r in q_results:
        r["launches"] = isl["launches"][r["name"]]
    results += q_results
    del runner, isl
    gc.collect()
    torch.cuda.empty_cache()

    print("training kernels:", flush=True)
    train_results, fwd_train = train_kernel_phase(dev)
    print("training slice:", flush=True)
    tr = train_slice_phase(dev)
    print("training gradients:", flush=True)
    train_depth_phase(tr["cfg"], tr["params"], dev)
    for r in train_results:
        r["launches"] = tr["launches"][r["name"]]
    fwd_train["launches"] = tr["launches"]["flash_attention_fwd"]
    next(r for r in results if r["name"] == "flash_attention_fwd")[
        "training_shape"] = fwd_train
    results += train_results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "sdpa_backward_ms", "training_shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in results]}), flush=True)
    missing = set(KERNELS) - {r["name"] for r in results}
    if missing:
        raise AssertionError(f"kernels not checked: {sorted(missing)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
