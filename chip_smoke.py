#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # needs one card

Phases, in order:

1. card name and power limit (nvidia-smi), then build of every CUDA kernel
   from ``ct_diffusionmodelbench_tpu_torch/csrc`` (one nvcc per source, all
   started together); ptxas's registers, spills and warnings per kernel, and
   whether the flash forward, dq and dk/dv kernels at head dim 128, the
   direct flash kernel's three head-dim-128 configurations, the bf16 and int8
   grouped pairs and the fused expert FFN spill.
2. kernels: each kernel at the main path's shapes against its plain PyTorch
   version on the same inputs, timed with CUDA events beside the plain
   version, one PyTorch library call where one exists, and its bound.  The
   bf16 grouped pair (K1/K4, K2/K5) runs on a random routing through layer
   1's router with the stacked [18, 64, ...] weights, with the pad-skip
   vector ``tile_valid`` the main path hands it (real rows against the plain
   versions, the rest zero) and without it; it is timed in turns (medians
   of 5), with and without ``tile_valid``, beside ``torch._grouped_mm``,
   with its achieved TFLOP/s and share of the bound, and its host
   microseconds per launch (the TMA maps are built on the host) are
   printed.  The flash kernels and their SDPA yardsticks are timed in turns
   (kernel, SDPA, kernel, SDPA, ...; medians), with their achieved TFLOP/s
   and share of the bound.
3. slice: full-width, full-depth ``llada-moe-7b`` (random weights from a
   seeded generator) decoding greedily through ``llada_generate`` at batch 8,
   prompt 64, gen 256, steps 128, block 32; launch counts read around that
   run; no mask id may remain; a repeated forward must give identical logits.
4. reduced depth: a 2-layer forward at full width with the kernels against
   the same forward on the kernels' plain versions.
5. single-prompt kernels: layer 1's routing and attention inputs from a
   full-size B = 1 forward at the chat prompt's shape; the fused expert FFN
   (K3) on the stacked [18, 64, ...] weights and the direct flash attention
   (K9, with and without lse, at llada-moe-7b's H 16 / KV 4 and at Dream's
   H 28 / KV 4) against their plain versions, timed beside them, beside one
   PyTorch call for the same function, beside their bounds and beside the
   pair (K1 + K2) and K8 at the same inputs.  K3 runs with the pad-skip
   vector ``tile_valid`` the chat path hands it (real rows against the plain
   version, the rest zero) and without it, timed in turns (medians of 5)
   with and without it beside the pair (with it) and ``torch._grouped_mm``;
   the count of tiles with a real row is printed.
6. chat slice: with ``CTDB_GROUPED_FUSED=1`` and ``CTDB_FLASH_DIRECT=1``,
   ``cli/chat.py``'s ``build_parser`` → a ``ModelRunner`` on phase 3's
   weights (those of ``--preset llada-moe-7b``) → ``run_chat`` at the chat
   defaults (gen 128, steps 128, block 32, greedy, the Lean-only system
   prompt); a warm-up, then a timed call with launch counts around it (K3
   and K9 only); no mask id may remain; then one short ``cli/chat_base.py``
   ``_respond`` (causal, 8 new tokens) on the same weights.
7. chat depth check: a 2-layer full-width forward through K3 and K9 against
   the same forward on their plain versions.
8. int8 kernels: ``ModelRunner.random_init("llada-moe-7b", quant="int8")``
   (each weight quantized as it is built); the int8 gate/up and down
   kernels on the layer-1 routing of a full-size int8 forward, with the
   stacked [18, 64, ...] int8 experts, against their plain versions, with
   the pad-skip vector ``tile_valid`` the main path hands them (real rows
   against the plain versions, the rest zero) and without it; timed beside
   the plain versions and, in turns (medians of 5), with and without
   ``tile_valid`` beside ``torch._grouped_mm`` on weights dequantized to
   bf16 beforehand, with their achieved TFLOP/s and share of the bound.
9. int8 slice: ``ModelRunner.generate_ids`` at the bf16 slice's shape and
   prompt; launch counts read around that run (the int8 pair and flash, not
   the bf16 pair); no mask id may remain; a repeated forward must give
   identical logits.
10. int8 quantization check: at 2 layers of the full width, the int8 forward
   against the bf16 forward on the dequantized weights (the same function),
   and against itself on the int8 kernels' plain versions.
11. Dream slice: full-width, full-depth ``dream-7b`` (seeded random weights,
   ``ModelRunner.random_init``) generating at B = 1, gen 128, steps 128,
   greedy, ``alg="entropy"`` under ``CTDB_FLASH_DIRECT=1``: K9 launches,
   no mask id left, a repeated forward identical, tokens/s, peak memory.
12. training kernels: the flash forward with lse and the two backward kernels
   at the training shape (B 1, S 2048, H = KV = 32, Dh 128, RoPE) against
   their plain versions, timed beside them and beside SDPA's forward and
   backward (dq, dk/dv and SDPA's backward in turns, each kernel with its
   share of the bound), and the forward beside itself without RoPE; also a
   GQA case (H 16, KV 4) and a padded-mask case.
13. training slice: 8-layer, full-width ``llada-8b`` (random weights) trained
   5 optimizer steps by ``Trainer`` (seq 2048, micro-batch 1, grad-accum 4,
   remat, CE chunk 512, AdamW) on seeded token rows; s/step over steps 2-5,
   tokens/s, train MFU, peak memory, save seconds; launch counts per step.
14. training gradients: a 2-layer full-width loss and every parameter's
   gradient with the kernels against the same on their plain versions.

The bf16 MoE weights are freed before phase 8, the int8 ones before
phase 11, Dream's before phase 12.  Prints the first designs' times of the
redesigned flash and grouped kernels (constants from PERF.md, on a line of
their own),
the ``{"kernels": [...]}`` line and, last, the
``{"ok": true, ...}`` line.  Exits 2, printing no result, without a card or
without the port's package beside it (the script run on its own); exits 1
if any phase fails.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import re
import shutil
import statistics
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

# The fused expert FFN against its plain version: both round h to bf16 from
# f32 sums taken in different orders, so now and then one h element differs
# by one bf16 ulp (2**-8 relative) and moves out[row, j] by up to
# 2**-8 * |h_i| * |Wd[i, j]| on top of out's own one-ulp rounding.  h never
# leaves the kernel; out is held to GROUPED_TOL plus that term.
H_FLIP = 2 ** -8

# Single-prompt serving (the chat CLI's defaults): B 1, gen 128, steps 128,
# block 32; the prompt is the chat template around the Lean-only system
# message and CHAT_PROMPT, left-padded to the runner's 64-token bucket.
CHAT_PROMPT = "Prove that for every natural number n, n + 0 = n."
CHAT_GEN, CHAT_STEPS = 128, 128
CHAT_BASE_TOKENS = 8
SINGLE_PROMPT_KERNELS = ("grouped_ffn_fused", "flash_attention_direct")

SERVING_KERNELS = ("grouped_gateup", "grouped_down", "flash_attention_fwd")
INT8_SERVING_KERNELS = ("grouped_gateup_q", "grouped_down_q", "flash_attention_fwd")
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")

# Training shape: llada-8b at full width, 8 of its 32 layers; seq 2048,
# micro-batch 1, grad-accum 4, prompt 64; 5 optimizer steps of 20 rows.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_PROMPT, TRAIN_STEPS = 8, 2048, 4, 64, 5
# Kernel against plain version at the training shape.  The forward output
# keeps FLASH_TOL.  lse is f32 from scores and sums taken in another order
# than the plain version's (K9 may also fuse the rotation's multiply-add
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

# Times of the first designs of the redesigned kernels, copied from PERF.md's
# kernel table (the WMMA designs: the flash kernels with their accumulators
# in shared memory, the int8 grouped pair widening int8 through shared
# memory, the bf16 grouped pair and the fused expert FFN on cp.async and
# mma.sync; dq at T after its unused shared tile went; the direct flash
# kernel with its score rows in shared memory, as timed in the final run
# before its redesign; on an H100 80GB HBM3 at 700 W); constants, not
# measured here.
FIRST_DESIGN_MS = {"flash_attention_fwd": 0.3158, "flash_attention_fwd T": 2.7245,
                   "flash_attention_fwd chat": 0.1324,
                   "flash_attention_fwd Dream geometry": 0.1455,
                   "flash_attention_bwd_dkv": 1.7452, "flash_attention_bwd_dq": 0.9744,
                   "grouped_gateup_q": 1.3266, "grouped_down_q": 0.7082,
                   "grouped_gateup": 1.1576, "grouped_down": 0.5802,
                   "grouped_ffn_fused": 0.8177,
                   "flash_attention_direct chat": 0.0664,
                   "flash_attention_direct Dream geometry": 0.1296}
# Rounds of the in-turn timings; the median of each is reported.
TURNS = 5


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


def time_turns(fns, iters: int, rounds: int = TURNS) -> dict:
    """Median device ms per call of each function in ``fns`` (name → fn),
    timed in turns: each round times every function ``iters`` calls in a
    row, one after the other, so a drift of the card's clock or of its
    neighbours falls on all of them alike."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, iters, warmup=0))
    return {name: statistics.median(t) for name, t in times.items()}


def report_rate(label: str, flops: float, ms: float, bound: float) -> dict:
    """Print and return a kernel's achieved TFLOP/s and share of its bound."""
    tflops = flops / ms / 1e9
    share = bound / ms
    print(f"  {label}: {tflops:.1f} TFLOP/s achieved, {share:.4f} of its bound "
          f"({bound:.4f} ms / {ms:.4f} ms)", flush=True)
    return dict(tflops=tflops, bound_share=share)


def ptxas_report(libs) -> None:
    """Print ptxas's entry, register, spill and warning lines (a warning
    names, among others, wgmma products it had to serialize), and the spill
    bytes of the flash forward, dq and dk/dv kernels at head dim 128, of the
    direct flash kernel at head dim 128 (one or two warpgroups with K
    resident, two with K streamed), of the bf16 and int8 grouped kernels and
    of the fused expert FFN (found by their mangled names)."""
    watch = {"flash_fwd_kernel<128>": "16flash_fwd_kernelILi128E",
             "flash_bwd_dq_kernel<128>": "19flash_bwd_dq_kernelILi128E",
             "flash_bwd_dkv_kernel<128>": "20flash_bwd_dkv_kernelILi128E",
             "flash_direct_kernel<128, 1, resident> (chat)":
                 "19flash_direct_kernelILi128ELi1ELb1E",
             "flash_direct_kernel<128, 2, resident> (Dream)":
                 "19flash_direct_kernelILi128ELi2ELb1E",
             "flash_direct_kernel<128, 2, streamed>": "19flash_direct_kernelILi128ELi2ELb0E",
             "grouped_ffn_fused_kernel": "24grouped_ffn_fused_kernel",
             "grouped_gemm_kernel<2> (gate/up)": "19grouped_gemm_kernelILi2E",
             "grouped_gemm_kernel<1> (down)": "19grouped_gemm_kernelILi1E",
             "grouped_gemm_q_kernel<2> (gate/up)": "21grouped_gemm_q_kernelILi2E",
             "grouped_gemm_q_kernel<1> (down)": "21grouped_gemm_q_kernelILi1E"}
    spills = {}
    for lib in libs:
        entry = ""
        for line in lib.path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif not ("registers" in line or "spill" in line
                      or "warning" in line.lower()):
                continue
            print(f"  {lib.source.name}: {line.strip()}", flush=True)
            stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            for name, mangled in watch.items():
                if stores and mangled in entry:
                    spills[name] = int(stores.group(1)) + int(stores.group(2))
    print("  spill bytes: " + ", ".join(
        f"{k} {spills.get(k, 'not found')}" for k in watch), flush=True)


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


def skip_pad_check(name, got, want, real):
    """A grouped kernel's output with ``tile_valid``: the rows of ``real``
    tiles against the plain version, every other row zero."""
    err = compare(f"{name} with tile_valid, real rows", got[real], want[real],
                  **GROUPED_TOL)
    if got[~real].any():
        raise AssertionError(f"{name}: a tile that tile_valid marks empty is not zero")
    return err


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
    L = wg.shape[0]
    bf16 = xs.element_size()
    src = "ct_diffusionmodelbench_tpu_torch/csrc/grouped_gemm.cu"
    ref = "ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py"

    # The pad-skip vector grouped_expert_ffn_cuda hands the pair: tiles with
    # no real row, zero-filled instead of multiplied.
    valid = gg.valid_tiles(sizes, tile_expert, gg.TILE_M, m_pad)
    real = valid.repeat_interleave(gg.TILE_M) != 0
    print(f"  pad-skip: {int((valid == 0).sum())} of {valid.numel()} tiles hold no "
          f"real row", flush=True)

    # gate/up
    h_k = gg.grouped_gateup(xs, wg, wu, tile_expert, gg.TILE_M, li)
    h_p = gg.grouped_gateup_plain(xs, wg, wu, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = max(compare("grouped_gateup", h_k, h_p, **GROUPED_TOL), skip_pad_check(
        "grouped_gateup",
        gg.grouped_gateup(xs, wg, wu, tile_expert, gg.TILE_M, li, valid), h_p, real))
    h_out = torch.empty_like(h_k)

    def gateup(tile_valid):
        return lambda: gg.GATEUP_KERNEL(
            xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), h_out.data_ptr(),
            tile_expert.data_ptr(), m_pad, D, Fm, E, L, li, gg.TILE_M, tile_valid, stream)

    p_ms = time_ms(lambda: gg.grouped_gateup_plain(
        xs, wg, wu, tile_expert, gg.TILE_M, li, valid), 3, warmup=1)
    fns = {"kernel": gateup(valid.data_ptr()), "no_skip": gateup(None)}
    if grouped_mm is not None:
        w_gu = torch.cat([wg[li], wu[li]], dim=-1)
        fns["library"] = lambda: grouped_mm(xs, w_gu, offs=pend)
    turns = time_turns(fns, 20)
    # Work and bytes of the m routed rows only: the m_pad - m padding rows
    # copy token 0 and carry combine weight 0.
    flops = 4.0 * m * D * Fm
    b_ms, b_by = bound_ms(flops, m * (D + Fm) * bf16 + nbytes(tile_expert)
                          + used * 2 * D * Fm * bf16)
    rate = report_rate("grouped_gateup", flops, turns["kernel"], b_ms)
    results.append(dict(
        name="grouped_gateup", route="cuda", source=src, replaces=f"{ref}:901",
        max_abs_err=err, ms=turns["kernel"], plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=turns.get("library"), no_skip_ms=turns["no_skip"],
        **rate))

    # down, on the plain gate/up output for both
    o_k = gg.grouped_down(h_p, wd, tile_expert, gg.TILE_M, li)
    o_p = gg.grouped_down_plain(h_p, wd, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = max(compare("grouped_down", o_k, o_p, **GROUPED_TOL), skip_pad_check(
        "grouped_down", gg.grouped_down(h_p, wd, tile_expert, gg.TILE_M, li, valid), o_p,
        real))
    o_out = torch.empty_like(o_k)

    def down(tile_valid):
        return lambda: gg.DOWN_KERNEL(
            h_p.data_ptr(), wd.data_ptr(), o_out.data_ptr(), tile_expert.data_ptr(),
            m_pad, Fm, D, E, L, li, gg.TILE_M, tile_valid, stream)

    p_ms = time_ms(lambda: gg.grouped_down_plain(
        h_p, wd, tile_expert, gg.TILE_M, li, valid), 3, warmup=1)
    fns = {"kernel": down(valid.data_ptr()), "no_skip": down(None)}
    if grouped_mm is not None:
        wd_l = wd[li]
        fns["library"] = lambda: grouped_mm(h_p, wd_l, offs=pend)
    turns = time_turns(fns, 20)
    flops = 2.0 * m * Fm * D
    b_ms, b_by = bound_ms(flops, m * (Fm + D) * bf16 + nbytes(tile_expert)
                          + used * Fm * D * bf16)
    rate = report_rate("grouped_down", flops, turns["kernel"], b_ms)
    results.append(dict(
        name="grouped_down", route="cuda", source=src, replaces=f"{ref}:969",
        max_abs_err=err, ms=turns["kernel"], plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=turns.get("library"), no_skip_ms=turns["no_skip"],
        **rate))
    for r in results:
        print(f"  {r['name']}: kernel (with tile_valid, as on the main path) "
              f"{r['ms']:.4f} ms, without {r['no_skip_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library (torch._grouped_mm; in turns with "
              f"the kernel) {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    host_us_per_launch({"grouped_gateup": gateup(valid.data_ptr()),
                        "grouped_down": down(valid.data_ptr())})
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
    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, mask=mask, rope=(cos, sin)), 10)
    qr = apply_rope(q, cos, sin).transpose(1, 2)
    kr = apply_rope(k, cos, sin).transpose(1, 2)
    vt = v.transpose(1, 2)
    keep = mask.bool()[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    turns = time_turns({
        "kernel": lambda: fa.FLASH_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), a_out.data_ptr(), None, BATCH, SEQ, kv_len, H, KV, Dh,
            Dh ** -0.5, stream),
        "sdpa": lambda: sdpa(qr, kr, vt, attn_mask=keep, enable_gqa=True)}, 50)
    k_ms, lib_ms = turns["kernel"], turns["sdpa"]
    flops = 4.0 * BATCH * H * SEQ * SEQ * Dh
    b_ms, b_by = bound_ms(flops, nbytes(q, k, v, a_k, bias, cos, sin))
    rate = report_rate("flash_attention_fwd (decode shape)", flops, k_ms, b_ms)
    results.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="ct_diffusionmodelbench_tpu_torch/csrc/flash_attention.cu",
        replaces="ct_diffusionmodelbench_tpu/ops/flash_attention.py:312",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, **rate))
    r = results[-1]
    print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']})", flush=True)
    for r in results:
        r["kernel_ms"] = r["ms"]
    return results


def host_us_per_launch(fns, n: int = 200) -> None:
    """Print the host microseconds of one launch of each kernel in ``fns``
    (name → launch): the ctypes call, the tensor maps encoded on the host,
    the launch.  n launches stay under the launch queue's depth, so the host
    never waits for the card."""
    out = {}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    print("  host us per launch: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()),
          flush=True)


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


def chat_runner(cfg, params, dev):
    """The runner ``--preset llada-moe-7b`` builds (``ModelRunner.random_init``
    at seed 0 draws these very weights), around phase 3's tensors."""
    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer

    tok = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size,
                                  eos_token_id=cfg.eos_token_id or 2)
    return ModelRunner(cfg, params, tok, device=dev)


def chat_args():
    from ct_diffusionmodelbench_tpu_torch.cli import chat

    return chat.build_parser().parse_args(
        ["--preset", "llada-moe-7b", "--prompt", CHAT_PROMPT,
         "--gen-length", str(CHAT_GEN), "--steps", str(CHAT_STEPS)])


def chat_step_inputs(runner, args):
    """The ids and mask of a chat denoise step: the template around the
    prompt, left-padded to the runner's bucket, then ``gen`` mask ids."""
    from ct_diffusionmodelbench_tpu_torch.cli.chat import build_system

    messages = [{"role": "system", "content": build_system(not args.no_lean_only,
                                                           args.system_message)},
                {"role": "user", "content": args.prompt}]
    text = runner.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
    ids = runner.tokenizer.encode(text, max_length=args.max_length)
    b = runner.prompt_bucket
    p = (len(ids) + b - 1) // b * b
    x = torch.full((1, p + args.gen_length), runner.mask_id, dtype=torch.long)
    x[0, :p - len(ids)] = runner.tokenizer.pad_token_id or 0
    x[0, p - len(ids):p] = torch.tensor(ids)
    mask = torch.ones_like(x, dtype=torch.int32)
    mask[0, :p - len(ids)] = 0
    return x.to(runner.device), mask.to(runner.device), p


def capture_layer(fwd, params, ids, mask, li, **kw):
    """Layer ``li``'s MoE input and expert choice and its attention inputs
    in one forward."""
    from ct_diffusionmodelbench_tpu_torch.models import moe
    from ct_diffusionmodelbench_tpu_torch.ops import attention

    routed, attended = [], []
    router_probs, flash = moe.router_probs, attention.flash_attention

    def recording_router(x, w, top_k, norm_topk):
        out = router_probs(x, w, top_k, norm_topk)
        routed.append((x, out[1]))
        return out

    def recording_flash(q, k, v, mask=None, rope=None):
        attended.append((q, k, v, mask, rope))
        return flash(q, k, v, mask=mask, rope=rope)

    try:
        moe.router_probs, attention.flash_attention = recording_router, recording_flash
        fwd(params, ids, mask, **kw)
    finally:
        moe.router_probs, attention.flash_attention = router_probs, flash
    return routed[li], attended[li]


def direct_case(name, q, k, v, mask, rope, dev, stream):
    """K9 with and without lse against its plain version; times of K9, K8,
    the plain version and SDPA on the same inputs."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa

    b, s, h, dh = q.shape
    kv = k.shape[2]
    cos, sin = rope
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope, with_lse=True)
    out2 = fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope)
    out_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=rope, with_lse=True)
    torch.cuda.synchronize()
    err = max(compare(f"flash_attention_direct {name} out", out, out_p, **GROUPED_TOL),
              compare(f"flash_attention_direct {name} out, no lse", out2, out_p,
                      **GROUPED_TOL),
              compare(f"flash_attention_direct {name} lse", lse, lse_p, 0.0, LSE_ATOL))
    bias = fa.mask_bias(mask, b, s, dev)
    buf = torch.empty_like(out)
    kv_len = fa.kv_tile_len(s)

    def raw(kernel):
        return lambda: kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                              cos.data_ptr(), sin.data_ptr(), buf.data_ptr(), None, b,
                              s, kv_len, h, kv, dh, dh ** -0.5, stream)

    p_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, mask=mask, rope=rope), 10)
    qr = apply_rope(q, cos, sin).transpose(1, 2)
    kr = apply_rope(k, cos, sin).transpose(1, 2)
    vt = v.transpose(1, 2)
    keep = mask.bool()[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    turns = time_turns({"K9": raw(fa.DIRECT_KERNEL), "K8": raw(fa.FLASH_KERNEL),
                        "sdpa": lambda: sdpa(qr, kr, vt, attn_mask=keep, enable_gqa=True)},
                       50)
    k_ms, k8_ms, lib_ms = turns["K9"], turns["K8"], turns["sdpa"]
    flops = 4.0 * b * h * s * s * dh
    b_ms, b_by = bound_ms(flops, nbytes(q, k, v, out, bias, cos, sin))
    rate = report_rate(f"flash_attention_direct {name}", flops, k_ms, b_ms)
    print(f"  flash_attention_direct {name} (B {b}, S {s}, H {h}, KV {kv}, Dh {dh}): "
          f"kernel {k_ms:.4f} ms, K8 {k8_ms:.4f} ms, SDPA {lib_ms:.4f} ms in the same "
          f"turns; plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
          f"{rate['bound_share']:.4f} of its bound; before its redesign "
          f"{FIRST_DESIGN_MS[f'flash_attention_direct {name}']} ms (PERF.md)", flush=True)
    return dict(shape=f"B {b}, S {s}, H {h}, KV {kv}, Dh {dh}, RoPE, left padding",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, k8_ms=k8_ms, **rate)


def single_prompt_kernel_phase(cfg, params, dev):
    """K3 and K9 at the chat path's shapes against their plain versions."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import rope_angles
    from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    runner = chat_runner(cfg, params, dev)
    ids, mask, p = chat_step_inputs(runner, chat_args())
    li = 1
    (x, topk_idx), (q, k, v, amask, rope) = capture_layer(
        runner.forward_fn, params, ids, mask, li, logit_start=p, logit_length=BLOCK)
    D, E, K, Fm = (cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok,
                   cfg.moe_intermediate_size)
    blocks = params["blocks"]
    wg, wu, wd = blocks["we_gate"], blocks["we_up"], blocks["we_down"]
    dest, tile_expert, sizes, m_pad = gg.counting_layout(topk_idx, E, gg.TILE_M)
    xs = gg.gather_rows(x, dest, K, m_pad)
    m = x.shape[0] * K
    used = int((sizes > 0).sum())
    print(f"  chat step: prompt {p} (bucketed), S {ids.shape[1]}, N {x.shape[0]}, "
          f"M {m}, m_pad {m_pad}, experts used {used}/{E}, largest group "
          f"{int(sizes.max())}, smallest {int(sizes.min())}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []

    # K3: the fused expert FFN on layer 1's routing, stacked weights, with
    # the pad-skip vector grouped_expert_ffn_cuda hands it and without it
    valid = gg.valid_tiles(sizes, tile_expert, gg.TILE_M, m_pad)
    real = valid.repeat_interleave(gg.TILE_M) != 0
    n_valid = int(valid.sum())
    print(f"  pad-skip: {n_valid} of {valid.numel()} tiles hold a real row", flush=True)
    out_k = gg.grouped_ffn_fused(xs, wg, wu, wd, tile_expert, gg.TILE_M, li, valid)
    out_all = gg.grouped_ffn_fused(xs, wg, wu, wd, tile_expert, gg.TILE_M, li)
    h_p = gg.grouped_gateup_plain(xs, wg, wu, tile_expert, gg.TILE_M, li)
    out_p = gg.grouped_down_plain(h_p, wd, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    flip = H_FLIP * float(h_p.abs().max()) * float(wd[li].abs().max())
    atol = max(GROUPED_TOL["atol"], flip)
    over = int(((out_all.float() - out_p.float()).abs()
                > GROUPED_TOL["atol"] + GROUPED_TOL["rtol"] * out_p.float().abs()).sum())
    print(f"  grouped_ffn_fused: {over}/{out_p.numel()} elements past one bf16 ulp "
          f"(GROUPED_TOL); the flipped-h term adds atol {flip:.3e}", flush=True)
    err = max(compare("grouped_ffn_fused", out_all, out_p, GROUPED_TOL["rtol"], atol),
              compare("grouped_ffn_fused with tile_valid, real rows", out_k[real],
                      out_p[real], GROUPED_TOL["rtol"], atol))
    if out_k[~real].any():
        raise AssertionError("grouped_ffn_fused: a tile that tile_valid marks empty is "
                             "not zero")
    if not torch.equal(out_k, gg.grouped_ffn_fused(xs, wg, wu, wd, tile_expert, gg.TILE_M,
                                                   li, valid)):
        raise AssertionError("grouped_ffn_fused: two calls on the same input differ")
    buf = torch.empty_like(out_k)
    h_buf = torch.empty_like(h_p)
    L = wg.shape[0]

    def fused(tile_valid):
        return lambda: gg.FUSED_KERNEL(
            xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), buf.data_ptr(),
            tile_expert.data_ptr(), m_pad, D, Fm, E, L, li, gg.TILE_M, tile_valid, stream)

    def pair():
        gg.GATEUP_KERNEL(xs.data_ptr(), wg.data_ptr(), wu.data_ptr(), h_buf.data_ptr(),
                         tile_expert.data_ptr(), m_pad, D, Fm, E, L, li, gg.TILE_M,
                         valid.data_ptr(), stream)
        gg.DOWN_KERNEL(h_buf.data_ptr(), wd.data_ptr(), buf.data_ptr(),
                       tile_expert.data_ptr(), m_pad, Fm, D, E, L, li, gg.TILE_M,
                       valid.data_ptr(), stream)

    p_ms = time_ms(lambda: gg.grouped_ffn_fused_plain(
        xs, wg, wu, wd, tile_expert, gg.TILE_M, li, valid), 3, warmup=1)
    fns = {"kernel": fused(valid.data_ptr()), "no_skip": fused(None), "pair": pair}
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is not None:
        pend = torch.cumsum(gg._round_up(sizes, gg.TILE_M), 0, dtype=torch.int32)
        w_gu = torch.cat([wg[li], wu[li]], dim=-1)
        wd_l = wd[li]

        def library():
            gu = grouped_mm(xs, w_gu, offs=pend)
            h = (torch.nn.functional.silu(gu[:, :Fm].float()) * gu[:, Fm:].float()
                 ).to(xs.dtype)
            return grouped_mm(h, wd_l, offs=pend)

        fns["library"] = library
    turns = time_turns(fns, 20)
    k_ms, pair_ms, lib_ms = turns["kernel"], turns["pair"], turns.get("library")
    bf16 = xs.element_size()
    # The m routed rows' x and out once (padding rows copy token 0 and carry
    # combine weight 0), each used expert's three matrices once; h stays on
    # chip.
    flops = 6.0 * m * D * Fm
    b_ms, b_by = bound_ms(flops, 2 * m * D * bf16 + nbytes(tile_expert)
                          + used * 3 * D * Fm * bf16)
    rate = report_rate("grouped_ffn_fused", flops, k_ms, b_ms)
    print(f"  grouped_ffn_fused: kernel (with tile_valid, as on the chat path) "
          f"{k_ms:.4f} ms, without {turns['no_skip']:.4f} ms, pair (K1 + K2 with "
          f"tile_valid) {pair_ms:.4f} ms, library (torch._grouped_mm, silu * up, "
          f"torch._grouped_mm) {lib_ms}, all in turns; plain {p_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    results.append(dict(
        name="grouped_ffn_fused", route="cuda",
        source="ct_diffusionmodelbench_tpu_torch/csrc/grouped_ffn_fused.cu",
        replaces="ct_diffusionmodelbench_tpu/ops/grouped_gemm_pallas.py:670",
        max_abs_err=err, ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, pair_ms=pair_ms, no_skip_ms=turns["no_skip"],
        valid_tiles=n_valid, **rate))
    del out_k, out_all, out_p, h_p, buf, h_buf, xs

    # K9: layer 1's attention inputs (H 16, KV 4), then Dream's geometry
    chat = direct_case("chat", q, k, v, amask, rope, dev, stream)
    s = q.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    qd = torch.randn((1, s, 28, 128), generator=gen, device=dev, dtype=torch.bfloat16)
    kd, vd = (torch.randn((1, s, 4, 128), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    rope_d = rope_angles(token_positions(amask, 1, s, dev), 128, 1000000.0)
    dream = direct_case("Dream geometry", qd, kd, vd, amask, rope_d, dev, stream)
    results.append(dict(
        name="flash_attention_direct", route="cuda",
        source="ct_diffusionmodelbench_tpu_torch/csrc/flash_attention_direct.cu",
        replaces="ct_diffusionmodelbench_tpu/ops/flash_attention.py:118",
        max_abs_err=max(chat["max_abs_err"], dream["max_abs_err"]), ms=chat["ms"],
        kernel_ms=chat["ms"], plain_ms=chat["plain_ms"], bound_ms=chat["bound_ms"],
        bound_by=chat["bound_by"], library_ms=chat["library_ms"], k8_ms=chat["k8_ms"],
        tflops=chat["tflops"], bound_share=chat["bound_share"], dream_geometry=dream))
    return results, runner


@contextlib.contextmanager
def switches_on(*names):
    """Set the environment switches ``names`` to "1" for a phase."""
    saved = {n: os.environ.get(n) for n in names}
    os.environ.update({n: "1" for n in names})
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def chat_slice_phase(runner, dev):
    """``run_chat`` at the chat defaults through K3 and K9, then one short
    ``chat_base._respond``."""
    from ct_diffusionmodelbench_tpu_torch.cli import chat, chat_base
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts

    args = chat_args()
    results = []
    generate = runner.generate

    def recording_generate(*a, **kw):
        results.append(generate(*a, **kw))
        return results[-1]

    runner.generate = recording_generate
    try:
        chat.run_chat(runner, args.prompt, args)          # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = chat.run_chat(runner, args.prompt, args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        del runner.generate
    launches = {name: k.launches for name, k in KERNELS.items()}
    out = results[-1].token_ids
    s = len(out)
    p = s - CHAT_GEN
    m = s * runner.cfg.num_experts_per_tok
    m_pad = (m + 63) // 64 * 64 + runner.cfg.num_experts * 64
    print(f"  run_chat: {secs:.4f} s ({res['latency_sec']} s inside), "
          f"{CHAT_GEN / secs:.2f} tok/s (B 1, prompt {p} bucketed, gen {CHAT_GEN}, "
          f"steps {CHAT_STEPS}, block {args.block_length}; S {s}, M {m}, m_pad {m_pad})",
          flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    want = runner.cfg.num_layers * CHAT_STEPS
    bad = {n: c for n, c in launches.items()
           if c != (want if n in SINGLE_PROMPT_KERNELS else 0)}
    if bad:
        raise AssertionError(f"expected {want} launches of K3 and K9 and none of "
                             f"the others, got {bad}")
    left = int((out[p:] == runner.mask_id).sum())
    print(f"  mask ids left: {left}; continuation {len(results[-1].continuation_ids)} "
          f"tokens after EOS truncation", flush=True)
    if left:
        raise AssertionError(f"{left} mask ids remain after decoding")

    base = chat_runner(runner.cfg, runner.params, dev)
    chat_base.as_causal(base)
    base_args = chat_base.build_parser().parse_args(
        ["--max-new-tokens", str(CHAT_BASE_TOKENS), "--temperature", "0"])
    messages = [{"role": "system", "content": chat.BASE_SYSTEM},
                {"role": "user", "content": CHAT_PROMPT}]
    reset_launch_counts()
    t0 = time.perf_counter()
    reply = chat_base._respond(base, messages, base_args)
    torch.cuda.synchronize()
    base_secs = time.perf_counter() - t0
    fused = KERNELS["grouped_ffn_fused"].launches
    print(f"  chat_base._respond (causal, {CHAT_BASE_TOKENS} new tokens): "
          f"{base_secs:.4f} s, {len(reply)} characters, K3 launches {fused}", flush=True)
    if fused != runner.cfg.num_layers * CHAT_BASE_TOKENS:
        raise AssertionError(f"the AR baseline launched K3 {fused} times")
    return dict(seconds=secs, tokens_per_s=CHAT_GEN / secs, launches=launches,
                ids=torch.from_numpy(out)[None].to(dev))


def chat_depth_phase(cfg, params, ids, dev):
    """2-layer full-width forward through K3 and K9 against the same forward
    on their plain versions, the plain run on the kernel run's expert
    choice."""
    from ct_diffusionmodelbench_tpu_torch.ops import attention
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    seams = [(attention, "flash_attention", fa.flash_attention_plain),
             (gg, "grouped_ffn_fused", gg.grouped_ffn_fused_plain)]
    return pinned_compare("2-layer logits through K3 and K9, kernels vs plain",
                          cfg.replace(num_layers=2), ids, dev, params, params, seams)


def dream_slice_phase(dev):
    """Full-size dream-7b through ``ModelRunner.generate`` at B 1 with the
    direct flash kernel."""
    from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts

    t0 = time.perf_counter()
    runner = ModelRunner.random_init("dream-7b", seed=0)
    torch.cuda.synchronize()
    cfg = runner.cfg
    print(f"  init dream-7b (ModelRunner.random_init): {cfg.param_count() / 1e9:.3f} G "
          f"params, {tree_bytes(runner.params) / 1e9:.3f} GB of weights, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    from ct_diffusionmodelbench_tpu_torch.cli.chat import build_system

    text = runner.tokenizer.apply_chat_template(
        [{"role": "system", "content": build_system(True)},
         {"role": "user", "content": CHAT_PROMPT}])             # the chat slice's
    kw = dict(gen_length=CHAT_GEN, temperature=0.0, alg="entropy")
    runner.generate(text, steps=8, **kw)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = runner.generate(text, steps=CHAT_STEPS, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    out = res.token_ids
    p = len(out) - CHAT_GEN
    print(f"  generate: {secs:.4f} s, {CHAT_GEN / secs:.2f} tok/s (B 1, prompt {p} "
          f"bucketed, gen {CHAT_GEN}, steps {CHAT_STEPS}, temperature 0, entropy, "
          f"top_p 0.95)", flush=True)
    print(f"  peak memory: {peak / 2**30:.3f} GiB", flush=True)
    print(f"  launches: {json.dumps(launches)}", flush=True)
    want = cfg.num_layers * CHAT_STEPS
    bad = {n: c for n, c in launches.items()
           if c != (want if n == "flash_attention_direct" else 0)}
    if bad:
        raise AssertionError(f"expected {want} launches of K9 and none of the "
                             f"others, got {bad}")
    left = int((out[p:] == runner.mask_id).sum())
    print(f"  mask ids left: {left}", flush=True)
    if left:
        raise AssertionError(f"{left} mask ids remain after decoding")
    ids = torch.from_numpy(out)[None].to(dev)
    l1, _ = runner.forward_fn(runner.params, ids, logit_start=p, logit_length=CHAT_GEN)
    l2, _ = runner.forward_fn(runner.params, ids, logit_start=p, logit_length=CHAT_GEN)
    same = torch.equal(l1, l2)
    print(f"  repeated forward bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("two forwards on the same input differ")
    if not torch.isfinite(l1).all():
        raise AssertionError("non-finite logits")
    return dict(seconds=secs, tokens_per_s=CHAT_GEN / secs, peak_gib=peak / 2**30,
                launches=launches)


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

    # The pad-skip vector grouped_expert_ffn_cuda hands the pair: tiles with
    # no real row, zero-filled instead of multiplied.
    valid = gg.valid_tiles(sizes, tile_expert, gg.TILE_M, m_pad)
    real = valid.repeat_interleave(gg.TILE_M) != 0
    print(f"  pad-skip: {int((valid == 0).sum())} of {valid.numel()} tiles hold no "
          f"real row", flush=True)

    # gate/up
    h_k = gg.grouped_gateup_q(xs, qg, qu, tile_expert, gg.TILE_M, li)
    h_p = gg.grouped_gateup_q_plain(xs, qg, qu, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = max(compare("grouped_gateup_q", h_k, h_p, **GROUPED_TOL), skip_pad_check(
        "grouped_gateup_q",
        gg.grouped_gateup_q(xs, qg, qu, tile_expert, gg.TILE_M, li, valid), h_p, real))
    h_out = torch.empty_like(h_k)

    def gateup(tile_valid):
        return lambda: gg.GATEUP_Q_KERNEL(
            xs.data_ptr(), qg["q"].data_ptr(), qu["q"].data_ptr(), qg["s"].data_ptr(),
            qu["s"].data_ptr(), h_out.data_ptr(), tile_expert.data_ptr(), m_pad, D, Fm,
            E, li, gg.TILE_M, tile_valid, stream)

    p_ms = time_ms(lambda: gg.grouped_gateup_q_plain(
        xs, qg, qu, tile_expert, gg.TILE_M, li, valid), 3, warmup=1)
    fns = {"kernel": gateup(valid.data_ptr()), "no_skip": gateup(None)}
    if grouped_mm is not None:
        w_gu = torch.cat([layer_deq(qg), layer_deq(qu)], dim=-1)
        fns["library"] = lambda: grouped_mm(xs, w_gu, offs=pend)
    turns = time_turns(fns, 20)
    # The m routed rows' bytes (padding rows copy token 0, weight 0), each
    # used expert's two int8 matrices and their f32 scales once.
    flops = 4.0 * m * D * Fm
    b_ms, b_by = bound_ms(flops, m * (D + Fm) * bf16 + nbytes(tile_expert)
                          + used * 2 * (D * Fm + 4 * Fm))
    rate = report_rate("grouped_gateup_q", flops, turns["kernel"], b_ms)
    results.append(dict(
        name="grouped_gateup_q", route="cuda", source=src, replaces=f"{ref}:1172",
        max_abs_err=err, ms=turns["kernel"], plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=turns.get("library"), no_skip_ms=turns["no_skip"],
        **rate))

    # down, on the plain gate/up output for both
    o_k = gg.grouped_down_q(h_p, qd, tile_expert, gg.TILE_M, li)
    o_p = gg.grouped_down_q_plain(h_p, qd, tile_expert, gg.TILE_M, li)
    torch.cuda.synchronize()
    err = max(compare("grouped_down_q", o_k, o_p, **GROUPED_TOL), skip_pad_check(
        "grouped_down_q",
        gg.grouped_down_q(h_p, qd, tile_expert, gg.TILE_M, li, valid), o_p, real))
    o_out = torch.empty_like(o_k)

    def down(tile_valid):
        return lambda: gg.DOWN_Q_KERNEL(
            h_p.data_ptr(), qd["q"].data_ptr(), qd["s"].data_ptr(), o_out.data_ptr(),
            tile_expert.data_ptr(), m_pad, Fm, D, E, li, gg.TILE_M, tile_valid, stream)

    p_ms = time_ms(lambda: gg.grouped_down_q_plain(
        h_p, qd, tile_expert, gg.TILE_M, li, valid), 3, warmup=1)
    fns = {"kernel": down(valid.data_ptr()), "no_skip": down(None)}
    if grouped_mm is not None:
        wd_l = layer_deq(qd)
        fns["library"] = lambda: grouped_mm(h_p, wd_l, offs=pend)
    turns = time_turns(fns, 20)
    flops = 2.0 * m * Fm * D
    b_ms, b_by = bound_ms(flops, m * (Fm + D) * bf16 + nbytes(tile_expert)
                          + used * (Fm * D + 4 * D))
    rate = report_rate("grouped_down_q", flops, turns["kernel"], b_ms)
    results.append(dict(
        name="grouped_down_q", route="cuda", source=src, replaces=f"{ref}:1242",
        max_abs_err=err, ms=turns["kernel"], plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=turns.get("library"), no_skip_ms=turns["no_skip"],
        **rate))
    for r in results:
        r["kernel_ms"] = r["ms"]
        print(f"  {r['name']}: kernel (with tile_valid, as on the main path) "
              f"{r['ms']:.4f} ms, without {r['no_skip_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"(torch._grouped_mm on weights dequantized to bf16 beforehand, not "
              f"timed; in turns with the kernel) {r['library_ms']}, bound "
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
    fwd_plain_ms = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, rope=rope, with_lse=True), 3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2)
    def fwd(rope_ptrs):
        return lambda: fa.FLASH_KERNEL(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), *rope_ptrs,
            o_buf.data_ptr(), l_buf.data_ptr(), B, S, fa.kv_tile_len(S), H, KV, Dh,
            scale, stream)

    # The kernel without RoPE (null tables: no cos / sin copies, no rotation)
    # shows what the fused rotation costs.
    turns = time_turns({"kernel": fwd((cos.data_ptr(), sin.data_ptr())),
                        "no_rope": fwd((None, None)),
                        "sdpa": lambda: sdpa(qt, kt, vt)}, 20)
    fwd_ms, fwd_lib_ms, no_rope_ms = turns["kernel"], turns["sdpa"], turns["no_rope"]
    print(f"  flash_attention_fwd with lse (training shape): {fwd_ms:.4f} ms, without "
          f"RoPE {no_rope_ms:.4f} ms", flush=True)
    fwd_flops = 4.0 * B * H * S * S * Dh
    fwd_bound = bound_ms(fwd_flops, nbytes(q, k, v, out, lse, bias, cos, sin))
    fwd_rate = report_rate("flash_attention_fwd with lse (training shape)", fwd_flops,
                           fwd_ms, fwd_bound[0])

    dsum = fab.row_dot(out, do)
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=dev)
                  for t in (q, k, v))
    common = (qr.data_ptr(), kr.data_ptr(), v.data_ptr(), bias.data_ptr(),
              do.data_ptr(), lse.data_ptr(), dsum.data_ptr())
    bwd_plain_ms = time_ms(lambda: fab.flash_attention_bwd_plain(
        qr, kr, v, bias, out, do, lse), 3, warmup=1)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    s_out = sdpa(qg, kg, vg)
    dot = do.transpose(1, 2)
    turns = time_turns({
        "dq": lambda: fab.DQ_KERNEL(*common, dq.data_ptr(), B, S, H, KV, Dh, scale, stream),
        "dkv": lambda: fab.DKV_KERNEL(*common, dk.data_ptr(), dv.data_ptr(), B, S, H, KV,
                                      Dh, scale, stream),
        "sdpa_bwd": lambda: torch.autograd.grad(s_out, (qg, kg, vg), dot,
                                                retain_graph=True)}, 20)
    dq_ms, dkv_ms, sdpa_bwd_ms = turns["dq"], turns["dkv"], turns["sdpa_bwd"]
    ins = nbytes(qr, kr, v, do, lse, dsum, bias)
    dq_flops, dkv_flops = 6.0 * B * H * S * S * Dh, 8.0 * B * H * S * S * Dh
    dq_bound = bound_ms(dq_flops, ins + nbytes(dq))
    dkv_bound = bound_ms(dkv_flops, ins + nbytes(dk, dv))
    dq_rate = report_rate("flash_attention_bwd_dq (training shape)", dq_flops, dq_ms,
                          dq_bound[0])
    print(f"  flash_attention_bwd_dq: {dq_ms:.4f} ms against dk/dv {dkv_ms:.4f} ms and "
          f"SDPA's whole backward {sdpa_bwd_ms:.4f} ms in the same turns; "
          f"{dq_rate['bound_share']:.4f} of its bound; first design "
          f"{FIRST_DESIGN_MS['flash_attention_bwd_dq']} ms (PERF.md)", flush=True)
    dkv_rate = report_rate("flash_attention_bwd_dkv (training shape)", dkv_flops, dkv_ms,
                           dkv_bound[0])
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
             library_ms=None, sdpa_backward_ms=sdpa_bwd_ms, **dq_rate),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=src,
             replaces=f"{ref}:93", max_abs_err=err_bwd, ms=dkv_ms, kernel_ms=dkv_ms,
             plain_ms=bwd_plain_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
             library_ms=None, sdpa_backward_ms=sdpa_bwd_ms, **dkv_rate),
    ]
    fwd_train = dict(shape=f"B {B}, S {S}, H {H}, KV {KV}, Dh {Dh}, RoPE, lse",
                     max_abs_err=err_fwd, ms=fwd_ms, plain_ms=fwd_plain_ms,
                     bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                     library_ms=fwd_lib_ms, no_rope_ms=no_rope_ms, **fwd_rate)
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
    if importlib.util.find_spec("ct_diffusionmodelbench_tpu_torch") is None:
        print("chip_smoke: the package ct_diffusionmodelbench_tpu_torch is not beside "
              "this script; run it from the repository's root", file=sys.stderr)
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
            grouped_gemm_cuda.LIBRARY_FUSED, flash_attention.LIBRARY,
            flash_attention.LIBRARY_DIRECT, flash_attention_bwd.LIBRARY]
    build_s = build_all(libs)
    print(f"kernel build: {build_s:.2f} s", flush=True)
    ptxas_report(libs)

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
    del sl
    with switches_on("CTDB_GROUPED_FUSED", "CTDB_FLASH_DIRECT"):
        print("single-prompt kernels:", flush=True)
        sp_results, runner = single_prompt_kernel_phase(cfg, params, dev)
        print("chat slice:", flush=True)
        chat = chat_slice_phase(runner, dev)
        print("chat depth check:", flush=True)
        chat_depth_phase(cfg, params, chat["ids"], dev)
    for r in sp_results:
        r["launches"] = chat["launches"][r["name"]]
    results += sp_results
    del params, runner, chat
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

    with switches_on("CTDB_FLASH_DIRECT"):
        print("Dream slice:", flush=True)
        dream = dream_slice_phase(dev)
    next(r for r in results if r["name"] == "flash_attention_direct")[
        "dream_launches"] = dream["launches"]["flash_attention_direct"]
    del dream
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
            "tflops", "bound_share", "sdpa_backward_ms", "training_shape", "pair_ms",
            "k8_ms", "dream_geometry", "dream_launches", "no_skip_ms", "valid_tiles")
    print("first designs' ms (constants from PERF.md, not measured in this run): "
          + json.dumps(FIRST_DESIGN_MS), flush=True)
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
