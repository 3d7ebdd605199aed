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

Prints the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Exits non-zero, printing no result, without a card or if any phase
fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
        sin.data_ptr(), a_out.data_ptr(), BATCH, SEQ, kv_len, H, KV, Dh,
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
    bad = {n: c for n, c in launches.items() if c != want}
    if bad:
        raise AssertionError(f"expected {want} launches of each kernel, got {bad}")
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


def depth_phase(cfg, params, ids, dev):
    """2-layer full-width forward: kernels against their plain versions, the
    plain run on the kernel run's expert choice."""
    from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.models import moe
    from ct_diffusionmodelbench_tpu_torch.ops import attention
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
    from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg

    cfg2 = cfg.replace(num_layers=2)  # the first two layers of the full stacks
    router_probs = moe.router_probs
    chosen, flipped = [], []  # per layer: kernel run's top-k; tokens whose
                              # own plain choice differs from it

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

    # The plain run swaps each kernel's wrapper for its plain version at the
    # one name the model calls it by, and the router for the pinned one.
    seams = [(moe, "router_probs"), (attention, "flash_attention"),
             (gg, "grouped_gateup"), (gg, "grouped_down")]
    saved = [getattr(mod, name) for mod, name in seams]
    plain = [pinned_router, fa.flash_attention_plain, gg.grouped_gateup_plain,
             gg.grouped_down_plain]
    kw = dict(logit_start=PROMPT, logit_length=BLOCK)
    try:
        moe.router_probs = recording_router
        lk, _ = make_forward_fn(cfg2)(params, ids, **kw)
        for (mod, name), fn in zip(seams, plain):
            setattr(mod, name, fn)
        lp, _ = make_forward_fn(cfg2)(params, ids, **kw)
    finally:
        for (mod, name), fn in zip(seams, saved):
            setattr(mod, name, fn)
    print("  tokens whose own expert choice differs, kernels vs plain "
          "(pinned to the kernels' choice): "
          + ", ".join(f"layer {i} {int(f.sum())}/{f.numel()}"
                      for i, f in enumerate(flipped)), flush=True)
    if not torch.isfinite(lk).all():
        raise AssertionError("non-finite logits from the 2-layer forward")
    err_p = (lk - lp).abs().amax(dim=-1).flatten()      # per position
    scale = float(lp.abs().max())
    tol = LOGITS_RTOL_OF_MAX * scale
    top2 = lp.topk(2, dim=-1).values.flatten(0, 1)
    gap = top2[:, 0] - top2[:, 1]
    differ = (lk.argmax(-1) != lp.argmax(-1)).flatten()
    # The argmax form of the tolerance: it may move only where the plain
    # top-2 logits lie within 2 * tol of each other.
    clear_moves = int((differ & (gap > 2 * tol)).sum())
    q = torch.quantile(err_p.float(), torch.tensor([0.5, 0.9, 0.99], device=dev))
    print(f"  2-layer logits, max |logit| {scale:.4e}, tolerance {tol:.4e}: "
          f"per-position max_abs_err median {float(q[0]):.4e}, p90 {float(q[1]):.4e}, "
          f"p99 {float(q[2]):.4e}, max {float(err_p.max()):.4e}; "
          f"{int((err_p > tol).sum())}/{err_p.numel()} positions past tolerance; "
          f"argmax differs at {int(differ.sum())} ({int((gap <= 2 * tol).sum())} "
          f"positions have a top-2 gap within 2 * tolerance; {clear_moves} "
          f"moved outside them)", flush=True)
    if float(err_p.max()) > tol or clear_moves:
        raise AssertionError("2-layer forward with kernels disagrees with plain")
    return float(err_p.max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
    from ct_diffusionmodelbench_tpu_torch.ops import flash_attention, grouped_gemm_cuda
    from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, build_all

    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    libs = [grouped_gemm_cuda.LIBRARY, flash_attention.LIBRARY]
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
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}),
          flush=True)
    missing = set(KERNELS) - {r["name"] for r in results}
    if missing:
        raise AssertionError(f"kernels not checked: {sorted(missing)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
