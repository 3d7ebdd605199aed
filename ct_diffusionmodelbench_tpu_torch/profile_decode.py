"""Where a denoise step's time goes on the card.

    python -m ct_diffusionmodelbench_tpu_torch.profile_decode
        [--cell decode|chat|dream|block-cache] [--quant int8] [--out FILE]

``--cell decode`` (the default) runs the main path's step shape
(``llada-moe-7b``, random weights, batch 8, prompt 64, gen 256, block 32,
greedy) for 8 steps (one per block: each step is a full forward at S = 320
with the LM head on the 32-token block, as in the 128-step run).  ``--cell
chat`` runs the single-prompt chat shape through ``ModelRunner.generate``
(``llada-moe-7b``, B 1, the chat template around the Lean-only system
prompt bucketed to 384 tokens, gen 128, block 32: 4 steps, one per block)
with ``CTDB_GROUPED_FUSED=1`` and ``CTDB_FLASH_DIRECT=1``; ``--cell dream``
the same prompt through ``dream-7b`` (gen 128, greedy, entropy, 8 steps,
each the work of one of the 128) with ``CTDB_FLASH_DIRECT=1``.  ``--cell
block-cache`` breaks down the two passes of ``accel="block-cache"`` at the
decode cell's shape, 8 calls each: the refresh (a full forward that also
rebuilds the K/V cache, block 0's first step) and the cached step (block 0's
32 tokens against that cache), and the device time and share of the cached
step's rectangular attention (``attention_reference`` on one layer's
inputs, its kernels' device time traced alone, times the layer count, over
the cached step's device busy time).  Each cell (each pass)
runs once unprofiled for warm-up, once unprofiled for the step time, once
under ``torch.profiler`` tracing the device only, for the device time by
kernel and the idle share of that same window, and once tracing host and
device, for the host time by operator (the host tracer's own cost idles the
card, so that window's idle share is reported beside the other, not in its
place).  ``--quant int8`` quantizes each weight as it is built (the int8
serving cell).  Writes the same as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ct_diffusionmodelbench_tpu_torch.cli.chat import build_system
from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn
from ct_diffusionmodelbench_tpu_torch.ops.quant import quantized_leaf_transform
from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate
from ct_diffusionmodelbench_tpu_torch.utils.profiling import device_intervals, union_seconds

BATCH, PROMPT, GEN, BLOCK = 8, 64, 256, 32
STEPS = GEN // BLOCK  # one step per block: same per-step work as 128 steps
TOP = 25
CHAT_PROMPT = "Prove that for every natural number n, n + 0 = n."
CHAT_GEN = 128


def _kernel_us(evt) -> float:
    """Device time of a kernel row; 0 for operator rows, which repeat the
    time of the kernels they launch."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(evt.self_device_time_total)


def trace(run, activities):
    """One call of ``run`` (which must end in a device sync) under
    ``torch.profiler``: (events, [(kernel, device ms, calls)] by time,
    device busy ms, window ms).  Busy is the union of the device intervals
    (``utils/profiling.py``): kernels, copies and sets on any stream, each
    instant counted once."""
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = sorted(((e.key, _kernel_us(e) / 1e3, e.count) for e in events
                  if _kernel_us(e) > 0), key=lambda r: -r[1])
    busy_ms = union_seconds(device_intervals(prof)) * 1e3
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return events, dev, busy_ms, window_ms


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def breakdown(label, run, steps) -> dict:
    """Step time, device time by kernel, idle share and host time by
    operator of ``run`` (``steps`` steps ending in a device sync)."""
    run()
    t0 = time.perf_counter()
    run()
    step_ms = (time.perf_counter() - t0) / steps * 1e3

    _, dev, busy_ms, window_ms = trace(run, [ProfilerActivity.CUDA])
    events, _, host_busy_ms, host_window_ms = trace(
        run, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events),
                  key=lambda r: -r[1])
    summary = dict(
        label=label, steps=steps, step_ms=step_ms,
        profiled_window_ms=window_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / window_ms,
        host_traced_window_ms=host_window_ms,
        host_traced_idle_share=1.0 - host_busy_ms / host_window_ms,
        device_by_kernel=[dict(name=n, ms=ms, calls=c) for n, ms, c in dev[:TOP]],
        host_by_op=[dict(name=n, ms=ms, calls=c) for n, ms, c in host[:TOP]])
    print(f"{label}: step {step_ms:.3f} ms unprofiled; device-traced "
          f"window {window_ms:.3f} ms over {steps} steps, device busy {busy_ms:.3f} ms, "
          f"idle share {summary['device_idle_share']:.4f}; host-traced window "
          f"{host_window_ms:.3f} ms, idle share {summary['host_traced_idle_share']:.4f}")
    print("device time by kernel (ms over the device-traced window, calls):")
    for n, ms, c in dev[:TOP]:
        print(f"  {ms:10.3f}  {c:6d}  {n[:110]}")
    print("host self time by operator (ms over the host-traced window, calls):")
    for n, ms, c in host[:TOP]:
        print(f"  {ms:10.3f}  {c:6d}  {n[:110]}")
    return summary


def block_cache_passes(params_fn):
    """The refresh and the cached step of ``llada-moe-7b`` at the decode
    cell's shape (block 0 of a fresh sequence), ``STEPS`` calls each, and
    the device ms of the kernels of one call of the cached step's attention
    on its inputs."""
    from ct_diffusionmodelbench_tpu_torch.models import block_cache

    cfg = get_config("llada-moe-7b")
    params = params_fn(cfg)
    refresh_fn, step_fn, _ = block_cache.make_cached_fns(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    prompt = torch.randint(10, 100000, (BATCH, PROMPT), generator=gen, device="cuda")
    x = torch.cat([prompt, torch.full((BATCH, GEN), cfg.mask_token_id, device="cuda",
                                      dtype=prompt.dtype)], dim=1)
    blk = x[:, PROMPT:PROMPT + BLOCK]
    inputs = []
    plain = block_cache.attention_reference

    def recording(*a, **kw):
        inputs.append((a, kw))
        return plain(*a, **kw)

    with torch.inference_mode():
        _, kc, vc = refresh_fn(params, x, None, PROMPT, BLOCK)
        block_cache.attention_reference = recording
        try:
            step_fn(params, blk, PROMPT, kc, vc, None)
        finally:
            block_cache.attention_reference = plain

    @torch.inference_mode()
    def refresh():
        for _ in range(STEPS):
            refresh_fn(params, x, None, PROMPT, BLOCK)
        torch.cuda.synchronize()

    @torch.inference_mode()
    def cached():
        for _ in range(STEPS):
            step_fn(params, blk, PROMPT, kc, vc, None)
        torch.cuda.synchronize()

    @torch.inference_mode()
    def attention_ms(iters=50):
        """Device time, not the wall: launched back to back, the plain
        attention's small ops are bound by the host."""
        a, kw = inputs[1]

        def run():
            for _ in range(iters):
                plain(*a, **kw)
            torch.cuda.synchronize()

        run()
        return trace(run, [ProfilerActivity.CUDA])[2] / iters

    return refresh, cached, attention_ms, cfg.num_layers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="JSON summary path")
    ap.add_argument("--cell", choices=["decode", "chat", "dream", "block-cache"],
                    default="decode")
    ap.add_argument("--quant", choices=["int8"], default=None)
    args = ap.parse_args(argv)

    def params_fn(cfg):
        return init_params(cfg, seed=0, leaf_transform=(
            quantized_leaf_transform if args.quant else None))

    passes = []
    if args.cell == "decode":
        cfg = get_config("llada-moe-7b")
        params = params_fn(cfg)
        fwd = make_forward_fn(cfg)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        prompt = torch.randint(10, 100000, (BATCH, PROMPT), generator=gen, device="cuda")
        kw = dict(steps=STEPS, gen_length=GEN, block_length=BLOCK,
                  mask_id=cfg.mask_token_id)

        def run():
            llada_generate(fwd, params, prompt, **kw)
            torch.cuda.synchronize()

        passes.append(("decode", run, STEPS))
    elif args.cell == "block-cache":
        refresh, cached, attention_ms, layers = block_cache_passes(params_fn)
        passes += [("refresh", refresh, STEPS), ("cached step", cached, STEPS)]
    else:
        chat = args.cell == "chat"
        os.environ["CTDB_FLASH_DIRECT"] = "1"
        if chat:
            os.environ["CTDB_GROUPED_FUSED"] = "1"
            steps = CHAT_GEN // BLOCK
            kw = dict(steps=steps, block_length=BLOCK)
        else:
            steps = 8
            kw = dict(steps=steps, alg="entropy")
        runner = ModelRunner.random_init("llada-moe-7b" if chat else "dream-7b",
                                         quant=args.quant)
        text = runner.tokenizer.apply_chat_template(
            [{"role": "system", "content": build_system(True)},
             {"role": "user", "content": CHAT_PROMPT}])

        def run():
            runner.generate(text, gen_length=CHAT_GEN, temperature=0.0, **kw)
            torch.cuda.synchronize()

        passes.append((args.cell, run, steps))

    card = card_line()
    print(card)
    summary = dict(card=card, cell=args.cell, quant=args.quant,
                   passes=[breakdown(*p) for p in passes])
    if args.cell == "block-cache":
        step = summary["passes"][1]
        ms = attention_ms() * layers
        busy = step["device_busy_ms"] / step["steps"]
        summary["cached_attention"] = dict(device_ms_per_step=ms,
                                           share_of_device_busy=ms / busy)
        print(f"cached step's attention (attention_reference, {layers} layers, its "
              f"kernels traced alone): {ms:.3f} ms of device time a step, {ms / busy:.4f} "
              f"of the step's device busy time ({busy:.3f} ms)")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
