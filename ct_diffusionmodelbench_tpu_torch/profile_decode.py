"""Where a denoise step's time goes on the card.

    python -m ct_diffusionmodelbench_tpu_torch.profile_decode [--cell decode|chat|dream]
        [--quant int8] [--out FILE]

``--cell decode`` (the default) runs the main path's step shape
(``llada-moe-7b``, random weights, batch 8, prompt 64, gen 256, block 32,
greedy) for 8 steps (one per block: each step is a full forward at S = 320
with the LM head on the 32-token block, as in the 128-step run).  ``--cell
chat`` runs the single-prompt chat shape through ``ModelRunner.generate``
(``llada-moe-7b``, B 1, the chat template around the Lean-only system
prompt bucketed to 384 tokens, gen 128, block 32: 4 steps, one per block)
with ``CTDB_GROUPED_FUSED=1`` and ``CTDB_FLASH_DIRECT=1``; ``--cell dream``
the same prompt through ``dream-7b`` (gen 128, greedy, entropy, 8 steps,
each the work of one of the 128) with ``CTDB_FLASH_DIRECT=1``.  Each cell
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
    device busy ms, window ms)."""
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = sorted(((e.key, _kernel_us(e) / 1e3, e.count) for e in events
                  if _kernel_us(e) > 0), key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in dev)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return events, dev, busy_ms, window_ms


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="JSON summary path")
    ap.add_argument("--cell", choices=["decode", "chat", "dream"], default="decode")
    ap.add_argument("--quant", choices=["int8"], default=None)
    args = ap.parse_args(argv)

    if args.cell == "decode":
        steps = STEPS
        cfg = get_config("llada-moe-7b")
        params = init_params(cfg, seed=0, leaf_transform=(
            quantized_leaf_transform if args.quant else None))
        fwd = make_forward_fn(cfg)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        prompt = torch.randint(10, 100000, (BATCH, PROMPT), generator=gen, device="cuda")
        kw = dict(steps=steps, gen_length=GEN, block_length=BLOCK,
                  mask_id=cfg.mask_token_id)

        def run():
            llada_generate(fwd, params, prompt, **kw)
            torch.cuda.synchronize()
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
        card=card_line(), cell=args.cell, quant=args.quant, steps=steps, step_ms=step_ms,
        profiled_window_ms=window_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / window_ms,
        host_traced_window_ms=host_window_ms,
        host_traced_idle_share=1.0 - host_busy_ms / host_window_ms,
        device_by_kernel=[dict(name=n, ms=ms, calls=c) for n, ms, c in dev[:TOP]],
        host_by_op=[dict(name=n, ms=ms, calls=c) for n, ms, c in host[:TOP]])
    print(f"{summary['card']}: step {step_ms:.3f} ms unprofiled; device-traced "
          f"window {window_ms:.3f} ms over {steps} steps, device busy {busy_ms:.3f} ms, "
          f"idle share {summary['device_idle_share']:.4f}; host-traced window "
          f"{host_window_ms:.3f} ms, idle share {summary['host_traced_idle_share']:.4f}")
    print("device time by kernel (ms over the device-traced window, calls):")
    for n, ms, c in dev[:TOP]:
        print(f"  {ms:10.3f}  {c:6d}  {n[:110]}")
    print("host self time by operator (ms over the host-traced window, calls):")
    for n, ms, c in host[:TOP]:
        print(f"  {ms:10.3f}  {c:6d}  {n[:110]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
