"""Where a training step's time goes on the card.

    python -m ct_diffusionmodelbench_tpu_torch.profile_train [--out FILE]

Runs the training slice's step (``llada-8b`` at full width cut to 8
layers, random weights; seq 2048, micro-batch 1, grad-accum 4, prompt 64,
remat, CE chunk 512, AdamW) through ``make_train_step``: one step to warm
up, two timed unprofiled, one under ``torch.profiler`` tracing the device
only, for the device time by kernel, by kernel family and the idle share
of that same window.  Writes the same as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity

from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
from ct_diffusionmodelbench_tpu_torch.profile_decode import TOP, card_line, trace
from ct_diffusionmodelbench_tpu_torch.train.trainer import (
    TrainConfig, make_optimizer, make_train_step)

LAYERS, SEQ, ACCUM, PROMPT = 8, 2048, 4, 64
# Kernel-name fragments of each family, first match wins.
FAMILIES = [("flash forward", ("flash_fwd_kernel",)),
            ("flash backward dq", ("flash_bwd_dq_kernel",)),
            ("flash backward dkv", ("flash_bwd_dkv_kernel",)),
            ("cuBLAS products", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
            ("embedding backward", ("embedding",)),
            ("everything else", ("",))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="JSON summary path")
    args = ap.parse_args(argv)

    cfg = get_config("llada-8b").replace(num_layers=LAYERS)
    params = init_params(cfg, seed=0)
    tcfg = TrainConfig(grad_accum=ACCUM, batch_size=1, max_length=SEQ,
                       remat=True, ce_chunk=512)
    opt, _ = make_optimizer(tcfg, total_steps=100)
    state = opt.init(params)
    step, _ = make_train_step(cfg, tcfg, opt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.randint(10, 100000, (ACCUM, 1, SEQ), generator=gen, device="cuda")
    plens = torch.full((ACCUM, 1), PROMPT, device="cuda")

    def run():
        nonlocal params, state
        params, state, _ = step(params, state, ids, plens, gen)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    for _ in range(2):
        run()
    step_ms = (time.perf_counter() - t0) / 2 * 1e3
    _, dev, busy_ms, window_ms = trace(run, [ProfilerActivity.CUDA])
    families = {name: [0.0, 0] for name, _ in FAMILIES}
    for kernel, ms, calls in dev:
        name = next(n for n, frags in FAMILIES if any(f in kernel for f in frags))
        families[name][0] += ms
        families[name][1] += calls
    summary = dict(
        card=card_line(), step_ms=step_ms, profiled_window_ms=window_ms,
        device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / window_ms,
        by_family=[dict(name=n, ms=ms, calls=c) for n, (ms, c) in families.items()],
        device_by_kernel=[dict(name=n, ms=ms, calls=c) for n, ms, c in dev[:TOP]])
    print(f"{summary['card']}: step {step_ms:.3f} ms unprofiled; device-traced "
          f"step {window_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{summary['device_idle_share']:.4f}")
    print("device time by family (ms in the traced step, kernel calls):")
    for n, (ms, c) in families.items():
        print(f"  {ms:10.3f}  {c:6d}  {n}")
    print("device time by kernel (ms in the traced step, calls):")
    for n, ms, c in dev[:TOP]:
        print(f"  {ms:10.3f}  {c:6d}  {n[:110]}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
