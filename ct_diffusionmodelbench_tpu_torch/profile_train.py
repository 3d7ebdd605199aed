"""Where a training step's time goes on the card.

    python -m ct_diffusionmodelbench_tpu_torch.profile_train [--cell dense|moe] [--out FILE]

``--cell dense`` (the default) runs the training slice's step (``llada-8b``
at full width cut to 8 layers, random weights; seq 2048, micro-batch 1,
grad-accum 4, prompt 64, remat, CE chunk 512, AdamW) through
``make_train_step``.  ``--cell moe`` runs the MoE training slice's step:
full-size ``llada-moe-7b`` (18 layers), int8 moments, bf16 accumulation,
remat, the same shape.  Each: one step to warm up, two timed unprofiled,
one under ``torch.profiler`` tracing the device only, for the device time
by kernel, by kernel family, the device busy time (the union of the
device intervals, ``profile_decode.trace``) and the idle share of that
same window.  The MoE cell also times one step by phase with CUDA events around the forward,
the backward, the grouped FFN's backward inside it and the optimizer
update (device-clock spans, summed over the micro-batches), and times a
step with ``attn_impl="reference"`` against the flash kernels, in turns.
Writes the same as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity

from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm
from ct_diffusionmodelbench_tpu_torch.profile_decode import TOP, card_line, trace
from ct_diffusionmodelbench_tpu_torch.train import trainer as trainer_mod
from ct_diffusionmodelbench_tpu_torch.train.trainer import (
    TrainConfig, make_optimizer, make_train_step)

LAYERS, SEQ, ACCUM, PROMPT = 8, 2048, 4, 64
# Kernel-name fragments of each family, first match wins.
FAMILIES = [("flash forward", ("flash_fwd_kernel",)),
            ("flash backward dq", ("flash_bwd_dq_kernel",)),
            ("flash backward dkv", ("flash_bwd_dkv_kernel",)),
            ("grouped gate/up and down (K1 / K2)", ("grouped_gemm_kernel",)),
            ("torch._grouped_mm (grouped FFN backward)", ("GroupProblemShape", "Grouped",
                                                          "grouped")),
            ("cuBLAS products", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
            ("embedding backward", ("embedding",)),
            ("everything else", ("",))]
TURNS = 3


class PhaseClock:
    """Device-clock spans of named phases: CUDA events recorded on the
    current stream around each call, summed after a sync."""

    def __init__(self):
        self.spans = {}

    @contextmanager
    def span(self, name):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        try:
            yield
        finally:
            end.record()
            self.spans.setdefault(name, []).append((start, end))

    def wrap(self, name, fn):
        def timed(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return timed

    def read(self) -> dict:
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.spans.items()}


def by_phase(cfg, tcfg, params, state, opt, batch):
    """One step's device-clock spans by phase (ms)."""
    clock = PhaseClock()
    loss = trainer_mod.diffusion_sft_loss
    backward = torch.Tensor.backward
    ffn_backward = grouped_gemm.GroupedFFN.backward
    update = type(opt).update
    try:
        trainer_mod.diffusion_sft_loss = clock.wrap("forward", loss)
        torch.Tensor.backward = clock.wrap("backward", backward)
        grouped_gemm.GroupedFFN.backward = staticmethod(
            clock.wrap("grouped FFN backward (inside backward)", ffn_backward))
        type(opt).update = clock.wrap("optimizer update", update)
        step, _ = make_train_step(cfg, tcfg, opt)
        with clock.span("whole step"):
            step(params, state, *batch)
    finally:
        trainer_mod.diffusion_sft_loss = loss
        torch.Tensor.backward = backward
        grouped_gemm.GroupedFFN.backward = staticmethod(ffn_backward)
        type(opt).update = update
    return clock.read()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=["dense", "moe"], default="dense")
    ap.add_argument("--out", type=Path, default=None, help="JSON summary path")
    args = ap.parse_args(argv)

    if args.cell == "dense":
        cfg = get_config("llada-8b").replace(num_layers=LAYERS)
        tcfg = TrainConfig(grad_accum=ACCUM, batch_size=1, max_length=SEQ,
                           remat=True, ce_chunk=512)
    else:
        cfg = get_config("llada-moe-7b")
        tcfg = TrainConfig(grad_accum=ACCUM, batch_size=1, max_length=SEQ,
                           remat=True, ce_chunk=512, optimizer_state_dtype="int8",
                           grad_accum_dtype="bfloat16")
    params = init_params(cfg, seed=0)
    opt, _ = make_optimizer(tcfg, total_steps=100)
    state = opt.init(params)
    step, _ = make_train_step(cfg, tcfg, opt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    ids = torch.randint(10, 100000, (ACCUM, 1, SEQ), generator=gen, device="cuda")
    plens = torch.full((ACCUM, 1), PROMPT, device="cuda")

    def run(step_fn=step):
        nonlocal params, state
        params, state, _ = step_fn(params, state, ids, plens, gen)
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
        card=card_line(), cell=args.cell, layers=cfg.num_layers, step_ms=step_ms,
        profiled_window_ms=window_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / window_ms,
        by_family=[dict(name=n, ms=ms, calls=c) for n, (ms, c) in families.items()],
        device_by_kernel=[dict(name=n, ms=ms, calls=c) for n, ms, c in dev[:TOP]])
    print(f"{summary['card']}: {args.cell} cell, {cfg.num_layers} layers: step "
          f"{step_ms:.3f} ms unprofiled; device-traced step {window_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms, idle share {summary['device_idle_share']:.4f}")
    print("device time by family (ms in the traced step, kernel calls):")
    for n, (ms, c) in families.items():
        print(f"  {ms:10.3f}  {c:6d}  {n}")
    print("device time by kernel (ms in the traced step, calls):")
    for n, ms, c in dev[:TOP]:
        print(f"  {ms:10.3f}  {c:6d}  {n[:110]}")

    if args.cell == "moe":
        phases = by_phase(cfg, tcfg, params, state, opt, (ids, plens, gen))
        print("device-clock spans of one step by phase (ms, CUDA events):")
        for n, ms in phases.items():
            print(f"  {ms:10.3f}  {n}")
        ref_step, _ = make_train_step(cfg.replace(attn_impl="reference"), tcfg, opt)
        times = {"flash": [], "reference": []}
        run(ref_step)
        for _ in range(TURNS):
            for name, fn in (("flash", step), ("reference", ref_step)):
                t0 = time.perf_counter()
                run(fn)
                times[name].append((time.perf_counter() - t0) * 1e3)
        attention_ab = {n: statistics.median(t) for n, t in times.items()}
        serves = min(attention_ab, key=attention_ab.get)
        print(f"step ms by attention, in turns (medians of {TURNS}): flash "
              f"{attention_ab['flash']:.3f}, reference {attention_ab['reference']:.3f}: "
              f"{serves} serves MoE training")
        summary.update(phases_ms=phases, attention_step_ms=attention_ab,
                       attention_turns_ms=times, attention_serves=serves)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
