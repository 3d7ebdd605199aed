"""Perf sweep: the port's sub-benchmarks beside the headline, one JSON file.

    python -m ct_diffusionmodelbench_tpu_torch.bench_sweep [--only a,b]
        [--out build/bench_sweep.json] [--device cpu]

Counterpart of the root ``bench_sweep.py``.  Sections, under the
reference's names:

- ``attention_crossover``: the flash forward (K8, RoPE fused) against the
  reference attention (RoPE applied first) at 32 heads, Dh 128, bf16, B 1
  at S 320…4096 and B 8 at S 320…1024.  The card's check of the port's
  choice to take K8 at every shape (``ops/attention.py``, ``impl="auto"``);
  the reference's TPU threshold does not carry over.
- ``grouped_gemm``: ``grouped_expert_ffn`` on the kernels (K1/K2) against
  the same function through ``ops/grouped_gemm.py::grouped_mm``
  (``torch._grouped_mm`` on the card, the counterpart of the reference's
  ``ragged`` backend; a yardstick the port's forward never calls) at the
  ``llada-moe-7b`` routing shape.
- ``dream_reference_config``: full-size ``dream-7b`` at the reference's
  Dream / DiffuCoder configuration (256 steps, temp 0.4, top_p 0.95,
  entropy), B 1 and B 4, with the on-chip companion.
- ``sft_train_step``, ``sft_train_step_int8_adam``: the reference's SFT
  rows through ``make_optimizer`` / ``make_train_step``: ``llada-2b`` cut to
  6 layers with f32 Adam, and full ``llada-2b`` with int8 moments and bf16
  accumulation; A 4, B 1, L 2048, remat.
- ``sft_train_step_moe``: ``llada-moe-7b`` with int8 moments, each rung of
  a depth ladder in its own process, from the preset's full 18 layers down.
- ``llada_8b_int8_single_chip``: ``llada-8b`` with int8 weights, 256 steps,
  gen 256, block 32, B 1 and B 4, with the on-chip companion.

Every section takes its configuration and shape as arguments (the
reference's values by default).  Ops are timed with CUDA events around a
chain of ``iters`` calls, each call's output feeding the next call's first
argument (host clock on the CPU).  The on-chip companion is
``utils/profiling.py::onchip_device_seconds``.  A section that raises
records ``{"error": ...}``; the sweep goes on, writes its file and exits 1.

Left out of the reference's: ``sft_train_step_moe_max``, which exists only
to show the depth that ``CTDB_RAGGED_NT`` (a memory saver against XLA
hoisting the experts' transposes) buys on a 16 GB chip; the port has no
such switch.  Also the pool mechanics: the retry of a failed section after
a 150 s sleep and the sleeps between ladder rungs.  The output never
defaults to ``PERF.json``, the reference's artifact.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.device import resolve_device
from ct_diffusionmodelbench_tpu_torch.utils.profiling import leaves, onchip_device_seconds, sync

DREAM_BASELINE_SEC = 49.61       # model_performance.md:4 (256 steps, GH200)
DIFFUCODER_BASELINE_SEC = 8.02   # model_performance.md:3 (same interface)

DEFAULT_OUT = "build/bench_sweep.json"
# Depths of the MoE SFT ladder, deepest first: the full preset trains on one
# 80 GB card (PERF.md §5), the rest are rungs below it.
MOE_LADDER = (18, 12, 6, 2)
MOE_RUNG_TIMEOUT_S = 1800


def _peak() -> float:
    """bf16 peak FLOP/s of the card (``bench.py``'s table; NaN off it)."""
    from ct_diffusionmodelbench_tpu_torch.bench import chip_peak_tflops

    dev = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")
    return chip_peak_tflops(dev)[1] * 1e12


def _ratio(v: float, digits: int = 4) -> Optional[float]:
    return round(v, digits) if math.isfinite(v) else None


def _t(call, reps: int = 3) -> float:
    """Median wall seconds of ``call()`` (which ends in a device sync),
    after one warm-up."""
    call()
    ts = []
    for _ in range(reps):
        t0 = time.time()
        call()
        ts.append(time.time() - t0)
    return float(statistics.median(ts))


def time_loop(fn, args, iters: int = 16, reps: int = 3) -> float:
    """Seconds per call of ``fn(*args)`` chained ``iters`` times (output
    feeds argument 0, cast to its dtype), median of ``reps`` chains after
    one warm chain: CUDA events on the card, the host clock on the CPU."""
    dev = args[0].device

    def chain():
        c = args
        for _ in range(iters):
            out = fn(*c)
            c = (out.to(c[0].dtype),) + tuple(c[1:])
        return c[0]

    with torch.inference_mode():
        chain()
        ts = []
        for _ in range(reps):
            if dev.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                chain()
                end.record()
                torch.cuda.synchronize(dev)
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                chain()
                ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts)) / iters


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _seeded(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def attention_crossover(shapes=((1, (320, 512, 1024, 2048, 4096)), (8, (320, 512, 1024))),
                        heads: int = 32, head_dim: int = 128, dtype=torch.bfloat16,
                        iters: Optional[int] = None, reps: int = 3, device=None):
    """K8 (``impl="flash"``, RoPE in the kernel) against the reference
    attention (``impl="reference"``, RoPE applied first), one row a shape."""
    from ct_diffusionmodelbench_tpu_torch.models.layers import rope_angles
    from ct_diffusionmodelbench_tpu_torch.ops.attention import attention

    dev = resolve_device(device)
    rows = []
    for B, seqs in shapes:
        for S in seqs:
            gen = _seeded(dev, S)
            q, k, v = (torch.randn((B, S, heads, head_dim), generator=gen, device=dev,
                                   dtype=dtype) for _ in range(3))
            pos = torch.arange(S, device=dev)[None].expand(B, S)
            rope = rope_angles(pos, head_dim, 500000.0)
            n = iters or max(4, 2048 // max(B * S // 512, 1))
            t_ref = time_loop(lambda q_, k_, v_: attention(q_, k_, v_, impl="reference",
                                                           rope=rope), (q, k, v), n, reps)
            t_fl = time_loop(lambda q_, k_, v_: attention(q_, k_, v_, impl="flash",
                                                          rope=rope), (q, k, v), n, reps)
            rows.append({
                "batch": B,
                "seq_len": S,
                "includes_rope": True,
                "score_work_bhs2": B * heads * S * S,
                "reference_ms": round(t_ref * 1e3, 3),
                "flash_ms": round(t_fl * 1e3, 3),
                "flash_speedup": round(t_ref / t_fl, 2),
            })
            del q, k, v
    return rows


def grouped_mm_ffn(x, probs, idx, wg, wu, wd):
    """The routed expert FFN through :func:`grouped_mm` on the kernels'
    padded layout: gate and up rounded to x's dtype, SiLU·up in f32."""
    from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm import grouped_mm
    from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm_cuda import (
        _round_up, combine, counting_layout, gather_rows, layout_tile_m)

    n, k = idx.shape
    tile_m = layout_tile_m(n * k)
    dest, _, sizes, m_pad = counting_layout(idx, wg.shape[0], tile_m)
    offs = torch.cumsum(_round_up(sizes, tile_m), 0, dtype=torch.int32)
    offs[-1] = m_pad   # the tail rows belong to the last expert
    xs = gather_rows(x, dest, k, m_pad)
    gate = grouped_mm(xs, wg, offs)
    up = grouped_mm(xs, wu, offs)
    h = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
    return combine(grouped_mm(h, wd, offs), dest, probs, n, k, x.dtype)


def grouped_gemm(N: int = 2048, K: int = 8, E: int = 64, D: int = 2048, Fm: int = 896,
                 dtype=torch.bfloat16, iters: int = 8, reps: int = 3, device=None):
    """``grouped_expert_ffn`` (K1/K2 on the card) against
    :func:`grouped_mm_ffn` at one routing."""
    from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm import grouped_expert_ffn

    dev = resolve_device(device)
    gen = _seeded(dev, 0)
    x = torch.randn((N, D), generator=gen, device=dev, dtype=dtype)
    probs = torch.softmax(torch.randn((N, K), generator=gen, device=dev), -1)
    idx = torch.randint(0, E, (N, K), generator=gen, device=dev)
    wg, wu = (torch.randn((E, D, Fm), generator=gen, device=dev, dtype=dtype) * 0.02
              for _ in range(2))
    wd = torch.randn((E, Fm, D), generator=gen, device=dev, dtype=dtype) * 0.02
    args = (x, probs, idx, wg, wu, wd)
    t_mm = time_loop(grouped_mm_ffn, args, iters, reps)
    t_k = time_loop(grouped_expert_ffn, args, iters, reps)
    return {
        "grouped_mm_ms": round(t_mm * 1e3, 3),
        "kernel_ms": round(t_k * 1e3, 3),
        "kernel_speedup": round(t_mm / t_k, 2),
        "shape": f"N={N} K={K} E={E} D={D} Fm={Fm} {str(dtype).split('.')[-1]}",
    }


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def dream_reference_config(cfg=None, steps: int = 256, gen_length: int = 256,
                           prompt_len: int = 64, batch: int = 4, reps: int = 2,
                           device=None):
    """Dream's reference configuration at B 1 and B ``batch``."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.sampling import dream_generate

    dev = resolve_device(device)
    cfg = cfg or get_config("dream-7b")
    params = init_params(cfg, seed=0, device=dev)
    fwd = make_forward_fn(cfg, dev)
    kw = dict(steps=steps, max_new_tokens=gen_length, temperature=0.4, top_p=0.95,
              alg="entropy", mask_id=cfg.mask_token_id, device=dev)
    hi = min(cfg.vocab_size - 10, 100_000)

    def call(b):
        prompt = torch.randint(10, hi, (b, prompt_len), generator=torch.Generator().manual_seed(1))
        return lambda: sync(dream_generate(fwd, params, prompt, generator=_seeded(dev, 2),
                                           **kw)[0])

    dt1 = _t(call(1), reps)
    dtb = _t(call(batch), reps)
    oc = onchip_device_seconds(call(batch))
    del params
    _free()
    # Every step computes every position's logits (no block-sliced head).
    flops_per_sample = steps * cfg.forward_flops(prompt_len + gen_length)
    row = {
        "model": _label(cfg, "dream-7b", "full size"),
        "params_total_b": round(cfg.param_count() / 1e9, 2),
        "params_active_b": round(cfg.active_param_count() / 1e9, 2),
        "config": f"{steps} steps, temp 0.4, top_p 0.95, alg=entropy, gen {gen_length}",
        "single_sample_sec": round(dt1, 3),
        "batched_sec_per_sample": round(dtb / batch, 3),
        "batch": batch,
        "mfu": _ratio(batch * flops_per_sample / dtb / _peak()),
        "mfu_single": _ratio(flops_per_sample / dt1 / _peak()),
        "vs_dream_baseline_49.61s": round(DREAM_BASELINE_SEC / (dtb / batch), 1),
        "vs_diffucoder_baseline_8.02s": round(DIFFUCODER_BASELINE_SEC / (dtb / batch), 1),
    }
    if oc:
        row["onchip_seconds_per_batch"] = round(oc, 3)
        row["onchip_sec_per_sample"] = round(oc / batch, 3)
        row["mfu_onchip"] = _ratio(batch * flops_per_sample / oc / _peak())
    return row


def llada_8b_int8_single_chip(cfg=None, steps: int = 256, gen_length: int = 256,
                              block_length: int = 32, prompt_len: int = 64,
                              batch: int = 4, reps: int = 2, device=None):
    """The north star's own model on one card with int8 weights
    (``quantized_leaf_transform``: each weight quantized as it is built)."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.ops.quant import quantized_leaf_transform
    from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate

    dev = resolve_device(device)
    cfg = cfg or get_config("llada-8b")
    params = init_params(cfg, seed=0, device=dev, leaf_transform=quantized_leaf_transform)
    fwd = make_forward_fn(cfg, dev)

    def call(b):
        prompt = torch.full((b, prompt_len), 17, dtype=torch.long)
        return lambda: sync(llada_generate(
            fwd, params, prompt, steps=steps, gen_length=gen_length,
            block_length=block_length, mask_id=cfg.mask_token_id,
            generator=_seeded(dev, 2), device=dev))

    dt1 = _t(call(1), reps)
    dtb = _t(call(batch), reps)
    oc = onchip_device_seconds(call(batch))
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    del params
    _free()
    # The sampler computes logits only for the active block.
    flops_per_sample = steps * cfg.forward_flops(prompt_len + gen_length,
                                                 lm_head_width=block_length)
    row = {
        "model": _label(cfg, "llada-8b", "full size, int8 weight-only, ONE chip"),
        "params_total_b": round(cfg.param_count() / 1e9, 2),
        "weights_gb": round(nbytes / 1e9, 2),
        "config": f"gen {gen_length}, {steps} steps, block {block_length} "
                  "(north-star reference config)",
        "single_sample_sec": round(dt1, 3),
        "batched_sec_per_sample": round(dtb / batch, 3),
        "batch": batch,
        "tok_per_sec_per_chip": round(gen_length * batch / dtb, 1),
        "mfu": _ratio(batch * flops_per_sample / dtb / _peak()),
        "baseline_note": "no vs_* ratio: the reference has no committed "
                         "dense-LLaDA-8B generation benchmark "
                         "(model_performance.md:3-5 covers MoE/Dream/"
                         "DiffuCoder only)",
        "note": "random-init weights; int8 is opt-in (--quant int8) and "
                "approximate; bf16 llada-8b fits the card whole (entry.py)",
    }
    if oc:
        row["onchip_seconds_per_batch"] = round(oc, 3)
        row["onchip_sec_per_sample"] = round(oc / batch, 3)
        row["mfu_onchip"] = _ratio(batch * flops_per_sample / oc / _peak())
    return row


def _label(cfg, preset: str, note: str) -> str:
    """The row's model name, with ``note`` when it is the full preset."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config

    return f"{cfg.name} ({note})" if cfg == get_config(preset) else cfg.name


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _measure_train_step(cfg, tcfg, *, A=4, B=1, L=2048, reps=3, device=None):
    """(median seconds a step after one warm step, parameter count, the
    on-chip seconds of one more step)."""
    from ct_diffusionmodelbench_tpu_torch.models import init_params
    from ct_diffusionmodelbench_tpu_torch.train.trainer import make_optimizer, make_train_step

    dev = resolve_device(device)
    params = init_params(cfg, seed=0, device=dev)
    optimizer, _ = make_optimizer(tcfg, total_steps=100)
    state = {"params": params, "opt": optimizer.init(params)}
    step, _ = make_train_step(cfg, tcfg, optimizer, dev)
    ids = torch.randint(10, min(100_000, cfg.vocab_size - 10), (A, B, L),
                        generator=torch.Generator().manual_seed(1))
    plens = torch.full((A, B), min(64, L // 2))

    def run():
        state["params"], state["opt"], m = step(state["params"], state["opt"], ids,
                                                plens, _seeded(dev, 2))
        float(m["loss"])   # waits for the step

    run()
    ts = []
    for _ in range(reps):
        t0 = time.time()
        run()
        ts.append(time.time() - t0)
    oc = onchip_device_seconds(run)
    nparams = sum(t.numel() for t in leaves(state["params"]))
    del state, params
    _free()
    return float(statistics.median(ts)), nparams, oc


def _sft_row(cfg, tcfg, label, *, A=4, B=1, L=2048, device=None):
    dt, nparams, oc = _measure_train_step(cfg, tcfg, A=A, B=B, L=L, device=device)
    # fwd+bwd ≈ 6 · active params · tokens (MoE: routed + shared experts).
    flops = 6 * cfg.active_param_count() * A * B * L
    row = {
        "model": label,
        "params_total_b": round(cfg.param_count() / 1e9, 2),
        "params_active_b": round(cfg.active_param_count() / 1e9, 2),
        "optimizer_state_dtype": tcfg.optimizer_state_dtype,
        "grad_accum_dtype": tcfg.grad_accum_dtype,
        "seq_len": L, "effective_batch": A * B,
        "seconds_per_step": round(dt, 3),
        "samples_per_second_per_chip": round(A * B / dt, 3),
        "tokens_per_second_per_chip": round(A * B * L / dt, 1),
        "train_mfu": _ratio(flops / dt / _peak()),
        # Model-FLOPs MFU (6·P·T).  remat recomputes the forward in the
        # backward, so the card executes ≈ 8·P·T.
        "hardware_util_with_remat": (
            _ratio(flops * 8 / 6 / dt / _peak()) if tcfg.remat else None),
        "reference": "4.873 samples/s = 0.609/GPU for 8B SFT on 8x GH200 "
                     "(NOV8_1kto21k training_metrics.json)",
    }
    if oc:
        row["onchip_seconds_per_step"] = round(oc, 3)
        row["train_mfu_onchip"] = _ratio(flops / oc / _peak())
    return row


def _sft_config(A, B, L, **kw):
    from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(learning_rate=5e-5, grad_accum=A, batch_size=B, max_length=L,
                       remat=True, **kw)


def sft_train_step(cfg=None, A: int = 4, B: int = 1, L: int = 2048, device=None):
    """Dense SFT with f32 Adam: ``llada-2b`` cut to 6 layers (the
    reference's largest dense fit with f32 Adam on its chip)."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config

    cfg = cfg or get_config("llada-2b").replace(num_layers=6)
    return _sft_row(cfg, _sft_config(A, B, L), f"{cfg.name} arch, {cfg.num_layers} "
                    f"layers ({cfg.param_count() / 1e9:.2f}B, f32 Adam)",
                    A=A, B=B, L=L, device=device)


def sft_train_step_int8_adam(cfg=None, A: int = 4, B: int = 1, L: int = 2048, device=None):
    """The whole ``llada-2b`` with int8 Adam moments and bf16
    accumulation (the reference's optimizer-state row)."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config

    cfg = cfg or get_config("llada-2b")
    tcfg = _sft_config(A, B, L, optimizer_state_dtype="int8", grad_accum_dtype="bfloat16")
    return _sft_row(cfg, tcfg, f"{cfg.name} FULL {cfg.num_layers} layers "
                    f"({cfg.param_count() / 1e9:.2f}B, int8 Adam moments)",
                    A=A, B=B, L=L, device=device)


def moe_rung(cfg_fields: dict, layers: int, A: int, B: int, L: int, device=None):
    """One rung of the MoE ladder: the preset cut to ``layers``, int8
    moments, bf16 accumulation, remat."""
    from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(**cfg_fields).replace(num_layers=layers)
    tcfg = _sft_config(A, B, L, optimizer_state_dtype="int8", grad_accum_dtype="bfloat16")
    return _sft_row(cfg, tcfg, f"{cfg.name} arch, {layers} layers "
                    f"({cfg.param_count() / 1e9:.2f}B total / "
                    f"{cfg.active_param_count() / 1e9:.2f}B active, int8 Adam)",
                    A=A, B=B, L=L, device=device)


def sft_train_step_moe(cfg=None, ladder=MOE_LADDER, A: int = 4, B: int = 1, L: int = 2048,
                       device=None):
    """The deepest rung of ``ladder`` that trains, each rung in a process
    of its own (a rung that runs the card out of memory leaves its process's
    allocator fragmented; the next rung starts clean)."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config

    resolve_device(device)   # no rung starts without the device it needs
    cfg = cfg or get_config("llada-moe-7b")
    rung = dict(cfg_fields=dataclasses.asdict(cfg), A=A, B=B, L=L, device=device)
    failed, last = [], None
    for layers in ladder:
        with tempfile.TemporaryDirectory(prefix="ctdb-moe-rung-") as tmp:
            out = Path(tmp) / "rung.json"
            cmd = [sys.executable, "-m", "ct_diffusionmodelbench_tpu_torch.bench_sweep",
                   "--moe-rung", json.dumps(dict(rung, layers=layers)), "--out", str(out)]
            try:
                run = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=MOE_RUNG_TIMEOUT_S)
                row = json.loads(out.read_text()) if out.exists() else {
                    "error": (run.stderr.strip().splitlines() or ["no output"])[-1][-300:]}
            except subprocess.TimeoutExpired:
                row = {"error": f"rung timed out after {MOE_RUNG_TIMEOUT_S} s"}
        if "error" not in row:
            if failed:
                row["deeper_rungs_failed"] = failed
            return row
        failed.append(layers)
        last = row
    raise RuntimeError(f"every MoE depth failed {failed}: {last}")


SECTIONS = {
    "attention_crossover": attention_crossover,
    "grouped_gemm": grouped_gemm,
    "dream_reference_config": dream_reference_config,
    "sft_train_step": sft_train_step,
    "sft_train_step_int8_adam": sft_train_step_int8_adam,
    "sft_train_step_moe": sft_train_step_moe,
    "llada_8b_int8_single_chip": llada_8b_int8_single_chip,
}


def sweep(only=None, device=None, out: Optional[Path] = None) -> dict:
    """Run the sections (``only``: their names), writing the ledger to
    ``out`` after each."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ledger = {"chip_kind": kind}
    for name, fn in SECTIONS.items():
        if only is not None and name not in only:
            continue
        t0 = time.time()
        try:
            ledger[name] = fn(device=device)
        except Exception as e:  # recorded; the sweep goes on and fails at the end
            ledger[name] = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
        _free()
        print(f"[bench_sweep] {name}: {time.time() - t0:.1f} s", file=sys.stderr, flush=True)
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(ledger, indent=2))
    return ledger


def erred(ledger: dict) -> list:
    return [k for k, v in ledger.items() if isinstance(v, dict) and "error" in v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated section names (default: all)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the ledger's JSON path")
    ap.add_argument("--device", default=None, help="'cpu' for a CPU run; default: the card")
    ap.add_argument("--moe-rung", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    out = Path(args.out)
    if args.moe_rung is not None:   # one rung of sft_train_step_moe, in its own process
        try:
            row = moe_rung(**json.loads(args.moe_rung))
        except Exception as e:  # the parent reads the error and tries the next rung
            row = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
        out.write_text(json.dumps(row))
        return 0
    only = set(args.only.split(",")) if args.only else None
    unknown = (only or set()) - set(SECTIONS)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}; have {sorted(SECTIONS)}")
    ledger = sweep(only, args.device, out)
    print(json.dumps(ledger))
    bad = erred(ledger)
    if bad:
        print(f"[bench_sweep] sections that failed: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
