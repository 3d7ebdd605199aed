"""Headline benchmark of the port: denoised tokens/s on one card.

    python -m ct_diffusionmodelbench_tpu_torch.bench [--full] [--out PATH] [--device cpu]

Counterpart of the root ``bench.py``.  The headline model is full-size
``llada-moe-7b`` (random weights from seed 0) decoding with the exact LLaDA
sampler at the configuration behind the reference's 57.09 s/sample GH200
result: prompt 64, gen 256, steps 128, block 32, greedy low-confidence
remasking, batch 8 (model_performance.md:5, ≈ 4.48 denoised tok/s).  On
the card every step launches the flash forward (K8) and the grouped
gate/up and down kernels (K1, K2) once per layer.

Stdout carries exactly one JSON line, in the reference's schema:
``{"metric", "value", "unit", "vs_baseline", "config": {...,
"headline": {...}}}``; progress goes to stderr.  The value is the
wall-clock rate (B·gen / median seconds of a batched ``llada_generate``,
each rep ending in a device sync).  ``onchip_seconds_per_batch`` beside it
is the card's busy time of one warm call (``utils/profiling.py``'s union of
device intervals): against ``seconds_per_batch`` it gives the headline's
busy share.  A wall-clock budget (``CTDB_BENCH_BUDGET_S``, default 1200 s)
gates the extras (on-chip companion, single-sample latency).

``--full`` prints the same line, then measures batch 16 and 32, the
block-cache rows (with and without threshold 0.9) and the dense
``llada-2b`` sub-benchmark, and writes the whole result to ``--out``
(default ``build/bench_full.json``).  ``--device cpu`` runs the CPU smoke
shape (``llada-moe-tiny`` f32, 16 steps, batch 2, one rep).  Without a card
and without ``--device cpu`` the run fails.  A failure prints the error
line (same keys, ``value`` null, ``error`` the reason) and exits 1.

Left out of the reference's, as shared-TPU-pool mechanics: the backend
probes in subprocesses, the quiet-window wait, the allocator fallback to a
smaller MoE and its reclamation sleep, and the switch of the headline to
the on-chip number under contention (the card is not time-shared, so
``value_source`` is always ``"wall_clock"``).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import sys
import time
import traceback
from pathlib import Path

import torch

from ct_diffusionmodelbench_tpu_torch.device import resolve_device
from ct_diffusionmodelbench_tpu_torch.utils.profiling import onchip_device_seconds, sync

REFERENCE_DENOISED_TOK_PER_SEC = 256.0 / 57.09  # BASELINE.md, LLaDA-MoE on GH200

PROMPT_LEN = 64
GEN_LENGTH = 256
BLOCK_LENGTH = 32

# bf16 dense peak TFLOP/s per card by CUDA device name (NVIDIA data sheets;
# the SXM part at 700 W).  The longest matching prefix wins; an unknown card
# gives NaN and a null MFU.
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,   # H100 SXM
    "NVIDIA H100 PCIe": 756.0,
}

DEFAULT_OUT = "build/bench_full.json"


class Budget:
    """The run's wall-clock budget: the extras run only while it lasts."""

    def __init__(self, seconds: float):
        self.t0 = time.time()
        self.seconds = seconds
        self.deadline = self.t0 + seconds

    def remaining(self) -> float:
        return self.deadline - time.time()

    def elapsed(self) -> float:
        return time.time() - self.t0

    def log(self, msg: str) -> None:
        """Progress goes to stderr: stdout carries exactly one JSON line."""
        print(f"[bench +{self.elapsed():.0f}s] {msg}", file=sys.stderr, flush=True)


def emit_error_line(reason: str, budget: Budget) -> None:
    """The failure line: the metric's keys with ``value`` null."""
    result = {
        "metric": "denoised_tokens_per_sec_per_chip",
        "value": None,
        "unit": "tok/s/chip",
        "vs_baseline": None,
        "error": reason,
        "config": {
            "budget_s": round(budget.seconds, 1) if math.isfinite(budget.seconds) else None,
            "elapsed_s": round(budget.elapsed(), 1),
        },
    }
    print(json.dumps(result), flush=True)


def chip_peak_tflops(device: torch.device) -> tuple[str, float]:
    """(device name, bf16 peak TFLOP/s or NaN)."""
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    best = max((k for k in PEAK_BF16_TFLOPS if kind.startswith(k)), key=len, default=None)
    return kind, PEAK_BF16_TFLOPS[best] if best else float("nan")


def _sanity_matmul_ms(device: torch.device, chain: int = 32) -> float:
    """ms per product of a chain of 2048³ bf16 ``torch.mm``, one reading
    (CUDA events) after one warm chain."""
    gen = torch.Generator(device=device).manual_seed(9)
    x = torch.randn((2048, 2048), generator=gen, device=device, dtype=torch.bfloat16)
    x = x / 2048 ** 0.5   # keeps the chain's magnitudes steady

    def run():
        c = x
        for _ in range(chain):
            c = torch.mm(c, x)
        return c

    run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / chain


def prompt_ids(cfg, batch: int, seed: int = 1) -> torch.Tensor:
    """The bench prompt: [batch, PROMPT_LEN] ids in [10, hi) from a seeded
    host generator, never the mask id."""
    hi = min(cfg.vocab_size - 10, 100_000, cfg.mask_token_id)
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(10, hi, (batch, PROMPT_LEN), generator=gen)


def decode_kw(cfg, steps: int, cached_fns=None, parallel_threshold=None) -> dict:
    """``llada_generate``'s arguments at the bench configuration."""
    return dict(steps=steps, gen_length=GEN_LENGTH, block_length=BLOCK_LENGTH,
                temperature=0.0, mask_id=cfg.mask_token_id,
                block_cache=cached_fns is not None, cached_fns=cached_fns,
                parallel_threshold=parallel_threshold)


def decode(fwd, params, prompt: torch.Tensor, kw: dict, device) -> torch.Tensor:
    """One batched ``llada_generate``, ended by a device sync."""
    from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate

    out = llada_generate(fwd, params, prompt, device=device, **kw)
    sync(out)
    return out


def measure(cfg, params, fwd, *, steps, batch, reps, seed=1, cached_fns=None,
            parallel_threshold=None, device=None):
    """Median seconds per batched sampler call after one warm-up.

    ``cached_fns`` / ``parallel_threshold``: the block-cache and threshold
    decodes (``models/block_cache.py``) instead of the exact sampler."""
    kw = decode_kw(cfg, steps, cached_fns, parallel_threshold)
    prompt = prompt_ids(cfg, batch, seed)
    decode(fwd, params, prompt, kw, device)  # warm-up
    times = []
    for _ in range(reps):
        t0 = time.time()
        out = decode(fwd, params, prompt, kw, device)
        times.append(time.time() - t0)
    # The loop denoised: random weights may argmax to the mask id itself on
    # a tiny vocabulary (the reference sampler allows that too), so near-
    # complete unmasking is required, not perfect.
    share = (out[:, PROMPT_LEN:] == cfg.mask_token_id).float().mean().item()
    if share >= 0.05:
        raise AssertionError(f"{share:.3f} of the generated positions still hold the mask id")
    return float(statistics.median(times))


def onchip_seconds(cfg, params, fwd, *, steps, batch, seed=1, device=None):
    """The card's busy seconds of one warm batched sampler call (the union
    of its device intervals).  The sampler is a host loop of launches, not
    one device program, so this union is its device time.  None off the
    card; on the card an empty trace is a failed profile and raises."""
    kw = decode_kw(cfg, steps)
    prompt = prompt_ids(cfg, batch, seed)
    sec = onchip_device_seconds(lambda: decode(fwd, params, prompt, kw, device))
    if sec is None and torch.device(device).type == "cuda":
        raise RuntimeError("the profiler recorded no device interval for a decode")
    return None if sec is None else round(sec, 4)


def _mfu(fl, dt, n_chips, peak_tflops):
    v = fl / dt / (n_chips * peak_tflops * 1e12)
    return round(v, 4) if math.isfinite(v) else None


def batch_row(cfg, params, fwd, *, steps, batch, reps, peak, n_chips,
              with_onchip, device=None):
    """One throughput row at a batch size (and its on-chip companion)."""
    seq = PROMPT_LEN + GEN_LENGTH
    dt = measure(cfg, params, fwd, steps=steps, batch=batch, reps=reps, device=device)
    flops = batch * steps * cfg.forward_flops(seq, lm_head_width=BLOCK_LENGTH)
    row = {
        "batch": batch,
        "tok_per_sec_per_chip": round(batch * GEN_LENGTH / dt / n_chips, 2),
        "seconds_per_batch": round(dt, 3),
        "seconds_per_sample_batched": round(dt / batch, 3),
        "mfu": _mfu(flops, dt, n_chips, peak),
    }
    if with_onchip:
        oc = onchip_seconds(cfg, params, fwd, steps=steps, batch=batch, device=device)
        if oc is not None:
            row["onchip_seconds_per_batch"] = oc
            row["onchip_tok_per_sec_per_chip"] = round(batch * GEN_LENGTH / oc / n_chips, 2)
            row["onchip_mfu"] = _mfu(flops, oc, n_chips, peak)
    return row


def load_model(name: str, device):
    """(cfg, params, fwd) of a preset with seeded random weights."""
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn

    cfg = get_config(name)
    params = init_params(cfg, seed=0, device=device)
    sync(params)
    return cfg, params, make_forward_fn(cfg, device)


def headline(peak, n_chips, budget: Budget, device):
    """The budgeted default path: full-size llada-moe-7b at batch 8, and
    the single-sample latency while the budget allows.  Returns (cfg,
    params, fwd, head) so ``--full`` keeps measuring on the same weights."""
    budget.log("loading headline model (full-size llada-moe-7b)")
    cfg, params, fwd = load_model("llada-moe-7b", device)
    budget.log(f"model ready: {cfg.name}; measuring batch 8 "
               f"(remaining budget {budget.remaining():.0f}s)")
    row = batch_row(cfg, params, fwd, steps=128, batch=8, reps=2, peak=peak,
                    n_chips=n_chips, with_onchip=budget.remaining() > 90, device=device)
    head = {
        "model": cfg.name,
        "params_total_b": round(cfg.param_count() / 1e9, 2),
        "params_active_b": round(cfg.active_param_count() / 1e9, 2),
        "prompt_len": PROMPT_LEN, "gen_length": GEN_LENGTH,
        "steps": 128, "block_length": BLOCK_LENGTH,
        "dtype": cfg.dtype,
        **{k: v for k, v in row.items() if k != "mfu"},
        "mfu": row["mfu"],
    }
    if budget.remaining() > 360:
        budget.log("measuring single-sample latency")
        try:
            dt1 = measure(cfg, params, fwd, steps=128, batch=1, reps=2, device=device)
            head["single_sample_latency_sec"] = round(dt1, 3)
            head["single_sample_tok_per_sec"] = round(GEN_LENGTH / dt1, 2)
            seq = PROMPT_LEN + GEN_LENGTH
            head["mfu_single"] = _mfu(
                128 * cfg.forward_flops(seq, lm_head_width=BLOCK_LENGTH), dt1, n_chips, peak)
        except Exception as e:  # recorded in the line; the headline stands
            head["single_sample_error"] = f"{type(e).__name__}: {str(e)[:120]}"
    return cfg, params, fwd, head


def head_row_view(head):
    """The headline's own batch row, for the sweep table."""
    keys = ("batch", "tok_per_sec_per_chip", "seconds_per_batch",
            "seconds_per_sample_batched", "mfu", "onchip_seconds_per_batch",
            "onchip_tok_per_sec_per_chip", "onchip_mfu")
    return {k: head[k] for k in keys if k in head}


def full_extras(cfg, params, fwd, head, peak, n_chips, budget: Budget, device):
    """``--full`` only: batch 16 and 32, and the block-cache rows at the
    largest batch that ran.  Extends ``head`` in place."""
    from ct_diffusionmodelbench_tpu_torch.models import make_cached_fns

    rows = [dict(head_row_view(head))]
    for batch in (16, 32):
        budget.log(f"sweep: batch {batch}")
        try:
            rows.append(batch_row(cfg, params, fwd, steps=128, batch=batch, reps=2,
                                  peak=peak, n_chips=n_chips, with_onchip=True,
                                  device=device))
        except Exception as e:  # one row's failure is recorded in the row
            rows.append({"batch": batch, "error": f"{type(e).__name__}: {str(e)[:120]}"})
    head["batch_sweep"] = rows
    ok = [r for r in rows if "error" not in r]
    with_oc = [r for r in ok if "onchip_tok_per_sec_per_chip" in r]
    if with_oc:
        best = max(with_oc, key=lambda r: r["onchip_tok_per_sec_per_chip"])
        head["onchip_best"] = {
            "batch": best["batch"],
            "tok_per_sec_per_chip": best["onchip_tok_per_sec_per_chip"],
            "note": "the card's busy time alone (the union of its device "
                    "intervals), best across the batch sweep; the wall-clock "
                    "rows add the host's launch time",
        }
    # Block-cache decoding (models/block_cache.py): same model and sampler
    # configuration, approximate numerics, so its own rows, never the
    # headline.
    accel_rows = []
    if ok:
        cached = make_cached_fns(cfg)
        ab = max(r["batch"] for r in ok)
        for label, mkw in (
                ("block-cache (--accel block-cache)", dict(cached_fns=cached)),
                # Random weights clear almost no confidence of 0.9, so the
                # threshold decode runs its worst case (one forced unmask a
                # step, block_length steps a block): a lower bound.
                ("block-cache + parallel-threshold 0.9, worst-case "
                 "(--accel block-cache --parallel-threshold 0.9)",
                 dict(cached_fns=cached, parallel_threshold=0.9))):
            budget.log(f"accel row: {label}")
            try:
                dt_a = measure(cfg, params, fwd, steps=128, batch=ab, reps=2,
                               device=device, **mkw)
                accel_rows.append({
                    "mode": label,
                    "batch": ab,
                    "tok_per_sec_per_chip": round(ab * GEN_LENGTH / dt_a / n_chips, 2),
                    "seconds_per_batch": round(dt_a, 3),
                    "seconds_per_sample_batched": round(dt_a / ab, 3),
                })
            except Exception as e:  # recorded in the row
                accel_rows.append({"mode": label,
                                   "error": f"{type(e).__name__}: {str(e)[:120]}"})
    if accel_rows:
        head["accel"] = accel_rows


def dense_subbench(peak, n_chips, budget: Budget, device):
    """``--full`` only: the reference's dense sub-benchmark, ``llada-2b``
    (the LLaDA-8B architecture at 22 layers, D 2048) at the north-star
    shape, 256 steps, batch 8 and batch 1."""
    budget.log("dense sub-benchmark (llada-2b, 256 steps)")
    dcfg, dparams, dfwd = load_model("llada-2b", device)
    drow = batch_row(dcfg, dparams, dfwd, steps=256, batch=8, reps=2, peak=peak,
                     n_chips=n_chips, with_onchip=True, device=device)
    dt1 = measure(dcfg, dparams, dfwd, steps=256, batch=1, reps=2, device=device)
    seq = PROMPT_LEN + GEN_LENGTH
    return {
        "model": dcfg.name,
        "params_total_b": round(dcfg.param_count() / 1e9, 2),
        "params_active_b": round(dcfg.active_param_count() / 1e9, 2),
        "prompt_len": PROMPT_LEN, "gen_length": GEN_LENGTH,
        "steps": 256, "block_length": BLOCK_LENGTH,
        "dtype": dcfg.dtype,
        **drow,
        "single_sample_latency_sec": round(dt1, 3),
        "single_sample_tok_per_sec": round(GEN_LENGTH / dt1, 2),
        "mfu_single": _mfu(256 * dcfg.forward_flops(seq, lm_head_width=BLOCK_LENGTH),
                           dt1, n_chips, peak),
        "note": ("dense LLaDA at the north-star shape (256 steps, gen 256, block "
                 "32): llada-2b is the LLaDA-8B architecture cut to 22 layers "
                 "of D 2048, the reference's dense row beside the MoE headline; "
                 "full-size llada-8b runs in bench_sweep's "
                 "llada_8b_int8_single_chip row and in entry.py"),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="after the headline line, measure the batch sweep, the "
                         "block-cache rows and the dense sub-benchmark, and write "
                         "the whole result to --out")
    ap.add_argument("--out", default=DEFAULT_OUT, help="artifact path for --full")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the CPU smoke shape; default: the card")
    return ap.parse_args(argv)


def run(args, budget: Budget) -> None:
    from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    chip_kind, peak = chip_peak_tflops(dev)
    n_chips = 1   # the decode runs on one card

    sanity_ms = None
    if on_card:
        sanity_ms = round(_sanity_matmul_ms(dev), 3)
        budget.log(f"budget {budget.seconds:.0f}s; sanity matmul {sanity_ms} ms/iter")
        cfg, params, fwd, head = headline(peak, n_chips, budget, dev)
    else:  # the CPU smoke shape
        cfg = get_config("llada-moe-tiny", dtype="float32")
        params = init_params(cfg, seed=0, device=dev)
        fwd = make_forward_fn(cfg, dev)
        row = batch_row(cfg, params, fwd, steps=16, batch=2, reps=1, peak=peak,
                        n_chips=n_chips, with_onchip=False, device=dev)
        head = {"model": cfg.name, "dtype": cfg.dtype, **row}

    value = head["tok_per_sec_per_chip"]
    result = {
        "metric": "denoised_tokens_per_sec_per_chip",
        "value": value,
        "unit": "tok/s/chip",
        # Full-size LLaDA-MoE at gen 256 / steps 128 / block 32 / greedy: the
        # configuration behind the reference's 57.09 s/sample on a GH200.
        "vs_baseline": round(value / REFERENCE_DENOISED_TOK_PER_SEC, 2),
        "config": {
            "backend": dev.type,
            "chips": n_chips,
            "chip_kind": chip_kind,
            "value_source": "wall_clock",
            "pool_sanity_matmul_ms": sanity_ms,
            "peak_bf16_tflops_per_chip": peak if math.isfinite(peak) else None,
            "baseline": "LLaDA-MoE-7B-A1B 256 tok / 57.09 s on GH200 "
                        "(model_performance.md:5; BASELINE.md)",
            "budget_s": budget.seconds,
            "elapsed_s": round(budget.elapsed(), 1),
            "headline": head,
        },
    }
    print(json.dumps(result), flush=True)

    if args.full and on_card:
        budget.log("--full: batch sweep, block-cache rows, dense sub-benchmark")
        try:
            full_extras(cfg, params, fwd, head, peak, n_chips, budget, dev)
        except Exception as e:  # recorded in the artifact
            result["config"]["full_extras_error"] = (
                f"sweep/accel: {type(e).__name__}: {str(e)[:200]}")
        del params, fwd
        gc.collect()
        torch.cuda.empty_cache()
        try:
            result["config"]["sub_benchmarks"] = {
                "llada_2b_dense_north_star": dense_subbench(peak, n_chips, budget, dev)}
        except Exception as e:  # recorded in the artifact
            result["config"]["dense_subbench_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        result["config"]["pool_sanity_matmul_ms_after"] = round(_sanity_matmul_ms(dev), 3)
        result["config"]["elapsed_s"] = round(budget.elapsed(), 1)
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
        budget.log(f"wrote {out}")


def main(argv=None) -> int:
    """Run the bench; 0 after the result line, 1 after the error line."""
    budget = Budget(float(os.environ.get("CTDB_BENCH_BUDGET_S", "1200")))
    try:
        run(parse_args(argv), budget)
    except Exception as e:  # the one line the caller parses, then rc 1
        traceback.print_exc()
        emit_error_line(f"{type(e).__name__}: {str(e)[:300]}", budget)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
