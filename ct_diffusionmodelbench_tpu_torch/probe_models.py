"""Per-family quick probes: a few small prompts through each model family,
the generations saved as ``.lean`` files.

    python -m ct_diffusionmodelbench_tpu_torch.probe_models --out build/probe_results
        [--model-dir DIR] [--gen-length 32] [--steps 16] [--device cpu]

Counterpart of ``examples/probe_models.py`` (itself the counterpart of the
reference's per-family chat probes): the same four families on their tiny
presets with seeded random weights, or one checkpoint with ``--model-dir``,
through the port's ``ModelRunner``, with the same prompts, lengths and
temperatures (greedy for the LLaDA families, 0.4 with top_p 0.95 for
Dream / DiffuCoder), and one autoregressive probe on the causal form of
the LLaDA preset through ``sampling/simple.py::ar_generate`` (temperature
0.7, top_p 0.95, a seeded generator).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
from ct_diffusionmodelbench_tpu_torch.sampling.simple import ar_generate
from ct_diffusionmodelbench_tpu_torch.utils.logging import log

PROMPTS = [
    "Prove that for any natural number n, n + 0 = n.",
    "Show that addition of natural numbers is commutative.",
    "Prove that the square of an even number is even.",
]

FAMILIES = [
    ("llada", "llada-tiny"),
    ("llada-moe", "llada-moe-tiny"),
    ("dream", "dream-tiny"),
    ("diffucoder", "dream-tiny"),
]


def make_runner(family: str, preset, model_dir, device) -> ModelRunner:
    """The runner a family is probed with."""
    if model_dir:
        return ModelRunner.from_dir(model_dir, device=device)
    return ModelRunner.random_init(preset, family=family, device=device)


def ar_probe(runner: ModelRunner, prompt: str, seed: int = 0) -> str:
    """16 tokens of the runner's model made causal (no logit shift),
    sampled autoregressively at temperature 0.7, top_p 0.95."""
    from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn

    cfg = runner.cfg.replace(causal=True, logit_shift=False)
    fwd = make_forward_fn(cfg, runner.device)
    ids = np.asarray(runner.tokenizer.encode(prompt), np.int64)
    gen = torch.Generator(device=runner.device).manual_seed(seed)
    seq = ar_generate(fwd, runner.params, torch.from_numpy(ids)[None].to(runner.device),
                      max_new_tokens=16, temperature=0.7, top_p=0.95, generator=gen)
    return runner.tokenizer.decode(seq[0, len(ids):].cpu().numpy())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Per-family model probes")
    p.add_argument("--model-dir", default=None,
                   help="Probe a real checkpoint instead of tiny presets")
    p.add_argument("--out", default="build/probe_results")
    p.add_argument("--gen-length", type=int, default=32)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--device", default=None, help="'cpu' to run on the CPU; default: the card")
    args = p.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    targets = [("checkpoint", None)] if args.model_dir else FAMILIES
    for family, preset in targets:
        runner = make_runner(family, preset, args.model_dir, args.device)
        log(f"--- {family} ({runner.cfg.name}) ---")
        for i, prompt in enumerate(PROMPTS):
            t0 = time.time()
            res = runner.generate(
                prompt, gen_length=args.gen_length, steps=args.steps,
                block_length=min(16, args.gen_length),
                temperature=0.0 if family.startswith("llada") else 0.4,
                top_p=0.95)
            path = out / f"{family}_probe_{i}.lean"
            path.write_text(res.text)
            log(f"[{family} #{i}] {time.time() - t0:.2f}s -> {path}")

        if not args.model_dir and family == "llada":
            (out / "lladou_ar_probe.lean").write_text(ar_probe(runner, PROMPTS[0]))
            log("[lladou-ar] saved lladou_ar_probe.lean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
