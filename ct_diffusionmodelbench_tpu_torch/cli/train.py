"""SFT training CLI.

Counterpart of ``cli/train.py``, flag for flag, plus ``--device`` (the card
by default).  :func:`main` loads the model (``--model-dir`` through
``io/checkpoint.py``, or ``--preset`` random weights from a seeded generator
on the device), the dataset (through ``datasets``, imported only then) and
tokenizes it; :func:`run` trains on rows already tokenized.

    python -m ct_diffusionmodelbench_tpu_torch.cli.train --preset llada-tiny \\
        --device cpu --dataset numina.jsonl --epochs 1 --max-length 64

``--dp``/``--tp``: data × tensor parallelism, one process per rank::

    torchrun --nproc-per-node 4 -m ct_diffusionmodelbench_tpu_torch.cli.train \\
        --preset llada-moe-7b --dp 2 --tp 2 --batch-size 2 ...

Each rank then loads only its shard onto its card (:func:`load_model`).
``--sp`` adds the sequence-parallel axis (ring attention; a (data, seq,
model) mesh of dp·sp·tp ranks) and ``--pp`` the pipeline's stages (GPipe,
``--pp-microbatches`` microbatches a step; a (data, stage, model) mesh of
dp·pp·tp ranks, each rank loading only its stage's layers)::

    torchrun --nproc-per-node 4 -m ct_diffusionmodelbench_tpu_torch.cli.train \
        --preset llada-moe-7b --sp 2 --tp 2 --max-length 4096 ...
    torchrun --nproc-per-node 4 -m ct_diffusionmodelbench_tpu_torch.cli.train \
        --preset llada-moe-7b --pp 4 --pp-microbatches 4 --batch-size 4 ...

``--pp`` composes with ``--dp`` and ``--tp`` (dense models), not with
``--sp``.  Ranks that share a card (or the CPU) add ``--dist-backend
gloo``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

from ct_diffusionmodelbench_tpu_torch.cli.common import add_device_flag, add_mesh_flags
from ct_diffusionmodelbench_tpu_torch.device import resolve_device
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import load_checkpoint
from ct_diffusionmodelbench_tpu_torch.io.datasets_io import (
    NUMINA_DATASET,
    format_instruction_lean_sft,
    format_instruction_problem,
    load_hub_or_local,
    split_80_10_10,
)
from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer
from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import (
    Mesh, ensure_distributed, make_mesh)
from ct_diffusionmodelbench_tpu_torch.parallel.pipeline import (
    init_pp_params, make_pp_mesh, shard_params_pp)
from ct_diffusionmodelbench_tpu_torch.parallel.sharding import (
    init_sharded_params, shard_params)
from ct_diffusionmodelbench_tpu_torch.train.trainer import (
    PP_SP_ERROR, TrainConfig, Trainer)
from ct_diffusionmodelbench_tpu_torch.utils.logging import log_timing


def build_parser():
    p = argparse.ArgumentParser(description="Masked-diffusion SFT (PyTorch/CUDA)")
    p.add_argument("--model-dir", type=str, default=None,
                   help="HF-layout checkpoint to finetune (or resume from)")
    p.add_argument("--preset", type=str, default=None,
                   help="Random-init preset (from-scratch/dev runs)")
    p.add_argument("--dataset", type=str, default=NUMINA_DATASET,
                   help="Hub id or local json/jsonl path")
    p.add_argument("--format", choices=["lean_sft", "problem"], default="lean_sft",
                   help="Instruction format variant (A: train.py:63-88, "
                        "B: train_fast_save.py:40-65)")
    p.add_argument("--output-dir", type=str,
                   default=os.environ.get("FAST_OUTPUT_DIR", "./ctdb-finetuned"))
    p.add_argument("--train-samples", type=int, default=1000)
    p.add_argument("--dataset-slice", type=str, default=None,
                   help="Row slice like 1000:22000 (Training_1kto21k/train.py:169-173)")
    p.add_argument("--max-length", type=int, default=2048)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--grad-accum", type=int, default=4)
    p.add_argument("--learning-rate", type=float, default=5e-5)
    p.add_argument("--warmup-steps", type=int, default=50)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--eval-steps", type=int, default=1000)
    p.add_argument("--logging-steps", type=int, default=10)
    p.add_argument("--save-steps", type=int, default=0,
                   help="0 = final save only (reference save_strategy='no')")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-variable-length", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize layer activations (gradient checkpointing)")
    p.add_argument("--remat-policy", choices=["full", "dots"], default="full",
                   help="With --remat: 'full' recomputes the whole block in "
                        "the backward; 'dots' saves matmul outputs and "
                        "recomputes only elementwise/norm work")
    add_mesh_flags(p)
    p.add_argument("--sp", type=int, default=1,
                   help="Sequence-parallel mesh axis (ring attention over "
                        "'seq')")
    p.add_argument("--pp", type=int, default=1,
                   help="Pipeline-parallel stages (GPipe over 'stage'; "
                        "composes with --dp/--tp, not --sp)")
    p.add_argument("--pp-microbatches", type=int, default=0,
                   help="GPipe microbatches per step (0 = one per stage); "
                        "batch-size must divide by it")
    p.add_argument("--optimizer-state-dtype",
                   choices=["float32", "bfloat16", "int8"], default="float32",
                   help="Adam moment storage dtype (bfloat16/int8 shrink "
                        "optimizer state 2x/4x; float32 = reference "
                        "adamw_torch semantics)")
    p.add_argument("--grad-accum-dtype",
                   choices=["float32", "bfloat16"], default="float32",
                   help="Gradient-accumulation buffer dtype (bfloat16 halves "
                        "the accumulation buffer; the grad-norm clip still "
                        "accumulates in f32)")
    add_device_flag(p)
    return p


def tokenize_rows(ds, tokenizer, max_length):
    """Full text and prompt length per row (the reference's
    tokenize_function)."""
    rows = []
    for ex in ds:
        ids = tokenizer.encode(ex["text"], max_length=max_length)
        p_ids = tokenizer.encode(ex["prompt"], max_length=max_length)
        rows.append({"input_ids": ids, "prompt_lengths": len(p_ids)})
    return rows


def train_mesh(args) -> Optional[Mesh]:
    """The ``--dp``/``--sp``/``--tp`` mesh, or the ``--dp``/``--pp``/``--tp``
    one, or None for one process.  Starts the process group from
    ``torchrun``'s environment if none is up and sets ``args.device`` to
    this rank's device."""
    if args.dp * args.tp * args.sp * args.pp == 1:
        return None
    if args.pp > 1 and args.sp > 1:
        raise ValueError(PP_SP_ERROR)
    args.device = ensure_distributed(args.dp, args.tp, args.device,
                                     args.dist_backend, seq=args.sp, stages=args.pp)
    device = resolve_device(args.device)
    if args.pp > 1:
        return make_pp_mesh(args.pp, data=args.dp, model=args.tp, device=device)
    return make_mesh(data=args.dp, model=args.tp, seq=args.sp, device=device)


def load_model(args, mesh: Optional[Mesh] = None):
    """(config, params, tokenizer) from ``--model-dir`` or ``--preset``, on
    ``--device``.  Under ``mesh`` the params are this rank's shard (under
    ``--pp`` its stage's layers): a checkpoint is read on the host and each
    leaf sliced before it moves, a preset drawn leaf by leaf (the
    one-process draws, sliced), so no rank holds the full model on its
    card."""
    pp = mesh is not None and mesh.stage > 1
    if args.model_dir:
        cfg, params = load_checkpoint(
            args.model_dir, device="cpu" if mesh is not None else args.device)
        if mesh is not None:
            params = (shard_params_pp if pp else shard_params)(cfg, params, mesh)
        try:
            tokenizer = Tokenizer.from_pretrained(args.model_dir)
        except Exception:
            tokenizer = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size,
                                                eos_token_id=cfg.eos_token_id or 2)
    elif args.preset:
        cfg = get_config(args.preset)
        params = (init_params(cfg, seed=args.seed, device=args.device) if mesh is None
                  else (init_pp_params if pp else init_sharded_params)(cfg, args.seed, mesh))
        tokenizer = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size,
                                            eos_token_id=cfg.eos_token_id or 2)
    else:
        raise SystemExit("need --model-dir or --preset")
    return cfg, params, tokenizer


def run(args, cfg: ModelConfig, params: dict, tokenizer,
        train_rows: Sequence[Dict], val_rows: Sequence[Dict],
        mesh: Optional[Mesh] = None) -> Trainer:
    """Train on tokenized rows as ``args`` configure it; returns the
    trainer after its final save.  ``mesh``: the one ``params`` are this
    rank's shard of (:func:`train_mesh`, :func:`load_model`); without it,
    ``--dp``/``--tp`` shard the full ``params`` in the trainer."""
    tc = TrainConfig(
        output_dir=args.output_dir,
        num_epochs=args.epochs,
        batch_size=args.batch_size,
        grad_accum=args.grad_accum,
        learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay,
        eval_steps=args.eval_steps,
        logging_steps=args.logging_steps,
        save_steps=args.save_steps,
        max_length=args.max_length,
        seed=args.seed,
        variable_length=not args.no_variable_length,
        # --remat-policy dots implies remat even without --remat: asking for
        # a policy and silently getting no rematerialization would double
        # activation memory.
        remat=("dots" if args.remat_policy == "dots" else args.remat),
        dp=args.dp,
        tp=args.tp,
        sp=args.sp,
        pp=args.pp,
        pp_microbatches=args.pp_microbatches,
        optimizer_state_dtype=args.optimizer_state_dtype,
        grad_accum_dtype=args.grad_accum_dtype,
    )
    # A config that names neither a pad nor an EOS id (the llada-moe-7b
    # preset) pads with the tokenizer's pad id, where the reference's
    # collator would refuse.
    pad = None if cfg.pad_token_id is not None or cfg.eos_token_id is not None \
        else tokenizer.pad_token_id
    trainer = Trainer(cfg, params, tc, train_rows, eval_dataset=val_rows,
                      pad_token_id=pad, tokenizer=tokenizer, device=args.device,
                      dist_backend=args.dist_backend, mesh=mesh)
    final = trainer.train()
    log_timing(f"Training complete! {final}")
    print(f"Model saved to: {args.output_dir}")
    return trainer


def main(argv=None):
    args = build_parser().parse_args(argv)
    # Each rank on its own device before anything is placed there.
    mesh = train_mesh(args)

    log_timing("Starting masked-diffusion SFT (PyTorch/CUDA)")
    cfg, params, tokenizer = load_model(args, mesh)
    log_timing(f"Model: {cfg.name} ({cfg.param_count() / 1e9:.2f}B params)")

    raw = load_hub_or_local(args.dataset, split="train")
    if args.dataset_slice:
        lo, hi = args.dataset_slice.split(":")
        raw = raw.select(range(int(lo), min(int(hi), len(raw))))
    fmt = (format_instruction_lean_sft if args.format == "lean_sft"
           else format_instruction_problem)
    formatted = raw.map(lambda x: fmt(x, tokenizer), remove_columns=raw.column_names)
    formatted = formatted.filter(lambda x: x["text"] != "")
    train_ds, val_ds, test_ds = split_80_10_10(formatted, seed=args.seed)
    if args.train_samples and len(train_ds) > args.train_samples:
        train_ds = train_ds.select(range(args.train_samples))
    print(f"Final splits -> train: {len(train_ds)}, val: {len(val_ds)}, "
          f"test: {len(test_ds)}")

    log_timing("Tokenizing dataset")
    run(args, cfg, params, tokenizer,
        tokenize_rows(train_ds, tokenizer, args.max_length),
        tokenize_rows(val_ds, tokenizer, args.max_length), mesh=mesh)


if __name__ == "__main__":
    main()
