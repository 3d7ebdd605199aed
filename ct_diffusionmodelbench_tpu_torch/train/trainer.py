"""Masked-diffusion SFT training loop.

Counterpart of ``train/trainer.py`` on one device: :class:`TrainConfig` with
the same fields, :func:`make_optimizer` (the f32 path), :func:`make_train_step`
(gradient accumulation over ``A`` micro-batches into f32 buffers, the global
gradient norm in f32, clip + AdamW) and :class:`Trainer` (shuffled batches,
the collator, evaluation with tail-row ``row_mask``, ``training_logs.jsonl``,
``training_metrics.json``, ``training_config.json`` and an HF-layout save).

Differences from the reference, each raising rather than guessing:
data/tensor/sequence/pipeline parallelism (``dp``/``tp``/``sp``/``pp`` > 1),
MoE configs (the grouped kernels have no backward yet), the low-precision
optimizer path (``bfloat16``/``int8`` moments, bf16 accumulation),
``remat='dots'`` and ``save_optimizer_state`` are not ported.  Parameters
update in place, so ``donate_state`` has no effect.  Plotting is skipped.
Noise comes from a ``torch.Generator`` seeded like the reference's key
(``seed``, ``seed + 10000`` for evaluation), so runs are repeatable but
draw other numbers than JAX.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import save_checkpoint
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.models.transformer import forward, lm_head_logits
from ct_diffusionmodelbench_tpu_torch.train.collator import DiffusionCollator
from ct_diffusionmodelbench_tpu_torch.train.diffusion_loss import (
    Noise, diffusion_sft_loss)
from ct_diffusionmodelbench_tpu_torch.train.optim import (
    AdamW, flatten_params, global_norm, linear_schedule, unflatten_params,
    warmup_cosine_decay_schedule)
from ct_diffusionmodelbench_tpu_torch.utils.jsonutil import to_jsonable
from ct_diffusionmodelbench_tpu_torch.utils.logging import log_timing


@dataclass
class TrainConfig:
    """The reference's fields and defaults (``train/trainer.py``)."""
    output_dir: str = "./ctdb-finetuned"
    num_epochs: int = 5
    batch_size: int = 1                # per optimizer step, per microbatch
    grad_accum: int = 4
    learning_rate: float = 5e-5
    warmup_steps: int = 50
    lr_schedule: str = "cosine"        # cosine | constant
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    optimizer_state_dtype: str = "float32"   # only float32 is ported
    grad_accum_dtype: str = "float32"        # only float32 is ported
    optimizer_update_dtype: str = "float32"  # lowp path only (not ported)
    donate_state: bool = True          # no effect: updates are in place
    max_grad_norm: float = 1.0
    max_length: int = 2048
    eval_steps: int = 1000
    logging_steps: int = 10
    save_steps: int = 0                # 0 = final save only
    save_total_limit: int = 1
    save_optimizer_state: bool = False  # not ported
    seed: int = 42
    aux_loss_coef: float = 0.01
    mask_variant: str = "recompute"
    variable_length: bool = True
    varlen_prob: float = 0.01
    varlen_min: int = 8
    bucket: int = 64
    remat: "bool | str" = False        # True = per-block recompute; 'dots' not ported
    ce_chunk: int = 512
    drop_last: bool = True
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    pp_microbatches: int = 0


def make_optimizer(cfg: TrainConfig, total_steps: int):
    """(optimizer, schedule): clip by global norm, then AdamW with weight
    decay masked off for norm scales and biases."""
    if (cfg.optimizer_state_dtype, cfg.grad_accum_dtype) != ("float32", "float32"):
        raise NotImplementedError(
            "only float32 optimizer moments and float32 gradient accumulation "
            f"are ported (got {cfg.optimizer_state_dtype!r}, "
            f"{cfg.grad_accum_dtype!r})")
    if cfg.lr_schedule == "cosine":
        schedule = warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps,
            max(total_steps, cfg.warmup_steps + 1))
    else:
        schedule = linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
    optimizer = AdamW(schedule, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
                      weight_decay=cfg.weight_decay,
                      max_grad_norm=cfg.max_grad_norm)
    return optimizer, schedule


def _micro_noise(noise: Noise, i: int) -> Noise:
    """Micro-batch ``i``'s noise: the generator itself (drawn in order), or
    row ``i`` of stacked ``(t [A, B], u [A, B, L])`` draws."""
    if isinstance(noise, torch.Generator):
        return noise
    return noise[0][i], noise[1][i]


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    optimizer: AdamW, device: DeviceLike = None):
    """(step, eval_step).

    ``step(params, opt_state, input_ids [A, B, L], prompt_lengths [A, B],
    noise) -> (params, opt_state, metrics)`` updates ``params`` in place and
    returns it; ``noise`` is a ``torch.Generator`` or ``(t [A, B], u [A, B,
    L])``.  ``eval_step(params, input_ids [B, L], prompt_lengths [B], noise,
    row_mask [B]) -> metrics``."""
    if model_cfg.is_moe:
        raise NotImplementedError(
            "MoE training is not ported: the grouped expert kernels have no "
            "backward yet")
    mask_id = model_cfg.mask_token_id
    if mask_id is None:
        raise ValueError("model config needs mask_token_id for diffusion SFT")
    dev = resolve_device(device)

    def fwd(p, ids, m=None, *, return_hidden=False):
        return forward(model_cfg, p, ids, attn_mask=m,
                       return_hidden=return_hidden, remat=train_cfg.remat)

    ce_kw = (dict(head_fn=lm_head_logits, ce_chunk=train_cfg.ce_chunk)
             if train_cfg.ce_chunk else {})

    def loss_fn(params, input_ids, prompt_lengths, noise, row_mask=None):
        return diffusion_sft_loss(
            fwd, params, input_ids, prompt_lengths, mask_id, noise,
            aux_coef=0.0, mask_variant=train_cfg.mask_variant,
            row_mask=row_mask, **ce_kw)

    def step(params, opt_state, input_ids, prompt_lengths, noise):
        input_ids = input_ids.to(dev)
        prompt_lengths = prompt_lengths.to(dev)
        a = input_ids.shape[0]
        flat = flatten_params(params)
        # Aliases of the parameters that autograd may differentiate; the
        # optimizer later updates the shared storage in place.
        leaves = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
        tree = unflatten_params(leaves)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in flat.items()}
        sums: Dict[str, torch.Tensor] = {}
        for i in range(a):
            with torch.enable_grad():
                loss, metrics = loss_fn(tree, input_ids[i], prompt_lengths[i],
                                        _micro_noise(noise, i))
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True)
            for buf, g in zip(acc.values(), grads):
                if g is not None:
                    buf.add_(g)
            del loss, grads
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        for buf in acc.values():
            buf.div_(a)
        metrics = {k: v / a for k, v in sums.items()}
        grad_norm = global_norm(acc.values())
        opt_state = optimizer.update(acc, opt_state, flat, grad_norm)
        metrics["grad_norm"] = grad_norm
        return params, opt_state, metrics

    @torch.no_grad()
    def eval_step(params, input_ids, prompt_lengths, noise, row_mask):
        _, metrics = loss_fn(params, input_ids.to(dev), prompt_lengths.to(dev),
                             noise, row_mask)
        return metrics

    return step, eval_step


class Trainer:
    """End-to-end SFT loop over a tokenized dataset on one device.

    ``dataset`` rows: {"input_ids": list[int], "prompt_lengths": int}."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        params: dict,
        train_cfg: TrainConfig,
        train_dataset: Sequence[Dict],
        eval_dataset: Optional[Sequence[Dict]] = None,
        device: DeviceLike = None,
    ):
        if train_cfg.dp * train_cfg.tp * train_cfg.sp > 1 or train_cfg.pp > 1:
            raise NotImplementedError(
                "multi-device training (dp/tp/sp/pp > 1) is not ported")
        if train_cfg.save_optimizer_state:
            raise NotImplementedError("saving the optimizer state is not ported")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.params = params
        self.train_dataset = list(train_dataset)
        self.eval_dataset = list(eval_dataset) if eval_dataset else None
        self.collator = DiffusionCollator(
            pad_token_id=model_cfg.pad_token_id,
            eos_token_id=model_cfg.eos_token_id,
            max_length=train_cfg.max_length,
            variable_length=train_cfg.variable_length,
            varlen_prob=train_cfg.varlen_prob,
            varlen_min=train_cfg.varlen_min,
            bucket=train_cfg.bucket,
            seed=train_cfg.seed,
        )

        rows_per_step = train_cfg.batch_size * train_cfg.grad_accum
        steps_per_epoch = len(self.train_dataset) // rows_per_step
        self.total_steps = max(steps_per_epoch * train_cfg.num_epochs, 1)
        self.optimizer, self.lr_schedule = make_optimizer(train_cfg, self.total_steps)
        self.opt_state = self.optimizer.init(self.params)
        self.train_step, self.eval_step = make_train_step(
            model_cfg, train_cfg, self.optimizer, self.device)

        self.global_step = 0
        self.training_logs: List[Dict] = []
        self.save_times: List[float] = []
        self.step_times: List[float] = []  # wall seconds per step, device synced
        self._rng = np.random.default_rng(train_cfg.seed)

    # ------------------------------------------------------------------

    def _batches(self, dataset, rows_per_step, shuffle, drop_last=None):
        idx = np.arange(len(dataset))
        if shuffle:
            self._rng.shuffle(idx)
        if drop_last is None:
            drop_last = self.cfg.drop_last
        end = len(idx) - (len(idx) % rows_per_step) if drop_last else len(idx)
        for lo in range(0, end, rows_per_step):
            yield [dataset[i] for i in idx[lo: lo + rows_per_step]]

    def _stack_microbatches(self, rows):
        a, b = self.cfg.grad_accum, self.cfg.batch_size
        batch = self.collator(rows, train=True)
        ids = torch.from_numpy(batch["input_ids"]).long().to(self.device)
        plens = torch.from_numpy(batch["prompt_lengths"]).long().to(self.device)
        return ids.reshape(a, b, -1), plens.reshape(a, b)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log(self, entry: Dict):
        entry = to_jsonable(entry)
        self.training_logs.append(entry)
        print(f"Step {entry.get('step')}: {entry}")
        out_dir = Path(self.cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "training_logs.jsonl", "a") as f:
            f.write(json.dumps(entry) + "\n")

    # ------------------------------------------------------------------

    def evaluate(self) -> Optional[float]:
        if not self.eval_dataset:
            return None
        losses = []
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed + 10_000)
        rows_per = self.cfg.batch_size
        # The last partial batch is padded to batch_size with inert rows
        # (prompt_length = L: nothing masked) and excluded by row_mask.
        for rows in self._batches(self.eval_dataset, rows_per, shuffle=False,
                                  drop_last=False):
            batch = self.collator(rows, train=False)
            ids = np.asarray(batch["input_ids"])
            plens = np.asarray(batch["prompt_lengths"])
            n_real = ids.shape[0]
            row_mask = np.ones((rows_per,), np.float32)
            if n_real < rows_per:
                pad = rows_per - n_real
                ids = np.concatenate([ids, np.repeat(ids[-1:], pad, axis=0)], axis=0)
                plens = np.concatenate(
                    [plens, np.full((pad,), ids.shape[1], plens.dtype)])
                row_mask[n_real:] = 0.0
            m = self.eval_step(self.params, torch.from_numpy(ids).long(),
                               torch.from_numpy(plens).long(), gen,
                               torch.from_numpy(row_mask))
            losses.append(float(m["loss"]))
        eval_loss = float(np.mean(losses)) if losses else float("inf")
        self._log({"step": self.global_step, "eval_loss": eval_loss})
        return eval_loss

    def train(self):
        cfg = self.cfg
        rows_per_step = cfg.batch_size * cfg.grad_accum
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        t_start = time.time()
        samples_seen = 0
        self.tokens_seen = 0
        log_timing(
            f"Starting training: {self.total_steps} steps "
            f"({len(self.train_dataset)} samples, eff. batch {rows_per_step})")

        try:
            for epoch in range(cfg.num_epochs):
                for rows in self._batches(self.train_dataset, rows_per_step, shuffle=True):
                    t0 = time.perf_counter()
                    ids, plens = self._stack_microbatches(rows)
                    self.tokens_seen += int(ids.numel())
                    self.params, self.opt_state, metrics = self.train_step(
                        self.params, self.opt_state, ids, plens, gen)
                    self._sync()
                    self.step_times.append(time.perf_counter() - t0)
                    self.global_step += 1
                    samples_seen += rows_per_step

                    if self.global_step % cfg.logging_steps == 0:
                        self._log({
                            "step": self.global_step,
                            "epoch": epoch + 1,
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "learning_rate": self.lr_schedule(self.global_step),
                        })
                    if cfg.eval_steps and self.global_step % cfg.eval_steps == 0:
                        self.evaluate()
                    if cfg.save_steps and self.global_step % cfg.save_steps == 0:
                        self.save(cfg.output_dir)
        except KeyboardInterrupt:
            print("\nTraining interrupted by user")
            self.save(cfg.output_dir + "_interrupted")
            return self._finalize(t_start, samples_seen, status="interrupted")
        except Exception:
            try:
                self.save(cfg.output_dir + "_error")
            except Exception as e:  # the original error is the one to raise
                print(f"Error checkpoint not written: {e}")
            raise

        self.save(cfg.output_dir)
        return self._finalize(t_start, samples_seen, status="completed")

    def _finalize(self, t_start, samples_seen, status):
        elapsed = time.time() - t_start
        # 6 * params * tokens for fwd+bwd, over the collated batch sizes.
        total_flos = 6.0 * self.model_cfg.param_count() * self.tokens_seen
        final = {
            "step": self.global_step,
            "train_runtime": round(elapsed, 2),
            "train_samples_per_second": round(samples_seen / max(elapsed, 1e-9), 3),
            "train_steps_per_second": round(self.global_step / max(elapsed, 1e-9), 3),
            "total_flos": total_flos,
            "train_loss": next((e["loss"] for e in reversed(self.training_logs)
                                if "loss" in e), None),
            "status": status,
        }
        self._log(final)

        out_dir = Path(self.cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "training_metrics.json", "w") as f:
            json.dump(self.training_logs, f, indent=2)
        with open(out_dir / "training_config.json", "w") as f:
            json.dump(to_jsonable({
                "model_name": self.model_cfg.name,
                "max_length": self.cfg.max_length,
                "training_type": "masked_diffusion_sft_tpu",
                "total_parameters": f"{self.model_cfg.param_count() / 1e9:.2f}B",
                "train_config": asdict(self.cfg),
                "average_save_time": (sum(self.save_times) / len(self.save_times)
                                      if self.save_times else "N/A"),
                **final,
            }), f, indent=2)
        return final

    def save(self, output_dir: Optional[str] = None):
        output_dir = output_dir or self.cfg.output_dir
        t0 = time.time()
        log_timing(f"Starting optimized save to {output_dir}")
        save_checkpoint(output_dir, self.model_cfg, self.params)
        dt = time.time() - t0
        self.save_times.append(dt)
        log_timing(f"Save completed in {dt:.2f} seconds")
