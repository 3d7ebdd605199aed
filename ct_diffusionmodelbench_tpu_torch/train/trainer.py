"""Masked-diffusion SFT training loop.

Counterpart of ``train/trainer.py`` on one device: :class:`TrainConfig` with
the same fields, :func:`make_optimizer` (the clip by gradient-accumulation
dtype, then AdamW with f32, bf16 or int8 moments), :func:`make_train_step`
(gradient accumulation over ``A`` micro-batches in f32 or bf16, dense and
MoE models with the aux loss, the global gradient norm in f32, clip +
AdamW) and :class:`Trainer` (shuffled batches, the collator, evaluation
with tail-row ``row_mask``, ``training_logs.jsonl``,
``training_metrics.json``, ``training_config.json``, the loss plots, an
HF-layout save with the tokenizer, and the optimizer state saved and
resumed under the reference's key names).

Data and tensor parallelism (``dp``/``tp`` > 1): one process per rank
(``torchrun``) over a ``parallel/`` mesh.  Each rank holds its shard of the
parameters and of the optimizer state; each data rank takes its rows of the
global micro-batch, with the noise drawn for the global batch and sliced,
so the loss trajectory is the one-process run's; the gradients are averaged
over ``data`` (the per-layer expert leaves, like every sharded leaf, stay
this rank's); the global norm sums the shards' squares over ``model``.
Saves gather the shards on rank 0, which writes the reference's layout;
resumes re-shard.  Evaluation runs its whole batch on every rank.

Sequence parallelism (``sp`` > 1, the (data, seq, model) mesh): each seq
rank takes its slice of every row (the noise drawn for the whole batch,
then sliced), its forward runs ring attention, the loss's sums are summed
over ``seq`` inside the loss and the gradients after the backward, then
averaged over ``data``.  A padded length that does not divide by ``sp``
runs whole on every seq rank, with nothing summed over ``seq``.

Pipeline parallelism (``pp`` > 1, the (data, stage, model) mesh,
``parallel/pipeline.py``): each rank holds its stage's layers; the step
runs the GPipe forward of ``pp_microbatches`` microbatches (one per stage
by default) on the logits path (no CE chunking, as the reference keeps it
for a pipeline forward); each data rank takes its rows of every
microbatch.  The norm sums the stages' squares; saves gather the stages,
resumes cut them again.  ``pp`` composes with ``dp`` and ``tp`` (dense
blocks), not with ``sp``, as in the reference.

Differences from the reference: parameters update in place, so
``donate_state`` has no effect.  MoE training keeps the port's attention
dispatch (flash on the card) where the reference forces its reference
attention, a choice it measured on the TPU.  Each
layer's expert weights are a gradient leaf of their own, accumulated as
soon as their layer's backward is done.  Noise comes from a
``torch.Generator`` seeded like the reference's key (``seed``, ``seed +
10000`` for evaluation), so runs are repeatable but draw other numbers than
JAX.
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
from ct_diffusionmodelbench_tpu_torch.io.safetensors_io import (
    load_safetensors, save_safetensors)
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.models.transformer import (
    EXPERT_STACK_KEYS, forward, lm_head_logits)
from ct_diffusionmodelbench_tpu_torch.train.collator import DiffusionCollator
from ct_diffusionmodelbench_tpu_torch.parallel.comm import (
    all_reduce_, mean_over_data, sum_over_seq_)
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import (
    Mesh, ensure_distributed, is_main_process, make_mesh, use_mesh)
from ct_diffusionmodelbench_tpu_torch.parallel.pipeline import (
    PipelineForward, stage_leaf, gather_leaf, make_pp_forward,
    make_pp_mesh, pp_param_specs, shard_params_pp, validate as validate_pp)
from ct_diffusionmodelbench_tpu_torch.parallel.sharding import (
    local_specs, shard_params)
from ct_diffusionmodelbench_tpu_torch.train.diffusion_loss import (
    diffusion_sft_loss, draw_noise)
from ct_diffusionmodelbench_tpu_torch.train.optim import (
    AdamW, AdamWLowp, AdamWState, Quantized, _keypath, dequantize_int8, flatten_params,
    global_norm, linear_schedule, load_state_tensors, quantize_int8,
    sharded_global_norm, state_tensors, unflatten_params,
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
    optimizer_state_dtype: str = "float32"   # float32 | bfloat16 | int8
    grad_accum_dtype: str = "float32"        # float32 | bfloat16
    optimizer_update_dtype: str = "float32"  # float32 | bfloat16 (lowp path only)
    donate_state: bool = True          # no effect: updates are in place
    max_grad_norm: float = 1.0
    max_length: int = 2048
    eval_steps: int = 1000
    logging_steps: int = 10
    save_steps: int = 0                # 0 = final save only
    save_total_limit: int = 1
    save_optimizer_state: bool = False  # optimizer.safetensors, for resume
    seed: int = 42
    aux_loss_coef: float = 0.01
    mask_variant: str = "recompute"
    variable_length: bool = True
    varlen_prob: float = 0.01
    varlen_min: int = 8
    bucket: int = 64
    remat: "bool | str" = False        # True = per-block recompute; 'dots'
                                       # = save matmul outputs only
    ce_chunk: int = 512
    drop_last: bool = True
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    pp_microbatches: int = 0


ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_optimizer(cfg: TrainConfig, total_steps: int):
    """(optimizer, schedule): clip by global norm (in f32 for a bf16
    accumulation buffer, as the reference chooses it), then AdamW with
    weight decay masked off for norm scales and biases: optax's for f32
    moments, ``adamw_lowp``'s for bf16 or int8 ones."""
    if cfg.grad_accum_dtype not in ACCUM_DTYPES:
        raise ValueError(f"unknown grad_accum_dtype {cfg.grad_accum_dtype!r}")
    if cfg.lr_schedule == "cosine":
        schedule = warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, cfg.warmup_steps,
            max(total_steps, cfg.warmup_steps + 1))
    else:
        schedule = linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
    kw = dict(b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
              weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm,
              clip_f32=cfg.grad_accum_dtype != "float32")
    if cfg.optimizer_state_dtype == "float32":
        return AdamW(schedule, **kw), schedule
    return AdamWLowp(schedule, state_dtype=cfg.optimizer_state_dtype,
                     update_dtype=cfg.optimizer_update_dtype, **kw), schedule


def _grad_leaves(flat: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor]):
    """(gradient leaves, the tree the forward takes): aliases of the
    parameters that autograd differentiates, each accumulating its gradient
    into ``acc`` (cast to the buffer's dtype first) as soon as the backward
    has it, then dropping it.  A layer-stacked expert weight gets one leaf
    per layer, handed to the model as a list, so each layer's expert
    gradient is added to its slice of the buffer and freed: the step never
    holds a full-stack expert gradient beside the buffer."""
    def leaf(t, buf):
        t = t.detach().requires_grad_(True)

        def accumulate(v):
            buf.add_(v.grad.to(buf.dtype))
            v.grad = None
        t.register_post_accumulate_grad_hook(accumulate)
        return t

    leaves, tree_flat = [], {}
    for k, p in flat.items():
        if k.split("/")[-1] in EXPERT_STACK_KEYS and p.ndim == 4:
            tree_flat[k] = [leaf(p[i], acc[k][i]) for i in range(p.shape[0])]
            leaves += tree_flat[k]
        else:
            tree_flat[k] = leaf(p, acc[k])
            leaves.append(tree_flat[k])
    return leaves, unflatten_params(tree_flat)


PP_SP_ERROR = ("pp composes with dp and tp, not sp (ring attention runs on "
               "the sharded forward, parallel/sharding.py; see "
               "parallel/pipeline.py)")


def leaf_specs(cfg: ModelConfig, mesh: Mesh) -> Dict[str, tuple]:
    """{flat leaf name: (dim split over ``stage``, dim split over
    ``model``)} under ``mesh``, None where the leaf is whole."""
    if mesh.stage > 1:
        specs = pp_param_specs(cfg, mesh.model)
        flat = {f"blocks/{k}": v for k, v in specs["blocks"].items()}
        flat.update({k: v for k, v in specs.items() if k != "blocks"})
        return flat
    return {k: (None, d) for k, d in flatten_params(local_specs(cfg, mesh.model)).items()}


def microbatches(train_cfg: "TrainConfig") -> int:
    """The GPipe microbatches a step: ``pp_microbatches``, else one per
    stage."""
    return train_cfg.pp_microbatches or train_cfg.pp


def check_layout(model_cfg: ModelConfig, train_cfg: "TrainConfig") -> None:
    """The parallel layout's checks that need no process group."""
    tc = train_cfg
    if tc.pp > 1:
        if tc.sp > 1:
            raise ValueError(PP_SP_ERROR)
        m = microbatches(tc)
        if tc.batch_size % m:
            raise ValueError(f"batch_size={tc.batch_size} must divide by "
                             f"pp_microbatches={m}")
        if (tc.batch_size // m) % tc.dp:
            raise ValueError(f"per-microbatch rows {tc.batch_size // m} "
                             f"must divide by dp={tc.dp}")
        validate_pp(model_cfg, tc.pp, tc.tp)
    elif tc.batch_size % tc.dp:
        raise ValueError(f"batch_size={tc.batch_size} must divide by dp={tc.dp}")


def _reduce_metrics(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The data ranks' metrics combined into the global batch's: loss and
    aux averaged, masked tokens summed, masked CE weighted by them."""
    n = metrics["masked_tokens"].float()
    v = torch.stack([metrics["loss"].float(), metrics["aux_loss"].float(), n,
                     metrics["masked_ce"].float() * n])
    all_reduce_(v, mesh.data_group, mesh)
    return {"loss": v[0] / mesh.data, "aux_loss": v[1] / mesh.data,
            "masked_tokens": v[2], "masked_ce": v[3] / torch.clamp_min(v[2], 1.0)}


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    optimizer: AdamW, device: DeviceLike = None, mesh=None,
                    pipeline: Optional[PipelineForward] = None):
    """(step, eval_step).

    ``step(params, opt_state, input_ids [A, B, L], prompt_lengths [A, B],
    noise) -> (params, opt_state, metrics)`` updates ``params`` in place and
    returns it; ``noise`` is a ``torch.Generator`` or ``(t [A, B], u [A, B,
    L])``.  The gradients accumulate in ``grad_accum_dtype``, each cast to
    it before it is added, as the reference's ``a + g.astype(acc_dt)``; MoE
    models add ``aux_loss_coef`` times the aux loss.  ``eval_step(params,
    input_ids [B, L], prompt_lengths [B], noise, row_mask [B]) ->
    metrics``.

    ``mesh`` (``parallel/``): ``params`` are this rank's shard and the
    batches global; each data rank computes its rows and each seq rank its
    slice of them (the noise drawn for all rows, then sliced), the
    gradients are summed over ``seq`` and averaged over ``data`` and the
    norm summed over the shards; the metrics are the global batch's.
    ``pipeline``: the GPipe forward over ``mesh`` (``stage`` axis), whose
    :meth:`~PipelineForward.rows` are this data rank's rows."""
    if train_cfg.grad_accum_dtype not in ACCUM_DTYPES:
        raise ValueError(f"unknown grad_accum_dtype {train_cfg.grad_accum_dtype!r}")
    acc_dt = ACCUM_DTYPES[train_cfg.grad_accum_dtype]
    aux_coef = train_cfg.aux_loss_coef if model_cfg.is_moe else 0.0
    mask_id = model_cfg.mask_token_id
    if mask_id is None:
        raise ValueError("model config needs mask_token_id for diffusion SFT")
    dev = resolve_device(device)
    if mesh is not None and mesh.size == 1:
        mesh = None
    dp = 1 if mesh is None else mesh.data
    sp = 1 if mesh is None else mesh.seq
    specs = {} if mesh is None else leaf_specs(model_cfg, mesh)
    shards = {k for k, (_, d) in specs.items() if d is not None}
    staged = {k for k, (st, _) in specs.items() if st is not None}

    def fwd(p, ids, m=None, *, return_hidden=False):
        if pipeline is not None:   # this data rank's rows
            return pipeline.local(p, ids, m)
        return forward(model_cfg, p, ids, attn_mask=m,
                       return_hidden=return_hidden, remat=train_cfg.remat)

    def head(p, h):
        return lm_head_logits(p, h, model_cfg)

    ce_kw = (dict(head_fn=head, ce_chunk=train_cfg.ce_chunk)
             if train_cfg.ce_chunk and pipeline is None else {})

    def my_rows(t):
        """This data rank's rows of a global batch (dim 0)."""
        if pipeline is not None:
            idx = pipeline.rows(t.shape[0])
            return t if idx is None else t[idx.to(t.device)]
        return t if dp == 1 else t[mesh.rows(t.shape[0])]

    def micro_noise(noise, i, b, l, pos):
        if isinstance(noise, torch.Generator):
            if dp == 1 and pos == slice(None):
                return noise
            t, u = draw_noise(noise, b, l, dev)   # the global batch's draws
            return my_rows(t), my_rows(u)[:, pos]
        return my_rows(noise[0][i]), my_rows(noise[1][i])[:, pos]

    def loss_fn(params, input_ids, prompt_lengths, noise, row_mask=None,
                forward_fn=None):
        return diffusion_sft_loss(
            forward_fn or fwd, params, input_ids, prompt_lengths, mask_id, noise,
            aux_coef=aux_coef, mask_variant=train_cfg.mask_variant,
            row_mask=row_mask, **ce_kw)

    def step(params, opt_state, input_ids, prompt_lengths, noise):
        input_ids = input_ids.to(dev)
        prompt_lengths = prompt_lengths.to(dev)
        a, b, l = input_ids.shape
        if pipeline is None and b % dp:
            raise ValueError(f"batch of {b} rows does not divide by dp={dp}")
        # The sequence splits over seq where its padded length divides.
        split = sp > 1 and l % sp == 0
        pos = mesh.seq_slice(l) if split else slice(None)
        flat = flatten_params(params)
        acc = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
               for k, p in flat.items()}
        # The optimizer later updates the leaves' shared storage in place.
        leaves, tree = _grad_leaves(flat, acc)
        sums: Dict[str, torch.Tensor] = {}
        # The pipeline forward sets its stages' own scope.
        with use_mesh(None if pipeline is not None else mesh,
                      batch=b if dp > 1 else None, global_aux=True,
                      seq_len=l if split else None):
            for i in range(a):
                with torch.enable_grad():
                    loss, metrics = loss_fn(tree, my_rows(input_ids[i])[:, pos],
                                            my_rows(prompt_lengths[i]),
                                            micro_noise(noise, i, b, l, pos))
                    loss.backward()
                del loss
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
        del leaves, tree
        for buf in acc.values():
            buf.div_(a)
        metrics = {k: v / a for k, v in sums.items()}
        if mesh is None:
            grad_norm = global_norm(acc.values())   # in f32, after the division
        else:
            if split:
                sum_over_seq_(acc.values(), mesh)
            mean_over_data(acc.values(), mesh)
            metrics = _reduce_metrics(metrics, mesh) if dp > 1 else metrics
            grad_norm = sharded_global_norm(acc, shards, mesh, staged)
        opt_state = optimizer.update(acc, opt_state, flat, grad_norm)
        metrics["grad_norm"] = grad_norm
        return params, opt_state, metrics

    @torch.no_grad()
    def eval_step(params, input_ids, prompt_lengths, noise, row_mask):
        # The whole batch on every rank: the loss over the real rows is then
        # the one-process loss, tail rows and all.
        with use_mesh(None if pipeline is not None else mesh):
            _, metrics = loss_fn(params, input_ids.to(dev), prompt_lengths.to(dev),
                                 noise, row_mask, forward_fn=pipeline)
        return metrics

    return step, eval_step


class Trainer:
    """End-to-end SFT loop over a tokenized dataset on one device, or over
    a ``dp``/``tp``/``sp`` or ``dp``/``pp``/``tp`` mesh.

    ``dataset`` rows: {"input_ids": list[int], "prompt_lengths": int}.
    Under a mesh, ``mesh`` given: ``params`` are already this rank's shard
    over it (as ``cli/train.py`` loads them); ``mesh`` None: the mesh is
    built and the full ``params`` sharded (a tree on the host is sliced
    before it moves to the card)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        params: dict,
        train_cfg: TrainConfig,
        train_dataset: Sequence[Dict],
        eval_dataset: Optional[Sequence[Dict]] = None,
        pad_token_id: Optional[int] = None,
        tokenizer=None,
        device: DeviceLike = None,
        dist_backend: Optional[str] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.mesh = None
        self.pipeline = None
        tc = train_cfg
        check_layout(model_cfg, tc)
        if tc.dp * tc.tp * tc.sp * tc.pp > 1:
            if mesh is None:
                device = ensure_distributed(tc.dp, tc.tp, device, dist_backend,
                                            seq=tc.sp, stages=tc.pp)
                device = resolve_device(device)
                if tc.pp > 1:
                    mesh = make_pp_mesh(tc.pp, data=tc.dp, model=tc.tp, device=device)
                    params = shard_params_pp(model_cfg, params, mesh)
                else:
                    mesh = make_mesh(data=tc.dp, model=tc.tp, seq=tc.sp, device=device)
                    params = shard_params(model_cfg, params, mesh)
            elif (mesh.data, mesh.seq, mesh.stage, mesh.model) != (tc.dp, tc.sp, tc.pp, tc.tp):
                raise ValueError(
                    f"the params' mesh is {mesh.shape}, the config asks for "
                    f"dp={tc.dp} x sp={tc.sp} x pp={tc.pp} x tp={tc.tp}")
            self.mesh = mesh
            self.device = mesh.device
            if tc.pp > 1:
                self.pipeline = make_pp_forward(model_cfg, mesh, microbatches(tc),
                                                remat=tc.remat)
        elif mesh is not None and mesh.size > 1:
            raise ValueError(f"a {mesh.shape} mesh with dp = tp = sp = pp = 1")
        else:
            self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.train_dataset = list(train_dataset)
        self.eval_dataset = list(eval_dataset) if eval_dataset else None
        self.collator = DiffusionCollator(
            pad_token_id=pad_token_id if pad_token_id is not None
            else model_cfg.pad_token_id,
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
            model_cfg, train_cfg, self.optimizer, self.device, self.mesh,
            self.pipeline)

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
        if not is_main_process():
            return
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
        if not is_main_process():
            return final

        out_dir = Path(self.cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "training_metrics.json", "w") as f:
            json.dump(self.training_logs, f, indent=2)
        try:
            from ct_diffusionmodelbench_tpu_torch.train.plotting import (
                plot_training_metrics)
            plot_training_metrics(self.training_logs, out_dir)
        except Exception as e:  # plotting must never kill a run
            print(f"Plotting skipped: {e}")
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

    def _gathered(self):
        """(full params, full optimizer state or None when it is not saved)
        on rank 0 under a mesh, None elsewhere; the trainer's own
        otherwise.  The ranks of data rank 0 and seq rank 0 take part in
        every leaf's gathers over ``model`` and ``stage``, and all but rank 0
        drop the leaf at once, so only rank 0 ever holds the full model.
        int8 moments are gathered as f32 and quantized whole, in the
        reference's layout for the full leaf."""
        mesh = self.mesh
        if mesh is None:
            return self.params, self.opt_state
        if mesh.data_rank != 0 or mesh.seq_rank != 0:
            return None, None
        specs = leaf_specs(self.model_cfg, mesh)
        keep = mesh.rank == 0

        def full(name, t):
            if specs[name] == (None, None):
                return t
            if isinstance(t, Quantized):
                return quantize_int8(gather_leaf(dequantize_int8(t), specs[name], mesh))
            return gather_leaf(t, specs[name], mesh)

        def gathered(flat):
            out = {}
            for name, t in flat.items():
                whole = full(name, t)
                if keep:
                    out[name] = whole
            return out

        params = gathered(flatten_params(self.params))
        state = None
        if self.cfg.save_optimizer_state:
            st = self.opt_state
            state = AdamWState(st.count, gathered(st.mu), gathered(st.nu))
        return (unflatten_params(params), state) if keep else (None, None)

    def save(self, output_dir: Optional[str] = None):
        """Save as the reference does; under a mesh the shards are gathered
        and rank 0 writes."""
        output_dir = output_dir or self.cfg.output_dir
        t0 = time.time()
        if is_main_process():
            log_timing(f"Starting optimized save to {output_dir}")
        params, state = self._gathered()
        if is_main_process():
            save_checkpoint(output_dir, self.model_cfg, params)
            if self.cfg.save_optimizer_state:
                self.save_training_state(output_dir, state)
            if self.tokenizer is not None:
                self.tokenizer.save_pretrained(output_dir)
        del params, state
        if self.mesh is not None:
            torch.distributed.barrier()
        dt = time.time() - t0
        self.save_times.append(dt)
        if is_main_process():
            log_timing(f"Save completed in {dt:.2f} seconds")

    # -- optimizer-state checkpoint / resume --------------------------------

    def save_training_state(self, output_dir: str, state: Optional[AdamWState] = None):
        """``optimizer.safetensors`` (the optimizer state under the
        reference's key names, ``jax.tree_util.keystr`` of its optax chain
        state) and ``trainer_state.json``: either package resumes from
        either's files.  ``state``: the full state to write (the gathered
        one under a mesh); default the trainer's."""
        out = Path(output_dir)
        save_safetensors(out / "optimizer.safetensors",
                         state_tensors(state or self.opt_state))
        with open(out / "trainer_state.json", "w") as f:
            json.dump({"global_step": self.global_step,
                       "training_logs": to_jsonable(self.training_logs)}, f)

    def _shard_state_tensors(self, flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A full saved state (reference keys) cut to this rank's shards:
        plain moments sliced, int8 ones dequantized, sliced and quantized
        in the shard's own layout."""
        flat = dict(flat)
        for name, spec in leaf_specs(self.model_cfg, self.mesh).items():
            if spec == (None, None):
                continue
            for part in ("mu", "nu"):
                key = f"[1][0].{part}{_keypath(name)}"
                if key in flat:
                    flat[key] = stage_leaf(flat[key], spec, self.mesh).contiguous()
                    continue
                whole = Quantized(flat[key + ".q"], flat[key + ".scale"],
                                  tuple(flat[key + ".meta"].shape[1:]))
                mine = quantize_int8(stage_leaf(dequantize_int8(whole), spec,
                                                 self.mesh).contiguous())
                flat[key + ".q"], flat[key + ".scale"] = mine.q, mine.scale
                flat[key + ".meta"] = torch.zeros((0,) + mine.shape)
        return flat

    def load_training_state(self, output_dir: str):
        """Read what :meth:`save_training_state` (or the reference's) wrote
        into this trainer's optimizer state, in place and cast to its
        dtypes, and the step count and logs."""
        out = Path(output_dir)
        flat = load_safetensors(out / "optimizer.safetensors")
        if self.mesh is not None:
            flat = self._shard_state_tensors(flat)
        self.opt_state = load_state_tensors(self.opt_state, flat)
        state_file = out / "trainer_state.json"
        if state_file.exists():
            with open(state_file) as f:
                st = json.load(f)
            self.global_step = st.get("global_step", 0)
            self.training_logs = st.get("training_logs", [])
