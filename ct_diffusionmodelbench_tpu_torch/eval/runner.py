"""ModelRunner: parameters + tokenizer + sampler behind one generate() call.

Counterpart of ``eval/runner.py``.  Family dispatch: ``llada`` /
``llada-moe`` take the exact block-diffusion sampler (``sampling/llada.py``),
``dream`` / ``diffucoder`` the ``diffusion_generate`` equivalent
(``sampling/dream.py``), ``sdar`` (port only) the block sampler over an
exact KV cache (``sampling/sdar.py``) through :attr:`ModelRunner.block_fns`;
prompt ids in, token ids out.  ``generate`` and
``generate_batch`` add tokenization, prompt buckets with left padding, EOS
truncation and the families' text split: at ``eos_token`` (dream) or at
``<|dlm_pad|>`` (diffucoder).
Built from an HF or int8 checkpoint directory (:meth:`ModelRunner.from_dir`),
from random weights (:meth:`ModelRunner.random_init`), or around an
in-memory (cfg, params, tokenizer).

``quant="int8"``: weight-only per-channel int8 serving (``ops/quant.py``);
the int8 expert stacks run through the int8 grouped kernels.  Approximate
(weight rounding), so opt-in.

``accel="block-cache"``: the dual KV-cache decode of the LLaDA families
(``models/block_cache.py``), approximate for deep models, so opt-in.
``parallel_threshold`` (per call, or the runner's default): confidence-
threshold parallel unmasking of the LLaDA families; Dream/DiffuCoder refuse
it as the reference does, having no such decode.

``mesh`` (or ``dp``/``tp`` on the constructors): tensor- and data-parallel
serving over a ``parallel/`` mesh, one process per rank (``torchrun``).
The parameters are this rank's shard; ``generate_ids`` splits the batch's
rows over ``data`` when they divide (else every rank decodes them all, as
the reference's wrapper replicates such a batch) and gathers the decoded
rows, so every rank returns the whole batch.  The samplers' draws are made
for the whole batch and sliced (``ops/sampling_ops.py::rand_rows``), so a
sampled run draws what the one-process run draws, on every rank of a model
group alike.  As in the reference, ``quant="int8"`` and
``accel="block-cache"`` are single-device modes and refuse a mesh.

With the tracer on (``utils/profiling.py``), ``generate_ids`` is a
``runner.generate`` span holding ``sampler.decode`` (the sampler's call)
and ``runner.output`` (the output's copy to the host, a device sync), and
counts ``runner.positions`` (B·(P+G)) and ``runner.pad_positions`` (the
zeros of the host's attention mask).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import (
    is_quantized_checkpoint, load_checkpoint, load_quantized_checkpoint)
from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer, resolve_mask_id
from ct_diffusionmodelbench_tpu_torch.models.block_cache import make_cached_fns
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig, get_config
from ct_diffusionmodelbench_tpu_torch.models.mla import interleaved_to_halves
from ct_diffusionmodelbench_tpu_torch.models.sdar_cache import make_sdar_fns
from ct_diffusionmodelbench_tpu_torch.models.transformer import (
    init_params, make_forward_fn)
from ct_diffusionmodelbench_tpu_torch.ops.quant import (
    is_quantized, place_params, quantized_leaf_transform)
from ct_diffusionmodelbench_tpu_torch.parallel.comm import all_gather
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import (
    ensure_distributed, make_mesh, use_mesh)
from ct_diffusionmodelbench_tpu_torch.parallel.sharding import (
    init_sharded_params, shard_params)
from ct_diffusionmodelbench_tpu_torch.sampling import dream_generate, llada_generate
from ct_diffusionmodelbench_tpu_torch.sampling.sdar import sdar_generate
from ct_diffusionmodelbench_tpu_torch.utils.profiling import count, span

LLADA_FAMILIES = ("llada", "llada-moe")
DREAM_FAMILIES = ("dream", "diffucoder")
SDAR_FAMILIES = ("sdar",)


def infer_family(cfg: ModelConfig) -> str:
    """Sampler family: the explicit ``cfg.family`` wins; the name heuristic
    is the last resort for configs that carry neither."""
    if cfg.family:
        return cfg.family
    if cfg.logit_shift:
        return "dream" if "dream" in cfg.name else "diffucoder"
    return "llada-moe" if cfg.is_moe else "llada"


def _maybe_mesh(dp: int, tp: int, device: DeviceLike = None,
                backend: Optional[str] = None):
    """(data=dp, model=tp) mesh, or None for the one-process path.  Starts
    the process group from ``torchrun``'s environment if none is up; with
    neither, raises with how to launch."""
    if dp * tp <= 1:
        return None
    device = ensure_distributed(dp, tp, device, backend)
    return make_mesh(data=dp, model=tp, device=resolve_device(device))


@dataclass
class GenResult:
    token_ids: np.ndarray       # [P+G] full sequence
    continuation_ids: np.ndarray
    text: str                   # decoded continuation
    latency_sec: float


class ModelRunner:
    def __init__(self, cfg: ModelConfig, params: dict, tokenizer: Tokenizer,
                 family: Optional[str] = None,
                 mask_id_override: Optional[int] = None,
                 prompt_bucket: int = 64,
                 mesh=None,
                 accel: Optional[str] = None,
                 quant: Optional[str] = None,
                 device: DeviceLike = None,
                 sharded: bool = False):
        """``params`` may lie anywhere; they are moved to ``device`` (the
        card unless told otherwise) leaf by leaf, and quantized there with
        ``quant="int8"`` unless already quantized.  Under ``mesh`` they are
        the full tree, sliced to this rank's shard, or already the shard
        (``sharded=True``)."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.family = family or infer_family(cfg)
        if self.family not in LLADA_FAMILIES + DREAM_FAMILIES + SDAR_FAMILIES:
            raise ValueError(f"unknown sampler family {self.family!r}")
        if self.family in SDAR_FAMILIES and (mesh is not None or quant is not None):
            raise NotImplementedError("the SDAR family decodes on one card in its "
                                      "configured dtype: drop --dp/--tp and quant")
        self.mesh = mesh
        self.block_fns = make_sdar_fns(cfg) if self.family in SDAR_FAMILIES else None
        """The SDAR sampler's model functions, ``(prefill_fn, step_fn,
        commit_fn)`` of ``models/sdar_cache.py``; None for the other
        families.  The sampler calls the model through this attribute
        alone, which makes it the benchmark's seam for the SDAR family
        (``portbench/drivers/sdar_decode.py`` records each step's state
        there), as ``forward_fn`` and ``cached_fns`` are for the LLaDA
        families."""
        # accel="block-cache": the dual KV-cache decode, LLaDA families only.
        self.cached_fns = None
        if accel is not None:
            if accel != "block-cache":
                raise ValueError(f"unknown accel mode {accel!r} "
                                 "(supported: 'block-cache')")
            if mesh is not None:
                raise NotImplementedError(
                    "accel='block-cache' is single-chip only — drop --dp/--tp "
                    "or the accel flag")
            if self.family not in LLADA_FAMILIES:
                raise NotImplementedError(
                    "accel='block-cache' supports the LLaDA block sampler "
                    "families only (Dream/DiffuCoder use shifted logits)")
            self.cached_fns = make_cached_fns(cfg)
        self.accel = accel
        if quant is not None and quant != "int8":
            raise ValueError(f"unknown quant mode {quant!r} (supported: 'int8')")
        if quant is not None and mesh is not None:
            raise NotImplementedError(
                "quant='int8' is the single-chip alternative to a mesh "
                "— drop --dp/--tp or the quant flag")
        self.quant = quant
        if mesh is not None:
            self.device = mesh.device
            self.params = params if sharded else shard_params(cfg, params, mesh)
        else:
            self.device = resolve_device(device)
            quantize = quant == "int8" and not is_quantized(params["blocks"]["wq"])
            self.params = place_params(params, self.device, quantize)
        if cfg.is_mla:
            # The published interleaved rope columns, in the port's halves.
            self.params = interleaved_to_halves(cfg, self.params)
        self.forward_fn = make_forward_fn(cfg, device=self.device)
        # Left-pad prompts to a multiple of this (padding is numerically
        # transparent: mask-aware attention, RoPE positions restart).
        self.prompt_bucket = max(prompt_bucket, 1)
        self.mask_id = resolve_mask_id(
            config_mask_id=cfg.mask_token_id, tokenizer=tokenizer,
            vocab_size=cfg.vocab_size, override=mask_id_override)
        self.eos_token_id = (tokenizer.eos_token_id
                             if tokenizer.eos_token_id is not None
                             else cfg.eos_token_id)
        # Default confidence threshold for parallel decoding (None: the
        # fixed schedule); a per-call parallel_threshold overrides it.  Set
        # by --parallel-threshold on the serving CLIs.
        self.parallel_threshold = None

    # -- constructors --------------------------------------------------

    @classmethod
    def from_dir(cls, model_dir: str | Path, family: Optional[str] = None,
                 mask_id_override: Optional[int] = None,
                 dtype: Optional[str] = None,
                 dp: int = 1, tp: int = 1,
                 accel: Optional[str] = None,
                 quant: Optional[str] = None,
                 device: DeviceLike = None,
                 backend: Optional[str] = None) -> "ModelRunner":
        """An HF-layout directory (quantized on the device leaf by leaf with
        ``quant="int8"``) or an int8 serving directory (detected by its
        ``config.json`` marker; implies ``quant="int8"``).  ``dp``/``tp``:
        the mesh (read on the host, each rank keeps its shard)."""
        if is_quantized_checkpoint(model_dir):
            cfg, params = load_quantized_checkpoint(model_dir, device="cpu")
            quant = quant or "int8"
        else:
            cfg, params = load_checkpoint(model_dir, dtype=dtype, device="cpu")
        try:
            tokenizer = Tokenizer.from_pretrained(model_dir)
        except Exception:
            tokenizer = Tokenizer.byte_fallback(
                vocab_size=cfg.vocab_size, eos_token_id=cfg.eos_token_id or 2)
        return cls(cfg, params, tokenizer, family=family,
                   mask_id_override=mask_id_override,
                   mesh=_maybe_mesh(dp, tp, device, backend), accel=accel,
                   quant=quant, device=device)

    @classmethod
    def random_init(cls, preset: str, seed: int = 0,
                    family: Optional[str] = None,
                    dp: int = 1, tp: int = 1,
                    accel: Optional[str] = None,
                    quant: Optional[str] = None,
                    device: DeviceLike = None,
                    backend: Optional[str] = None) -> "ModelRunner":
        """Random weights of a preset, drawn on ``device``; with
        ``quant="int8"`` each leaf is quantized as it is built.  Off the card
        bf16 presets run in f32, as the reference's off the TPU.  Under a
        ``dp``/``tp`` mesh each rank draws its shard leaf by leaf (the one-
        process draws, sliced)."""
        mesh = _maybe_mesh(dp, tp, device, backend)
        dev = mesh.device if mesh is not None else resolve_device(device)
        cfg = get_config(preset)
        if dev.type != "cuda" and cfg.dtype == "bfloat16":
            cfg = cfg.replace(dtype="float32")
        if mesh is not None:
            if quant is not None:
                raise NotImplementedError(
                    "quant='int8' is the single-chip alternative to a mesh "
                    "— drop --dp/--tp or the quant flag")
            params = init_sharded_params(cfg, seed, mesh)
        else:
            xform = quantized_leaf_transform if quant == "int8" else None
            params = init_params(cfg, seed=seed, device=dev, leaf_transform=xform)
        tokenizer = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size,
                                            eos_token_id=cfg.eos_token_id or 2)
        return cls(cfg, params, tokenizer, family=family, mesh=mesh, accel=accel,
                   quant=quant, device=dev, sharded=mesh is not None)

    # -- generation ----------------------------------------------------

    def generate_ids(self, prompt_ids, *, gen_length: int = 128,
                     steps: int = 128, block_length: Optional[int] = None,
                     temperature: float = 0.0, cfg_scale: float = 0.0,
                     remasking: str = "low_confidence", avoid_eos: bool = False,
                     top_p: Optional[float] = 0.95, alg: str = "entropy",
                     alg_temp: float = 0.0, exact: bool = False,
                     batch_mean_counts: bool = False,
                     parallel_threshold: Optional[float] = None, seed: int = 0,
                     attn_mask=None) -> np.ndarray:
        """prompt ids [P] or [B, P] → [B, P + gen_length] token ids.  The
        LLaDA families read ``block_length`` (None: 32), ``cfg_scale``,
        ``remasking`` and ``avoid_eos``; Dream/DiffuCoder read ``top_p``,
        ``alg``, ``alg_temp``, ``exact`` and ``batch_mean_counts``; SDAR
        reads ``remasking`` and ``avoid_eos``, and decodes in the model's
        own blocks (``cfg.block_length``, which its attention is built
        on): a ``block_length`` that differs from it is refused."""
        with span("runner.generate"):
            prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long)
            if prompt.ndim == 1:
                prompt = prompt[None]
            count("runner.positions", prompt.shape[0] * (prompt.shape[1] + gen_length))
            if attn_mask is not None:
                attn_mask = torch.as_tensor(np.asarray(attn_mask))
                if attn_mask.ndim == 1:
                    attn_mask = attn_mask[None]
                count("runner.pad_positions", int((attn_mask == 0).sum()))
            threshold = (parallel_threshold if parallel_threshold is not None
                         else self.parallel_threshold)
            mesh = self.mesh
            b = prompt.shape[0]
            # Dream's batch-averaged counts couple the rows: such a batch stays
            # whole on every rank.
            rows = (None if mesh is None or (batch_mean_counts and self.family
                                             in DREAM_FAMILIES) else mesh.rows(b))
            split = rows is not None
            if split:
                prompt = prompt[rows]
                attn_mask = None if attn_mask is None else attn_mask[rows]
            with use_mesh(mesh, batch=b if split else None):
                out = self._generate(prompt, attn_mask, threshold, seed,
                                     gen_length=gen_length, steps=steps,
                                     block_length=block_length, temperature=temperature,
                                     cfg_scale=cfg_scale, remasking=remasking,
                                     avoid_eos=avoid_eos, top_p=top_p, alg=alg,
                                     alg_temp=alg_temp, exact=exact,
                                     batch_mean_counts=batch_mean_counts)
            if split:
                out = all_gather(out, mesh.data_group, mesh, dim=0)
            with span("runner.output"):
                return out.cpu().numpy()

    def _generate(self, prompt, attn_mask, threshold, seed, *, gen_length, steps,
                  block_length, temperature, cfg_scale, remasking, avoid_eos,
                  top_p, alg, alg_temp, exact, batch_mean_counts) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with span("sampler.decode"):
            if self.family in SDAR_FAMILIES:
                if threshold is not None:
                    raise NotImplementedError(
                        "--parallel-threshold is a LLaDA-family decode; SDAR decodes "
                        "each block in a fixed number of steps")
                if block_length not in (None, self.cfg.block_length):
                    raise ValueError(
                        f"block_length {block_length}: {self.cfg.name} attends in "
                        f"blocks of {self.cfg.block_length}, and decodes in those")
                out = sdar_generate(
                    self.block_fns, self.params, prompt, gen_length=gen_length,
                    block_length=self.cfg.block_length, steps=steps, mask_id=self.mask_id,
                    temperature=temperature, remasking=remasking, avoid_eos=avoid_eos,
                    eos_token_id=self.eos_token_id, attn_mask=attn_mask,
                    generator=gen, device=self.device)
            elif self.family in LLADA_FAMILIES:
                out = llada_generate(
                    self.forward_fn, self.params, prompt, steps=steps,
                    gen_length=gen_length,
                    block_length=32 if block_length is None else block_length,
                    temperature=temperature, cfg_scale=cfg_scale,
                    remasking=remasking, mask_id=self.mask_id, avoid_eos=avoid_eos,
                    eos_token_id=self.eos_token_id,
                    block_cache=self.cached_fns is not None,
                    cached_fns=self.cached_fns, parallel_threshold=threshold,
                    attn_mask=attn_mask, generator=gen, device=self.device)
            else:
                if threshold is not None:
                    # As the reference: running Dream's fixed schedule while the
                    # caller asked for threshold decoding would mislabel a run.
                    raise NotImplementedError(
                        "--parallel-threshold is a LLaDA-family decode "
                        "(confidence-threshold parallel unmasking); the Dream/"
                        "DiffuCoder sampler has no equivalent")
                out, _ = dream_generate(
                    self.forward_fn, self.params, prompt, steps=steps,
                    max_new_tokens=gen_length, temperature=temperature,
                    top_p=top_p, alg=alg, alg_temp=alg_temp, mask_id=self.mask_id,
                    exact=exact, batch_mean_counts=batch_mean_counts,
                    attn_mask=attn_mask, generator=gen, device=self.device)
            return out

    def _continuation(self, row: np.ndarray, p: int, truncate_at_eos: bool,
                      skip_special_tokens: bool):
        cont = row[p:]
        if truncate_at_eos and self.eos_token_id is not None:
            # Post-hoc EOS truncation, as the reference's chat loop.
            hits = np.nonzero(cont == self.eos_token_id)[0]
            if hits.size:
                cont = cont[: int(hits[0])]
        text = self.tokenizer.decode(cont, skip_special_tokens=skip_special_tokens)
        if self.family == "dream" and self.tokenizer.eos_token:
            text = text.split(self.tokenizer.eos_token)[0]
        elif self.family == "diffucoder":
            text = text.split("<|dlm_pad|>")[0]
        return cont, text

    def generate(self, prompt_text: str, *, max_length: int = 2048,
                 truncate_at_eos: bool = False, skip_special_tokens: bool = True,
                 **kw) -> GenResult:
        ids = np.asarray(self.tokenizer.encode(prompt_text, max_length=max_length),
                         np.int64)
        attn_mask = None
        p = len(ids)
        b = self.prompt_bucket
        if b > 1 and p % b:
            pad = (p + b - 1) // b * b - p
            pad_id = self.tokenizer.pad_token_id or 0
            ids = np.concatenate([np.full(pad, pad_id, np.int64), ids])
            attn_mask = np.concatenate([np.zeros(pad, np.int32), np.ones(p, np.int32)])
        t0 = time.time()
        out = self.generate_ids(ids, attn_mask=attn_mask, **kw)[0]
        latency = time.time() - t0
        cont, text = self._continuation(out, len(ids), truncate_at_eos,
                                        skip_special_tokens)
        return GenResult(out, cont, text, round(latency, 4))

    def generate_batch(self, prompt_texts: list[str], *, max_length: int = 2048,
                       truncate_at_eos: bool = False,
                       skip_special_tokens: bool = True, **kw) -> list[GenResult]:
        """Several prompts in one batch, left-padded to the bucketed longest
        one; the attention mask excludes the pads and RoPE positions restart
        at each row's first real token, so each row decodes as its unpadded
        single run."""
        encoded = [self.tokenizer.encode(t, max_length=max_length)
                   for t in prompt_texts]
        bk = self.prompt_bucket
        p = max(len(e) for e in encoded)
        p = (p + bk - 1) // bk * bk
        pad = self.tokenizer.pad_token_id or 0
        ids = np.full((len(encoded), p), pad, np.int64)
        mask = np.zeros((len(encoded), p), np.int32)
        for r, e in enumerate(encoded):
            ids[r, p - len(e):] = e
            mask[r, p - len(e):] = 1
        t0 = time.time()
        out = self.generate_ids(ids, attn_mask=mask, **kw)
        latency = round((time.time() - t0) / len(encoded), 4)  # per sample
        results = []
        for r in range(len(encoded)):
            cont, text = self._continuation(out[r], p, truncate_at_eos,
                                            skip_special_tokens)
            results.append(GenResult(out[r], cont, text, latency))
        return results
