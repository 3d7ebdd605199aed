"""ModelRunner: parameters + tokenizer + sampler behind one generate() call.

Counterpart of ``eval/runner.py``.  Family dispatch: ``llada`` /
``llada-moe`` take the exact block-diffusion sampler (``sampling/llada.py``),
``dream`` / ``diffucoder`` the ``diffusion_generate`` equivalent
(``sampling/dream.py``); prompt ids in, token ids out.  ``generate`` and
``generate_batch`` add tokenization, prompt buckets with left padding, EOS
truncation and the families' text split: at ``eos_token`` (dream) or at
``<|dlm_pad|>`` (diffucoder).
Built from an HF or int8 checkpoint directory (:meth:`ModelRunner.from_dir`),
from random weights (:meth:`ModelRunner.random_init`), or around an
in-memory (cfg, params, tokenizer).

``quant="int8"``: weight-only per-channel int8 serving (``ops/quant.py``);
the int8 expert stacks run through the int8 grouped kernels.  Approximate
(weight rounding), so opt-in.

Not ported yet, and refused with ``NotImplementedError``:
``accel="block-cache"`` and ``parallel_threshold`` decoding of the LLaDA
families (ROADMAP Queue 1 #4), and meshes (Queue 1 #7).  Dream/DiffuCoder
refuse ``parallel_threshold`` as the reference does: they have no such
decode.
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
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig, get_config
from ct_diffusionmodelbench_tpu_torch.models.transformer import (
    init_params, make_forward_fn)
from ct_diffusionmodelbench_tpu_torch.ops.quant import (
    is_quantized, place_params, quantized_leaf_transform)
from ct_diffusionmodelbench_tpu_torch.sampling import dream_generate, llada_generate

LLADA_FAMILIES = ("llada", "llada-moe")
DREAM_FAMILIES = ("dream", "diffucoder")


def infer_family(cfg: ModelConfig) -> str:
    """Sampler family: the explicit ``cfg.family`` wins; the name heuristic
    is the last resort for configs that carry neither."""
    if cfg.family:
        return cfg.family
    if cfg.logit_shift:
        return "dream" if "dream" in cfg.name else "diffucoder"
    return "llada-moe" if cfg.is_moe else "llada"


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
                 device: DeviceLike = None):
        """``params`` may lie anywhere; they are moved to ``device`` (the
        card unless told otherwise) leaf by leaf, and quantized there with
        ``quant="int8"`` unless already quantized."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.family = family or infer_family(cfg)
        if self.family not in LLADA_FAMILIES + DREAM_FAMILIES:
            raise ValueError(f"unknown sampler family {self.family!r}")
        if mesh is not None:
            raise NotImplementedError(
                "meshes (TP/DP serving) are not ported yet (ROADMAP Queue 1 #7)")
        if accel is not None:
            raise NotImplementedError(
                f"accel={accel!r} (block-cache decoding) is not ported yet "
                "(ROADMAP Queue 1 #4)")
        if quant is not None and quant != "int8":
            raise ValueError(f"unknown quant mode {quant!r} (supported: 'int8')")
        self.quant = quant
        self.device = resolve_device(device)
        quantize = quant == "int8" and not is_quantized(params["blocks"]["wq"])
        self.params = place_params(params, self.device, quantize)
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
                 accel: Optional[str] = None,
                 quant: Optional[str] = None,
                 device: DeviceLike = None) -> "ModelRunner":
        """An HF-layout directory (quantized on the device leaf by leaf with
        ``quant="int8"``) or an int8 serving directory (detected by its
        ``config.json`` marker; implies ``quant="int8"``)."""
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
                   mask_id_override=mask_id_override, accel=accel, quant=quant,
                   device=device)

    @classmethod
    def random_init(cls, preset: str, seed: int = 0,
                    family: Optional[str] = None,
                    accel: Optional[str] = None,
                    quant: Optional[str] = None,
                    device: DeviceLike = None) -> "ModelRunner":
        """Random weights of a preset, drawn on ``device``; with
        ``quant="int8"`` each leaf is quantized as it is built.  Off the card
        bf16 presets run in f32, as the reference's off the TPU."""
        dev = resolve_device(device)
        cfg = get_config(preset)
        if dev.type != "cuda" and cfg.dtype == "bfloat16":
            cfg = cfg.replace(dtype="float32")
        xform = quantized_leaf_transform if quant == "int8" else None
        params = init_params(cfg, seed=seed, device=dev, leaf_transform=xform)
        tokenizer = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size,
                                            eos_token_id=cfg.eos_token_id or 2)
        return cls(cfg, params, tokenizer, family=family, accel=accel,
                   quant=quant, device=dev)

    # -- generation ----------------------------------------------------

    def generate_ids(self, prompt_ids, *, gen_length: int = 128,
                     steps: int = 128, block_length: int = 32,
                     temperature: float = 0.0, cfg_scale: float = 0.0,
                     remasking: str = "low_confidence", avoid_eos: bool = False,
                     top_p: Optional[float] = 0.95, alg: str = "entropy",
                     alg_temp: float = 0.0, exact: bool = False,
                     batch_mean_counts: bool = False,
                     parallel_threshold: Optional[float] = None, seed: int = 0,
                     attn_mask=None) -> np.ndarray:
        """prompt ids [P] or [B, P] → [B, P + gen_length] token ids.  The
        LLaDA families read ``block_length``, ``cfg_scale``, ``remasking``
        and ``avoid_eos``; Dream/DiffuCoder read ``top_p``, ``alg``,
        ``alg_temp``, ``exact`` and ``batch_mean_counts``."""
        prompt = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long)
        if prompt.ndim == 1:
            prompt = prompt[None]
        if attn_mask is not None:
            attn_mask = torch.as_tensor(np.asarray(attn_mask))
            if attn_mask.ndim == 1:
                attn_mask = attn_mask[None]
        threshold = (parallel_threshold if parallel_threshold is not None
                     else self.parallel_threshold)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if self.family in LLADA_FAMILIES:
            if threshold is not None:
                raise NotImplementedError(
                    "parallel_threshold decoding is not ported yet (ROADMAP "
                    "Queue 1 #4)")
            out = llada_generate(
                self.forward_fn, self.params, prompt, steps=steps,
                gen_length=gen_length, block_length=block_length,
                temperature=temperature, cfg_scale=cfg_scale,
                remasking=remasking, mask_id=self.mask_id, avoid_eos=avoid_eos,
                eos_token_id=self.eos_token_id, attn_mask=attn_mask,
                generator=gen, device=self.device)
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
        return out.cpu().numpy()

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
