"""LLaDA block-diffusion sampler.

Counterpart of ``sampling/llada.py``:

    x = [prompt ‖ mask_id × gen_length]
    for each semi-autoregressive block:
        counts = evenly-distributed transfer schedule over the block's masks
        for each step in the block:
            forward (LM head sliced to the block; CFG batch-doubling)
            avoid_eos: logits[..., eos] = -inf
            gumbel-noise argmax → x0
            confidence = softmax prob of x0 ('low_confidence') or uniform
            unmask exactly counts[row, step] top-confidence positions

The step index is known on the host, so the reference's block-start
``lax.cond`` is a plain ``if`` and the loop is a Python loop; the fixed
schedule reads nothing from the device on the host.  Randomness (T > 0,
``random`` remasking) comes from an explicit ``torch.Generator``.

Two opt-in modes, as the reference's:

- ``block_cache`` with ``cached_fns`` (``models/block_cache.py``): step 0
  of every block is a full refresh that also rebuilds the K/V cache, the
  block's other steps forward only the block against it.
- ``parallel_threshold``: per block, every masked position whose
  confidence clears the threshold unmasks (always at least the most
  confident one) until the block has no mask left in any row, at most
  ``block_length`` forwards; ``steps`` is not read.  The reference's
  ``while_loop`` condition becomes one host read of a flag per forward
  (:func:`block_has_mask`).  Composes with the cache and, uncached, with
  CFG.

With the tracer on (``utils/profiling.py``) each forward's step is a
``sampler.step`` span: the model call (``model.forward``, inside the
callables the sampler is handed) and ``sampler.select``, the rest of the
step (the CFG batch and mix, the EOS mask, scoring, confidence, the
transfer schedule, top-k or threshold, the write-back).  The threshold
loop's condition read lies outside the step.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device
from ct_diffusionmodelbench_tpu_torch.ops.sampling_ops import (
    gumbel_rescore, rand_rows, rank_topk_mask, token_confidence)
from ct_diffusionmodelbench_tpu_torch.sampling.schedule import get_num_transfer_tokens
from ct_diffusionmodelbench_tpu_torch.utils.profiling import span

NEG_INF = float("-inf")


@dataclass(frozen=True)
class LLaDASamplerConfig:
    steps: int = 128
    gen_length: int = 128
    block_length: int = 32
    temperature: float = 0.0
    cfg_scale: float = 0.0
    remasking: str = "low_confidence"   # low_confidence | random
    mask_id: int = 156895
    avoid_eos: bool = False
    eos_token_id: Optional[int] = None
    confidence_dtype: str = "float32"   # "bfloat16" rounds the confidence
                                        # like a bf16 reference run
    block_cache: bool = False
    parallel_threshold: Optional[float] = None

    def __post_init__(self):
        if self.gen_length % self.block_length != 0:
            raise ValueError("gen_length must be divisible by block_length")
        if self.steps % self.num_blocks != 0 and self.parallel_threshold is None:
            # Threshold decoding does not read ``steps``.
            raise ValueError("steps must be divisible by num_blocks")
        if self.remasking not in ("low_confidence", "random"):
            raise NotImplementedError(self.remasking)
        if self.block_cache and self.cfg_scale > 0.0:
            raise NotImplementedError(
                "CFG batch-doubling is not supported with block_cache — "
                "use the exact sampler for cfg_scale > 0")

    @property
    def num_blocks(self) -> int:
        return self.gen_length // self.block_length

    @property
    def steps_per_block(self) -> int:
        return self.steps // self.num_blocks


def _supports_logit_slice(forward_fn) -> bool:
    try:
        return "logit_start" in inspect.signature(forward_fn).parameters
    except (TypeError, ValueError):
        return False


def block_has_mask(x_blk: torch.Tensor, mask_id: int) -> bool:
    """Whether any row of the block still holds a mask: the threshold
    loop's condition, read on the host (one device sync)."""
    return bool((x_blk == mask_id).any())


def _denoise_loop(forward_fn, sc: LLaDASamplerConfig, x: torch.Tensor,
                  prompt_len: int, attn_mask: Optional[torch.Tensor],
                  generator: Optional[torch.Generator],
                  supports_slice: Optional[bool] = None,
                  cached_fns=None) -> torch.Tensor:
    """x: [B, P+G] token ids, updated in place block by block.
    ``cached_fns``: (refresh, step) with the params bound, read when
    ``sc.block_cache``."""
    bl = sc.block_length
    prompt_index = x != sc.mask_id
    sliced = (supports_slice if supports_slice is not None
              else _supports_logit_slice(forward_fn))
    use_cache = cached_fns is not None and sc.block_cache
    cache = {}

    def avoid_eos(logits):
        if sc.avoid_eos and sc.eos_token_id is not None:
            logits = logits.clone()
            logits[..., sc.eos_token_id] = NEG_INF
        return logits

    def block_logits(block_start, first):
        """The block's logits, before the EOS mask; with the cache,
        ``first`` (a block's first forward) refreshes it and later forwards
        read it."""
        if use_cache:
            refresh_fn, step_fn = cached_fns
            if first:
                logits, cache["k"], cache["v"] = refresh_fn(x, attn_mask, block_start, bl)
            else:
                logits = step_fn(x[:, block_start:block_start + bl], block_start,
                                 cache["k"], cache["v"], attn_mask)
            return logits
        kw = dict(logit_start=block_start, logit_length=bl) if sliced else {}
        if sc.cfg_scale > 0.0:
            with span("sampler.select"):
                un_x = torch.where(prompt_index, sc.mask_id, x)
                both = torch.cat([x, un_x], dim=0)
                m = None if attn_mask is None else torch.cat([attn_mask, attn_mask], dim=0)
            logits, _ = forward_fn(both, m, **kw)
            with span("sampler.select"):
                cond, uncond = logits.chunk(2, dim=0)
                logits = uncond + (sc.cfg_scale + 1.0) * (cond - uncond)
        else:
            logits, _ = forward_fn(x, attn_mask, **kw)
        if not sliced:
            logits = logits[:, block_start:block_start + bl]
        return logits

    def score(logits, x_blk):
        mask_blk = x_blk == sc.mask_id
        scores = gumbel_rescore(logits, sc.temperature, generator)
        x0 = torch.argmax(scores, dim=-1).to(x_blk.dtype)
        if sc.remasking == "low_confidence":
            x0_p = token_confidence(logits, x0)
            if sc.confidence_dtype == "bfloat16":
                x0_p = x0_p.to(torch.bfloat16).float()
        else:
            x0_p = rand_rows(x_blk.shape, generator, x_blk.device)
        x0 = torch.where(mask_blk, x0, x_blk)
        confidence = torch.where(mask_blk, x0_p, NEG_INF)
        return x0, confidence, mask_blk

    if sc.parallel_threshold is not None:
        thr = sc.parallel_threshold
        for block in range(sc.num_blocks):
            block_start = prompt_len + block * bl
            x_blk = x[:, block_start:block_start + bl]
            it = 0
            while it < bl and block_has_mask(x_blk, sc.mask_id):
                with span("sampler.step"):
                    logits = block_logits(block_start, it == 0)
                    with span("sampler.select"):
                        x0, confidence, mask_blk = score(avoid_eos(logits), x_blk)
                        forced = F.one_hot(confidence.argmax(dim=-1), bl).bool()
                        transfer = ((confidence > thr) | forced) & mask_blk
                        x[:, block_start:block_start + bl] = torch.where(transfer, x0, x_blk)
                it += 1
        return x

    spb = sc.steps_per_block
    counts = None
    for s in range(sc.steps):
        block, i = divmod(s, spb)
        block_start = prompt_len + block * bl
        x_blk = x[:, block_start:block_start + bl]
        with span("sampler.step"):
            logits = block_logits(block_start, i == 0)
            with span("sampler.select"):
                # The forward leaves x as it was: the block's schedule may
                # be read after it.
                if i == 0:
                    counts = get_num_transfer_tokens(x_blk == sc.mask_id, spb)
                x0, confidence, _ = score(avoid_eos(logits), x_blk)
                transfer = rank_topk_mask(confidence, counts[:, i])
                x[:, block_start:block_start + bl] = torch.where(transfer, x0, x_blk)
    return x


def make_llada_sampler(forward_fn: Callable, sampler_config: LLaDASamplerConfig,
                       prompt_len: int, cached_fns=None) -> Callable:
    """``sample(params, prompt_ids, attn_mask=None, generator=None) ->
    [B, P+G]`` for a fixed (prompt_len, config).  ``forward_fn(params,
    input_ids, attn_mask, ...)`` is a ``make_forward_fn`` result;
    ``cached_fns`` (``models.block_cache.make_cached_fns``) is required when
    ``sampler_config.block_cache`` is set."""
    sc = sampler_config
    if sc.block_cache and cached_fns is None:
        raise ValueError("block_cache=True needs cached_fns "
                         "(models.block_cache.make_cached_fns(cfg))")
    supports_slice = _supports_logit_slice(forward_fn)

    @torch.inference_mode()
    def sample(params, prompt_ids, attn_mask=None, generator=None):
        B = prompt_ids.shape[0]
        gen = torch.full((B, sc.gen_length), sc.mask_id, dtype=prompt_ids.dtype,
                         device=prompt_ids.device)
        x = torch.cat([prompt_ids, gen], dim=1)
        full_mask = None
        if attn_mask is not None:
            ones = torch.ones((B, sc.gen_length), dtype=attn_mask.dtype,
                              device=attn_mask.device)
            full_mask = torch.cat([attn_mask, ones], dim=1)
        fwd = lambda ids, m, **kw: forward_fn(params, ids, m, **kw)  # noqa: E731
        bound = None
        if cached_fns is not None and sc.block_cache:
            refresh_fn, step_fn, _ = cached_fns
            bound = (lambda ids, m, bs, bl: refresh_fn(params, ids, m, bs, bl),
                     lambda blk, bs, kc, vc, m: step_fn(params, blk, bs, kc, vc, m))
        return _denoise_loop(fwd, sc, x, prompt_len, full_mask, generator,
                             supports_slice=supports_slice, cached_fns=bound)

    return sample


def llada_generate(forward_fn: Callable, params, prompt_ids: torch.Tensor, *,
                   steps: int = 128, gen_length: int = 128,
                   block_length: int = 32, temperature: float = 0.0,
                   cfg_scale: float = 0.0, remasking: str = "low_confidence",
                   mask_id: int = 156895, avoid_eos: bool = False,
                   eos_token_id: Optional[int] = None,
                   confidence_dtype: str = "float32", block_cache: bool = False,
                   cached_fns=None,
                   parallel_threshold: Optional[float] = None,
                   attn_mask: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """Counterpart of the reference ``llada_generate``: returns
    [B, prompt_len + gen_length] token ids on ``device``.  ``block_cache``
    with ``cached_fns`` (``models.block_cache.make_cached_fns``): the
    dual-cache decode, approximate for deep models."""
    dev = resolve_device(device)
    sc = LLaDASamplerConfig(
        steps=steps, gen_length=gen_length, block_length=block_length,
        temperature=temperature, cfg_scale=cfg_scale, remasking=remasking,
        mask_id=mask_id, avoid_eos=avoid_eos, eos_token_id=eos_token_id,
        confidence_dtype=confidence_dtype, block_cache=block_cache,
        parallel_threshold=parallel_threshold)
    prompt_ids = prompt_ids.to(dev)
    if attn_mask is not None:
        attn_mask = attn_mask.to(dev)
    sampler = make_llada_sampler(forward_fn, sc, int(prompt_ids.shape[1]),
                                 cached_fns=cached_fns)
    return sampler(params, prompt_ids, attn_mask=attn_mask, generator=generator)
