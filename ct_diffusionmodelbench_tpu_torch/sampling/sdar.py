"""SDAR block-diffusion sampler over the exact prefix KV cache.

    pad the prompt on the left to a multiple of block_length
    prefill the prompt into the cache (models/sdar_cache.py)
    for each block, in order:
        x_blk = mask_id × block_length
        for each of steps_per_block steps:
            logits = the block's tokens against the cache
            avoid_eos: logits[..., eos] = -inf
            x0 = argmax (greedy; Gumbel noise at T > 0)
            confidence = softmax prob of x0 at the masked positions
            unmask the block_length / steps_per_block most confident
        commit: the finished block's K and V into the cache

Static low-confidence remasking: every step unmasks the same count, the
transfer schedule of ``sampling/schedule.py`` (the LLaDA sampler's).  The
loop reads nothing from the device on the host.

The sampler calls the model only through the three functions of
``block_fns`` (``models/sdar_cache.py::make_sdar_fns``; the runner holds
them at ``ModelRunner.block_fns``), so a caller that wraps them sees every
pass.  With the tracer on (``utils/profiling.py``) the prefill, each
denoising step and each commit are ``sdar.prefill``, ``sdar.step`` and
``sdar.commit`` spans, the parents of their pass's ``model.forward``; a
step's selection after its model call is ``sampler.select``; the counters
``sdar.steps`` and ``sdar.commits`` count them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device
from ct_diffusionmodelbench_tpu_torch.ops.sampling_ops import (
    gumbel_rescore, rank_topk_mask, token_confidence)
from ct_diffusionmodelbench_tpu_torch.sampling.schedule import get_num_transfer_tokens
from ct_diffusionmodelbench_tpu_torch.utils.profiling import count, span


def pad_to_blocks(prompt_ids: torch.Tensor, attn_mask: Optional[torch.Tensor],
                  block_length: int):
    """(ids, mask, pad): the prompt left-padded (id 0, mask 0) to a multiple
    of ``block_length``, so the first generated block starts a block."""
    B, P = prompt_ids.shape
    pad = -P % block_length
    mask = (torch.ones_like(prompt_ids, dtype=torch.int32) if attn_mask is None
            else attn_mask.to(torch.int32))
    if pad:
        prompt_ids = torch.cat([prompt_ids.new_zeros((B, pad)), prompt_ids], dim=1)
        mask = torch.cat([mask.new_zeros((B, pad)), mask], dim=1)
    return prompt_ids, mask, pad


@torch.inference_mode()
def sdar_generate(block_fns, params, prompt_ids: torch.Tensor, *, block_length: int,
                  gen_length: int = 256, steps: int = 256, mask_id: int = 151669,
                  temperature: float = 0.0, remasking: str = "low_confidence",
                  avoid_eos: bool = False, eos_token_id: Optional[int] = None,
                  attn_mask: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None) -> torch.Tensor:
    """prompt ids [B, P] (left-padded under ``attn_mask``) → [B, P +
    gen_length] token ids on ``device``: ``gen_length / block_length``
    blocks of ``steps / (gen_length / block_length)`` steps each.
    ``block_length`` is the model's own (``cfg.block_length``, the blocks
    its attention is causal over), which ``ModelRunner`` passes."""
    if gen_length % block_length:
        raise ValueError("gen_length must be divisible by block_length")
    n_blocks = gen_length // block_length
    if steps % n_blocks:
        raise ValueError("steps must be divisible by gen_length / block_length")
    spb = steps // n_blocks
    if remasking != "low_confidence":
        raise NotImplementedError(f"SDAR decodes with static low-confidence remasking, "
                                  f"not {remasking!r}")
    dev = resolve_device(device)
    prefill_fn, step_fn, commit_fn = block_fns
    ids, mask, pad = pad_to_blocks(prompt_ids, attn_mask, block_length)
    real_keys = int(mask.sum())       # host tensors: no device read
    ids, mask = ids.to(dev), mask.to(dev)
    B, P = ids.shape
    with span("sdar.prefill"):
        cache = prefill_fn(params, ids, mask, P + gen_length, real_keys)
    out = torch.cat([ids, torch.full((B, gen_length), mask_id, dtype=ids.dtype,
                                     device=dev)], dim=1)
    blank = torch.full((B, block_length), mask_id, dtype=ids.dtype, device=dev)
    counts = get_num_transfer_tokens(blank == mask_id, spb)
    for block in range(n_blocks):
        start = P + block * block_length
        x_blk = blank
        for i in range(spb):
            count("sdar.steps", 1)
            with span("sdar.step"):
                logits = step_fn(params, cache, x_blk, start)
                with span("sampler.select"):
                    if avoid_eos and eos_token_id is not None:
                        logits[..., eos_token_id] = float("-inf")
                    masked = x_blk == mask_id
                    x0 = torch.argmax(gumbel_rescore(logits, temperature, generator),
                                      dim=-1).to(x_blk.dtype)
                    conf = torch.where(masked, token_confidence(logits, x0),
                                       float("-inf"))
                    transfer = rank_topk_mask(conf, counts[:, i])
                    x_blk = torch.where(transfer, x0, x_blk)
        count("sdar.commits", 1)
        with span("sdar.commit"):
            commit_fn(params, cache, x_blk, start)
        out[:, start:start + block_length] = x_blk
    return out[:, pad:]
