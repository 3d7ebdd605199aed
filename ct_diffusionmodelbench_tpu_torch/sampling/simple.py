"""Debug and baseline samplers.

Counterpart of ``sampling/simple.py``:

- :func:`simple_generate`: greedy left-to-right mask filling, one position
  per full forward, argmax with the mask token banned, stop at the first
  EOS (positions after it stay masked).
- :func:`ar_generate`: cache-less autoregressive decoding over a causal
  model (``ModelConfig.causal``), greedy or temperature / top-p sampling,
  the baseline behind ``cli/chat_base.py``.

The reference's ``lax.fori_loop`` is a Python loop; nothing in it reads a
device value on the host.  Randomness comes from an explicit
``torch.Generator``, or the Gumbel noise of each step is passed in
(``gumbel``), so a test can feed both frameworks the same draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

NEG_INF = -1e30
TOP_P_CANDIDATES = 1024   # the reference's top-k before the nucleus rule


def _as_batch(prompt_ids) -> torch.Tensor:
    prompt = torch.as_tensor(prompt_ids)
    return prompt[None] if prompt.ndim == 1 else prompt


@torch.inference_mode()
def simple_generate(forward_fn: Callable, params, prompt_ids, *, mask_id: int,
                    max_tokens: int = 100,
                    eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Greedy L2R mask filling: [B, P] or [P] → [B, P + max_tokens];
    positions after a row's first EOS remain ``mask_id``."""
    prompt = _as_batch(prompt_ids)
    b, p = prompt.shape
    fill = torch.full((b, max_tokens), mask_id, dtype=prompt.dtype,
                      device=prompt.device)
    x = torch.cat([prompt, fill], dim=1)
    done = torch.zeros((b,), dtype=torch.bool, device=x.device)
    for i in range(max_tokens):
        pos = p + i
        logits, _ = forward_fn(params, x, None)
        row = logits[:, pos, :].clone()
        row[:, mask_id] = NEG_INF
        tok = torch.argmax(row, dim=-1).to(x.device, x.dtype)
        x[:, pos] = torch.where(done, torch.full_like(tok, mask_id), tok)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
    return x


def _sample_row(logits: torch.Tensor, temperature: float, top_p: Optional[float],
                gumbel: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Next token of each row: argmax at T <= 0, else the Gumbel-max sample
    of ``logits / T`` (restricted to the top-p nucleus of the 1024 largest
    with ``top_p < 1``)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    work = logits.float() / temperature
    idx = None
    if top_p is not None and top_p < 1.0:
        # Stable descending order: ties in the lowest index first, as
        # lax.top_k orders them.
        vals, idx = torch.sort(work, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :TOP_P_CANDIDATES], idx[..., :TOP_P_CANDIDATES]
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        work = torch.where((cum - probs) > top_p, NEG_INF, vals)
    if gumbel is None:
        u = torch.rand(work.shape, generator=generator, device=work.device,
                       dtype=torch.float32).clamp_min(1e-20)
        gumbel = -torch.log(-torch.log(u))
    choice = torch.argmax(work + gumbel.to(work.device), dim=-1)
    if idx is None:
        return choice
    return torch.gather(idx, -1, choice[..., None])[..., 0]


@torch.inference_mode()
def ar_generate(forward_fn: Callable, params, prompt_ids, *,
                max_new_tokens: int = 256, temperature: float = 0.0,
                top_p: Optional[float] = None,
                eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Cache-less autoregressive decoding on a causal model: [B, P] or [P]
    → [B, P + max_new_tokens]; positions after a row's EOS hold
    ``pad_token_id``.

    ``gumbel[i]``: the Gumbel noise of step i ([B, V], or [B, 1024] with
    ``top_p < 1``); without it the noise comes from ``generator``."""
    prompt = _as_batch(prompt_ids)
    b, p = prompt.shape
    fill = torch.full((b, max_new_tokens), pad_token_id, dtype=prompt.dtype,
                      device=prompt.device)
    x = torch.cat([prompt, fill], dim=1)
    done = torch.zeros((b,), dtype=torch.bool, device=x.device)
    for i in range(max_new_tokens):
        pos = p + i
        logits, _ = forward_fn(params, x, None)
        tok = _sample_row(logits[:, pos - 1, :], temperature, top_p,
                          None if gumbel is None else gumbel[i], generator)
        tok = tok.to(x.device, x.dtype)
        x[:, pos] = torch.where(done, torch.full_like(tok, pad_token_id), tok)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
    return x
