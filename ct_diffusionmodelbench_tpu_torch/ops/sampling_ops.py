"""Vectorized primitives for the denoising sampler.

Counterpart of ``ops/sampling_ops.py``:

- :func:`gumbel_rescore`   — temperature sampling in log space
  (``argmax(logits - T * log(-log u))``); T = 0 returns the logits.
- :func:`token_confidence` — chosen-token softmax probability via logsumexp.
- :func:`rank_topk_mask`   — per-row top-k with a per-row k, static shapes,
  no host sync.
"""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_rescore(logits: torch.Tensor, temperature: float,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Scores whose argmax is the reference's Gumbel-trick sample.

    At T > 0 the noise comes from ``generator`` (a ``torch.Generator`` on the
    logits' device): the JAX reference draws from its own PRNG, so only the
    distribution, not the draw, matches."""
    if temperature == 0:
        return logits
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32).clamp_min(tiny)
    return logits.float() - temperature * torch.log(-torch.log(u))


def token_confidence(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """softmax(logits)[chosen] per position, computed as exp(logit - lse)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    chosen_logit = torch.gather(lf, -1, chosen[..., None].long())[..., 0]
    return torch.exp(chosen_logit - lse)


def rank_topk_mask(confidence: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Boolean mask selecting each row's top-``k[row]`` confidences.

    Ranks by a stable descending sort, so the lowest index wins ties — the
    order ``jax.numpy.argsort(-c, stable=True)`` gives in the reference.
    confidence: [B, S] float; k: [B] int."""
    order = torch.argsort(-confidence, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < k[:, None]
