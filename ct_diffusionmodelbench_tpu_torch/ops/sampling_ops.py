"""Vectorized primitives for the denoising sampler.

Counterpart of ``ops/sampling_ops.py``:

- :func:`gumbel_rescore`   — temperature sampling in log space
  (``argmax(logits - T * log(-log u))``); T = 0 returns the logits.
- :func:`token_confidence` — chosen-token softmax probability via logsumexp.
- :func:`rank_topk_mask`   — per-row top-k with a per-row k, static shapes,
  no host sync.
- :func:`rand_rows`        — the samplers' uniform draws; under a mesh
  scope whose batch is split over ``data`` (a data-parallel rank decoding
  some rows of a batch, ``parallel/mesh.py::MeshScope``) drawn for the
  whole batch and sliced to the rank's rows, so every row sees the draws it
  would see in the one-process run.
"""

from __future__ import annotations

from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.parallel.mesh import current_scope


def rand_rows(shape, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """f32 uniforms of ``shape`` (rows first) from ``generator``."""
    scope = current_scope()
    rows = None if scope is None else scope.rows
    if rows is None:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32)
    full = torch.rand((scope.batch,) + tuple(shape[1:]), generator=generator,
                      device=device, dtype=torch.float32)
    return full[rows]


def gumbel_rescore(logits: torch.Tensor, temperature: float,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Scores whose argmax is the reference's Gumbel-trick sample.

    At T > 0 the noise comes from ``generator`` (a ``torch.Generator`` on the
    logits' device): the JAX reference draws from its own PRNG, so only the
    distribution, not the draw, matches."""
    if temperature == 0:
        return logits
    tiny = torch.finfo(torch.float32).tiny
    u = rand_rows(logits.shape, generator, logits.device).clamp_min(tiny)
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
