"""Masked-diffusion SFT objective.

Counterpart of ``train/diffusion_loss.py``, the same semantics step for
step: ``t ~ U(0, 1)`` per row, ``p_mask = (1 - eps)·t + eps``, tokens masked
where a second uniform draw falls below it; the prompt is restored; per
masked token the cross-entropy is weighted by ``1/p_mask`` and
``1/answer_length``, summed and divided by the batch size (or by the real
rows under ``row_mask``); NaN/inf guards per token and on the whole loss;
zero loss when nothing was masked.  ``mask_variant`` ``'recompute'`` (CE only
where the model sees the mask id) or ``'pre_restore'`` (the pre-restore
mask).

Noise: ``jax.random`` bits cannot be reproduced in PyTorch, so the draws are
either taken from a ``torch.Generator`` (``t`` first, then ``u``, per call)
or given explicitly as ``(t [B], u [B, L])``, which lets the tests feed both
frameworks the same numbers.

Under a mesh scope that splits the sequence over ``seq``
(``parallel/mesh.py``) the batch holds this rank's slice of each row: the
prompt is located and the answer length computed on the whole row, and the
loss's numerator, the masked-token count and the masked CE's numerator are
summed over ``seq`` (``parallel/comm.py::sum_over_seq``, whose backward is
the identity: the training step sums the gradients over ``seq``), so every
seq rank returns the whole rows' loss and metrics.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ct_diffusionmodelbench_tpu_torch.parallel.comm import sum_over_seq
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import current_scope

Noise = Union[torch.Generator, Tuple[torch.Tensor, torch.Tensor]]


def draw_noise(noise: Noise, b: int, l: int, device: torch.device):
    """(t [B], u [B, L]) f32 uniforms on ``device``."""
    if isinstance(noise, torch.Generator):
        t = torch.rand((b,), generator=noise, device=device, dtype=torch.float32)
        u = torch.rand((b, l), generator=noise, device=device, dtype=torch.float32)
        return t, u
    t, u = noise
    return (t.to(device=device, dtype=torch.float32),
            u.to(device=device, dtype=torch.float32))


def forward_process(input_ids: torch.Tensor, mask_id: int, noise: Noise,
                    eps: float = 1e-3):
    """Noising: returns (noisy_batch, masked_indices, p_mask), all [B, L]."""
    b, l = input_ids.shape
    t, u = draw_noise(noise, b, l, input_ids.device)
    p_mask = (1.0 - eps) * t + eps
    p_mask = p_mask[:, None].expand(b, l)
    masked_indices = u < p_mask
    noisy_batch = torch.where(masked_indices, mask_id, input_ids)
    return noisy_batch, masked_indices, p_mask


def _chunked_ce(head_fn: Callable, params: dict, hidden: torch.Tensor,
                input_ids: torch.Tensor, chunk: int):
    """(lse, target_logit), both [B, L] f32, ``chunk`` positions at a time,
    each chunk's head product and logsumexp recomputed in the backward so
    only [B, chunk, V] logits are ever live."""
    def one(h_c, id_c):
        logits = head_fn(params, h_c).float()                  # [B, C, V]
        lse = torch.logsumexp(logits, dim=-1)
        tl = logits.gather(-1, id_c[..., None].long())[..., 0]
        return lse, tl

    parts = [checkpoint(one, hidden[:, s:s + chunk], input_ids[:, s:s + chunk],
                        use_reentrant=False)
             for s in range(0, hidden.shape[1], chunk)]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1))


def diffusion_sft_loss(
    forward_fn: Callable,
    params: dict,
    input_ids: torch.Tensor,       # [B, L] int
    prompt_lengths: torch.Tensor,  # [B] int
    mask_id: int,
    noise: Noise,
    aux_coef: float = 0.01,
    eps: float = 1e-3,
    attn_mask: Optional[torch.Tensor] = None,
    mask_variant: str = "recompute",
    row_mask: Optional[torch.Tensor] = None,
    head_fn: Optional[Callable] = None,
    ce_chunk: int = 0,
):
    """Scalar loss + metrics dict (detached f32 scalars).

    ``head_fn`` + ``ce_chunk``: chunked cross-entropy; ``forward_fn`` then
    takes a keyword ``return_hidden`` and returns the final hidden states.
    A ``ce_chunk`` that does not divide L shrinks to L's largest divisor
    >= 64 (unchunked below that), as in the reference."""
    if mask_variant not in ("recompute", "pre_restore"):
        raise ValueError(f"unknown mask_variant {mask_variant!r}")
    b, l = input_ids.shape
    noisy, pre_restore_mask, p_mask = forward_process(input_ids, mask_id, noise, eps)
    p_mask = torch.clamp(p_mask, 1e-6, 1.0)

    scope = current_scope()
    lo, whole = 0, l
    if scope is not None and scope.positions is not None:
        lo, whole = scope.positions.start, scope.seq_len
    else:
        scope = None
    positions = torch.arange(lo, lo + l, device=input_ids.device)[None, :]
    prompt_region = positions < prompt_lengths[:, None]
    noisy = torch.where(prompt_region, input_ids, noisy)   # never noise the prompt

    answer_lengths = torch.clamp_min(whole - prompt_lengths, 1).float()  # [B]

    if head_fn is not None and ce_chunk and l % ce_chunk:
        ce_chunk = next((c for c in range(min(ce_chunk, l), 63, -1)
                         if l % c == 0), 0)
    if head_fn is not None and ce_chunk and l % ce_chunk == 0:
        hidden, aux = forward_fn(params, noisy, attn_mask, return_hidden=True)
        lse, target_logit = _chunked_ce(head_fn, params, hidden, input_ids,
                                        ce_chunk)
    else:
        logits, aux = forward_fn(params, noisy, attn_mask)
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        target_logit = logits.gather(-1, input_ids[..., None].long())[..., 0]

    if mask_variant == "pre_restore":
        masked = pre_restore_mask
    else:
        masked = (noisy == mask_id) & (input_ids != mask_id)
    token_loss = lse - target_logit                                   # CE, [B, L]
    token_loss = torch.nan_to_num(token_loss, nan=0.0, posinf=10.0, neginf=0.0)
    token_loss = token_loss / p_mask / answer_lengths[:, None]

    w = masked.float()
    denom = torch.tensor(float(b), device=input_ids.device)
    if row_mask is not None:
        row_mask = row_mask.to(device=input_ids.device, dtype=torch.float32)
        w = w * row_mask[:, None]
        denom = torch.clamp_min(row_mask.sum(), 1.0)
    sums = torch.stack([torch.sum(token_loss * w), torch.sum(w),
                        torch.sum((lse - target_logit).detach() * w)])
    if scope is not None:
        sums = sum_over_seq(sums, scope.mesh)
    loss = sums[0] / denom
    n_masked = sums[1].detach()

    if aux_coef:
        loss = loss + aux_coef * aux

    loss = torch.where(torch.isnan(loss) | torch.isinf(loss), 1.0, loss)
    loss = torch.where(n_masked > 0, loss, 0.0)

    metrics = {
        "loss": loss.detach(),
        "aux_loss": aux.detach().float(),
        "masked_tokens": n_masked,
        "masked_ce": (sums[2] / torch.clamp_min(n_masked, 1.0)).detach(),
    }
    return loss, metrics
