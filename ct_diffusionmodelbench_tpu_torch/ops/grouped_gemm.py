"""Grouped (ragged) expert GEMM dispatch for MoE FFNs.

Counterpart of ``ops/grouped_gemm.py::grouped_expert_ffn``: every call,
plain or int8-quantized weights, goes to the padded-layout path of
``ops/grouped_gemm_cuda.py`` (CUDA kernels on the card, their plain
versions on the CPU).  The port has no ragged backend, so there is nothing
else to dispatch to; the backward belongs to a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm_cuda import (
    grouped_expert_ffn_cuda)
from ct_diffusionmodelbench_tpu_torch.ops.quant import is_quantized


def grouped_expert_ffn(x: torch.Tensor, topk_probs: torch.Tensor,
                       topk_idx: torch.Tensor, we_gate, we_up, we_down,
                       layer_index: Optional[int] = None) -> torch.Tensor:
    """x [N, D], topk [N, K]; weights [E, D, Fm]/[E, Fm, D] or the
    layer-stacked [L, ...] forms with ``layer_index``, as tensors or as
    quantized ``{"q", "s"}`` dicts."""
    wg = we_gate["q"] if is_quantized(we_gate) else we_gate
    if wg.ndim == 4 and layer_index is None:
        raise ValueError(
            "stacked [L, E, D, Fm] expert weights require layer_index "
            "(defaulting to layer 0 would silently compute with the wrong "
            "layer's experts)")
    li = layer_index if wg.ndim == 4 else None
    return grouped_expert_ffn_cuda(x, topk_probs, topk_idx, we_gate, we_up,
                                   we_down, layer_index=li)
