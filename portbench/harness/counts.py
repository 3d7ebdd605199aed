"""Model FLOPs of a forward pass, for the ``mfu`` metrics.

A frozen copy of the program's ``ModelConfig.forward_flops``: the matrix
products only, 2·m·n·k each, over one row of ``seq_len`` real tokens
(padding is not counted), with the LM head over ``head_width`` positions
(the block-sliced head of the LLaDA sampler) or all of them.
"""

from __future__ import annotations

from typing import Dict, Optional


def forward_flops(s: Dict, seq_len: int, head_width: Optional[int] = None) -> float:
    d, S = s["hidden_size"], seq_len
    q = s["num_heads"] * s["head_dim"]
    kv = s["num_kv_heads"] * s["head_dim"]
    head_w = S if head_width is None else head_width
    attn_proj = 2 * S * (d * q + 2 * d * kv + q * d)
    attn_mix = 4 * S * S * q
    if s["num_experts"]:
        fm = s["moe_intermediate_size"]
        ffn = 2 * S * 3 * d * fm * (s["num_experts_per_tok"] + s["num_shared_experts"])
        ffn += 2 * S * d * s["num_experts"]
    else:
        ffn = 2 * S * 3 * d * s["intermediate_size"]
    return float(s["num_layers"] * (attn_proj + attn_mix + ffn)
                 + 2 * head_w * d * s["vocab_size"])


def calls_flops(s: Dict, calls) -> float:
    """The summed :func:`forward_flops` of forward passes (``Call``: each
    row's real tokens, and the LM head's positions a row)."""
    return sum(forward_flops(s, n, c.head) for c in calls for n in c.rows)
