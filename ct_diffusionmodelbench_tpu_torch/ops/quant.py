"""Weight-only int8 quantization and ``qdot``.

Counterpart of ``ops/quant.py``.  A weight ``w [.., D_in, D_out]`` becomes a
dict ``{"q": int8 [.., D_in, D_out], "s": f32 [.., D_out]}`` with
``w ≈ q * s[..., None, :]``: symmetric, per output channel.  Per-output-
channel scales commute with the product, ``x @ (q * s) == (x @ q) * s``, so
:func:`qdot` applies the scale to the f32 product and never builds a
dequantized weight.  The dict is the leaf, as in the reference, so layer
stacks, checkpoints and the forward carry it unchanged.

``qdot`` returns the product in **f32**: ``torch.matmul`` on bf16 operands
would round it to bf16, earlier than the reference does wherever it keeps
the f32 product (SwiGLU's gate/up, the LM-head logits).
"""

from __future__ import annotations

import torch

# Leaf names eligible for weight-only quantization: the big [.., in, out]
# product weights.  Norm gains, biases, the router (f32, tiny) and the
# embedding table (read by a row gather) keep the model dtype.
DENSE_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                    "ws_gate", "ws_up", "ws_down")
EXPERT_QUANT_KEYS = ("we_gate", "we_up", "we_down")
TOP_QUANT_KEYS = ("lm_head",)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def _quantize_block(w: torch.Tensor) -> dict:
    wf = w.float()
    absmax = wf.abs().amax(dim=-2)
    # XLA folds the reference's "/ 127.0" into a product with the f32
    # reciprocal; so does this, for bit-equal scales.
    s = torch.clamp_min(absmax, 1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(wf / s[..., None, :]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


@torch.no_grad()
def quantize_tensor(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: scale = absmax / 127 over the
    contraction (second-to-last) axis; round half to even, as
    ``jnp.round``.  Bit-equal to the reference's ``q`` and ``s``.

    Tensors with leading (layer, expert) axes are quantized one leading
    index at a time: the channels are independent, and the f32 staging copy
    stays one slice in size (a full ``[18, 64, 2048, 896]`` expert stack
    would need 8.5 GB of it at once)."""
    if w.ndim < 3:
        return _quantize_block(w)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        part = _quantize_block(w[i])
        q[i], s[i] = part["q"], part["s"]
    return {"q": q, "s": s}


def dequantize_tensor(t: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (t["q"].float() * t["s"][..., None, :]).to(dtype)


class _MatmulF32Out(torch.autograd.Function):
    """bf16 × bf16 → f32 product on the card, with a gradient.

    ``torch.mm(..., out_dtype=torch.float32)`` has no derivative of its own.
    The backward is the transpose of JAX's ``preferred_element_type=f32``
    dot: two products accumulated in f32, dx and dw cast to the operand
    dtypes.  The f32 cotangent is rounded to bf16 before them, so both run
    as bf16 tensor-core GEMMs (the TPU's default-precision pass also rounds
    an f32 operand to bf16)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x2.t(), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` with f32 accumulation and an f32 result; ``w`` is a plain
    tensor or a quantized ``{"q", "s"}`` dict.

    On the card, bf16 operands go to cuBLAS with an f32 output type (one
    bf16×bf16→f32 GEMM, no upcast copies); elsewhere the operands are upcast
    and multiplied in f32, which gives the same f32-accumulated product.
    Plain weights carry gradients.  An int8 ``q`` is cast to the activation
    dtype first (values ≤ 127 are exact in bf16) and the f32 product is
    scaled per column; quantized weights serve inference only."""
    if is_quantized(w):
        return qdot(x, w["q"].to(x.dtype)) * w["s"]
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        out = _MatmulF32Out.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def quantize_params(params: dict, *, experts: bool = True) -> dict:
    """A new tree with the big product weights quantized; everything else
    passes through.  ``experts=False`` keeps the routed-expert stacks in the
    model dtype."""
    out = dict(params)
    blocks = dict(params["blocks"])
    keys = DENSE_QUANT_KEYS + (EXPERT_QUANT_KEYS if experts else ())
    for k in keys:
        if k in blocks:
            blocks[k] = quantize_tensor(blocks[k])
    out["blocks"] = blocks
    for k in TOP_QUANT_KEYS:
        if k in params:
            out[k] = quantize_tensor(params[k])
    return out


def quantized_leaf_transform(name: str, tensor: torch.Tensor):
    """Per-leaf transform for ``init_params(..., leaf_transform=...)``:
    quantizes eligible leaves as they are built, so a full-size int8 init
    never holds the whole bf16 tree at once."""
    if name in DENSE_QUANT_KEYS + EXPERT_QUANT_KEYS + TOP_QUANT_KEYS:
        return quantize_tensor(tensor)
    return tensor


def place_params(params: dict, device: torch.device, quantize: bool = False) -> dict:
    """The tree on ``device``, leaf by leaf; with ``quantize`` each eligible
    plain leaf is quantized right after it arrives, so the device never
    holds the whole bf16 tree (already quantized leaves just move)."""
    def leaf(name, t):
        if is_quantized(t):
            return {k: v.to(device) for k, v in t.items()}
        t = t.to(device)
        return quantized_leaf_transform(name, t) if quantize else t

    out = {k: leaf(k, v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: leaf(k, v) for k, v in params["blocks"].items()}
    return out
