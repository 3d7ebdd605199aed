"""The model step's elementwise glue: RMSNorm and the SwiGLU activation,
their CUDA kernels, plain versions and autograd wrappers.

No Pallas kernel is replaced: on the TPU, XLA fuses the reference's
``models/layers.py::rms_norm`` and the ``silu(gate) * up`` of its
``swiglu`` into their neighbours.  Eager PyTorch runs each as a chain of
kernels over f32 copies, so ``csrc/glue.cu`` makes one pass over each
(bound by bytes on the card; the source's note has the design):

- :func:`rms_norm` ``(x, scale, eps)``: x ``[..., D]`` bf16 or f32, scale
  ``[D]``; ``cast(f32(x) · rsqrt(mean(f32(x)²) + eps) · f32(scale))`` in
  x's dtype.  The kernel differs from :func:`rms_norm_plain` only in the
  order of the sum, so by at most one rounding of the output.
- :func:`swiglu_act` ``(gate, up, out_dtype)``: gate and up f32 (as
  ``ops/quant.py::qdot`` returns them); ``cast(silu(gate) · up)``,
  bit-equal to :func:`swiglu_act_plain`.

Dispatch: a CPU tensor takes the plain version, under PyTorch's own
autograd.  A CUDA tensor launches the kernel or raises; with grad enabled
and an input that requires it, through :class:`RMSNorm` / :class:`SwiGLUAct`
(forward: the kernel; backward: the f32 derivative in PyTorch), as
``ops/flash_attention.py::flash_attention`` does.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import (
    FLOAT, INT, INT64, PTR, Kernel, Library, dtype_code)
from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm import _silu_grads

MAX_ROW_BYTES = 4096 * 16   # the kernel's widest row: 1024 threads × 4 vectors

LIBRARY = Library("glue.cu")
RMS_NORM_KERNEL = Kernel("rms_norm", LIBRARY, "ctdb_rms_norm",
                         [PTR, PTR, PTR, INT64, INT, INT, INT, FLOAT, FLOAT, PTR])
SWIGLU_ACT_KERNEL = Kernel("swiglu_act", LIBRARY, "ctdb_swiglu_act",
                           [PTR, PTR, PTR, INT64, INT, INT, PTR])


def _f32(v: float) -> float:
    return ctypes.c_float(v).value


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def swiglu_act_plain(gate: torch.Tensor, up: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    return (F.silu(gate) * up).to(out_dtype)


def _check_aligned(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch ``ctdb_rms_norm``: x contiguous ``[..., D]``, D a multiple of
    8; one block a row for D > 1024, one warp a row below."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rms_norm_cuda needs CUDA tensors, got {dev}")
    d = x.shape[-1]
    x_code = dtype_code("x", x.dtype)
    s_code = dtype_code("scale", scale.dtype)
    if d % 8 or d * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"rms_norm_cuda needs D a multiple of 8 and at most "
                         f"{MAX_ROW_BYTES} bytes a row, got D {d} in {x.dtype}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale has shape {tuple(scale.shape)}, expected ({d},)")
    _check_aligned("x", x, dev)
    _check_aligned("scale", scale, dev)
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    # PyTorch's mean multiplies the sum by f32(rows) / f32(rows * D).
    mean_factor = _f32(rows) / _f32(rows * d)
    RMS_NORM_KERNEL(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
                    x_code, s_code, mean_factor, eps,
                    torch.cuda.current_stream(dev).cuda_stream)
    return y


def swiglu_act_cuda(gate: torch.Tensor, up: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``ctdb_swiglu_act``: gate and up contiguous f32 of one shape."""
    dev = gate.device
    if dev.type != "cuda":
        raise ValueError(f"swiglu_act_cuda needs CUDA tensors, got {dev}")
    if gate.dtype != torch.float32 or up.dtype != torch.float32:
        raise ValueError(f"gate and up must be float32, got {gate.dtype} and {up.dtype}")
    if gate.shape != up.shape:
        raise ValueError(f"gate {tuple(gate.shape)} and up {tuple(up.shape)} differ")
    out_code = dtype_code("out", out_dtype)
    _check_aligned("gate", gate, dev)
    _check_aligned("up", up, dev)
    out = torch.empty(gate.shape, dtype=out_dtype, device=dev)
    if gate.numel():
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        SWIGLU_ACT_KERNEL(gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(),
                          out_code, sms, torch.cuda.current_stream(dev).cuda_stream)
    return out


def rms_norm_grads(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, d_scale) of y = x̂ · s, x̂ = x · r, r = rsqrt(mean(x²) + eps):

        dx = r · (s·g − x̂ · mean(x̂ · s·g)),   d_scale = Σ_rows g · x̂

    in f32 (f64 stays f64), cast to x's and scale's dtypes."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf, gf = x.to(ct), g.to(ct)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    sg = scale.to(ct) * gf
    dx = r * (sg - xhat * torch.mean(xhat * sg, dim=-1, keepdim=True))
    d_scale = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), d_scale.to(scale.dtype)


class RMSNorm(torch.autograd.Function):
    """RMSNorm with the f32 derivative of :func:`rms_norm_grads`; saves x
    and scale only (r is recomputed)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, d_scale = rms_norm_grads(x, scale, ctx.eps, g)
        return (dx if ctx.needs_input_grad[0] else None,
                d_scale if ctx.needs_input_grad[1] else None, None)


class SwiGLUAct(torch.autograd.Function):
    """silu(gate) · up cast to ``out_dtype``, with the f32 derivative of
    ``ops/grouped_gemm.py::_silu_grads``."""

    @staticmethod
    def forward(ctx, gate, up, out_dtype):
        ctx.save_for_backward(gate, up)
        return swiglu_act_cuda(gate, up, out_dtype)

    @staticmethod
    def backward(ctx, dh):
        gate, up = ctx.saved_tensors
        _, d_gate, d_up = _silu_grads(gate, up, dh)
        return d_gate.to(gate.dtype), d_up.to(up.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over x's last dim, in x's dtype (see the module's note)."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return rms_norm_cuda(x, scale, eps)


def swiglu_act(gate: torch.Tensor, up: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """silu(gate) · up of the f32 gate and up products, cast to
    ``out_dtype`` (see the module's note)."""
    if gate.device.type == "cpu":
        return swiglu_act_plain(gate, up, out_dtype)
    if torch.is_grad_enabled() and (gate.requires_grad or up.requires_grad):
        return SwiGLUAct.apply(gate, up, out_dtype)
    return swiglu_act_cuda(gate, up, out_dtype)
