"""Grouped expert GEMMs for the MoE FFN: routing layout, the CUDA kernels
for bf16 and int8 weights, their plain versions, and the weighted combine.

Counterpart of ``ops/grouped_gemm_pallas.py`` (host glue, the gate/up and
down kernels, their int8 weight-only forms and the fused megakernel).  The
padded layout is the reference's, row for row:
``tile_m`` 64 (128 for M ≥ 65536), ``m_pad = round_up(M, tile_m) +
E·tile_m``, every ``tile_m``-row tile owned by one expert
(``tile_expert``), padding rows duplicating token 0 with combine weight 0.

Kernels (``csrc/grouped_gemm.cu``): :func:`grouped_gateup` computes
``silu(x @ Wg[e]) * (x @ Wu[e])`` and :func:`grouped_down` ``h @ Wd[e]``,
weights ``[E, K, N]`` or layer-stacked ``[L, E, K, N]`` with ``layer_index``.
Their int8 forms (``csrc/grouped_gemm_q.cu``), :func:`grouped_gateup_q` and
:func:`grouped_down_q`, take quantized ``{"q": int8 [(L,) E, K, N], "s": f32
[(L,) E, N]}`` weights and compute ``silu((x @ q_g) * s_g) * ((x @ q_u) *
s_u)`` and ``(h @ q_d) * s_d``: the scale on the f32 product, as
``ops/quant.py::qdot``.  All four take the reference's optional pad-skip
vector ``tile_valid`` (a tile marked 0 holds no real row: zeros, no
product), and so does :func:`grouped_ffn_fused` (``csrc/grouped_ffn_fused.cu``),
which computes the whole FFN, ``bf16(silu(x @ Wg[e]) * (x @ Wu[e])) @
Wd[e]``, in one kernel with h kept in shared memory.
:func:`grouped_expert_ffn_cuda` takes the fused kernel instead of the bf16
pair under ``CTDB_GROUPED_FUSED=1`` (read per call) when D and F are
multiples of 128, as ``grouped_expert_ffn_pallas`` does, and F is at most
1024 (the kernel's cluster holds F / 128 CTAs, at most 8; wider experts take
the pair, which computes the same function), and always hands
the fused kernel, the bf16 and the int8 pair ``tile_valid`` (the reference
builds it only under ``CTDB_GROUPED_SKIP_PAD=1``, since a conditional write
costs its TPU kernel the pipelining; on the card the pad-skip is faster);
the FFN output is the same as without it.
A CPU tensor takes the plain version, a CUDA tensor launches the kernel or
raises.  The kernels have no backward yet: on the card the wrappers raise
when grad is enabled and an input requires it, rather than return an output
that silently drops the gradient.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import (
    INT, PTR, Kernel, Library)
from ct_diffusionmodelbench_tpu_torch.ops.quant import is_quantized

TILE_M = 64
KERNEL_ROWS = 64  # rows per CUDA block; tile_m must be a multiple

LIBRARY = Library("grouped_gemm.cu")
GATEUP_KERNEL = Kernel("grouped_gateup", LIBRARY, "ctdb_grouped_gateup",
                       [PTR] * 5 + [INT] * 7 + [PTR] * 2)
DOWN_KERNEL = Kernel("grouped_down", LIBRARY, "ctdb_grouped_down",
                     [PTR] * 4 + [INT] * 7 + [PTR] * 2)
LIBRARY_Q = Library("grouped_gemm_q.cu")
GATEUP_Q_KERNEL = Kernel("grouped_gateup_q", LIBRARY_Q, "ctdb_grouped_gateup_q",
                         [PTR] * 7 + [INT] * 6 + [PTR] * 2)
DOWN_Q_KERNEL = Kernel("grouped_down_q", LIBRARY_Q, "ctdb_grouped_down_q",
                       [PTR] * 5 + [INT] * 6 + [PTR] * 2)
LIBRARY_FUSED = Library("grouped_ffn_fused.cu")
FUSED_KERNEL = Kernel("grouped_ffn_fused", LIBRARY_FUSED, "ctdb_grouped_ffn_fused",
                      [PTR] * 6 + [INT] * 7 + [PTR] * 2)
# The fused kernel spreads one row tile's FFN over a thread block cluster of
# F / 128 CTAs; 8 is the portable cluster size, so F is at most 1024.
FUSED_MAX_F = 8 * 128


def _round_up(x, m):
    return (x + m - 1) // m * m


def expert_rank(flat: torch.Tensor, e: int):
    """(rank-within-expert [M], per-expert counts [E]) of a flat expert-id
    vector: a one-hot cumsum (stable counting sort), exact in integers.

    The one-hot is laid out [E, M] so the scan runs along the contiguous
    dim (a scan along the outer dim of [M, E] measured 3.5 ms at M = 20480,
    E = 64 on an H100)."""
    onehot = torch.arange(e, device=flat.device)[:, None] == flat[None, :]
    csum = torch.cumsum(onehot.to(torch.int32), dim=1, dtype=torch.int32)
    rank = torch.gather(csum, 0, flat[None, :].long())[0] - 1
    return rank, csum[:, -1]


def counting_layout(topk_idx: torch.Tensor, e: int, tile_m: int = TILE_M):
    """Expert-aligned padded row layout without a sort.

    topk_idx [N, K] → (dest [N·K] padded row of each routing slot in (token,
    k) order, tile_expert [m_pad / tile_m] int32, group_sizes [E] int32,
    m_pad)."""
    flat = topk_idx.reshape(-1).long()
    m = flat.shape[0]
    m_pad = _round_up(m, tile_m) + e * tile_m
    rank, sizes = expert_rank(flat, e)
    padded_sizes = _round_up(sizes, tile_m)
    pend = torch.cumsum(padded_sizes, dim=0, dtype=torch.int32)
    pstarts = pend - padded_sizes
    dest = pstarts[flat].long() + rank
    tile_start = torch.arange(m_pad // tile_m, dtype=torch.int32,
                              device=flat.device) * tile_m
    tile_expert = (pend[None, :] <= tile_start[:, None]).sum(dim=1, dtype=torch.int32)
    tile_expert = torch.clamp_max(tile_expert, e - 1)
    return dest, tile_expert, sizes, m_pad


def _layer(w: torch.Tensor, layer_index: Optional[int]) -> torch.Tensor:
    if w.ndim == 4:
        if layer_index is None:
            raise ValueError("stacked [L, E, K, N] weights need layer_index")
        return w[layer_index]
    return w


def _tiles_times_experts(x_padded, w, tile_expert, tile_m):
    """f32 product of every row tile with its own expert's weights."""
    m_pad, k = x_padded.shape
    xt = x_padded.reshape(m_pad // tile_m, tile_m, k).float()
    return torch.bmm(xt, w[tile_expert.long()].float())


def _zero_invalid_tiles(out, tile_valid):
    """Zero the [tiles, tile_m, N] products of the tiles ``tile_valid``
    marks 0 (none when it is None)."""
    if tile_valid is None:
        return out
    return out.masked_fill((tile_valid == 0)[:, None, None], 0.0)


def grouped_gateup_plain(x_padded, we_gate, we_up, tile_expert,
                         tile_m: int = TILE_M,
                         layer_index: Optional[int] = None,
                         tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gate/up kernel's function in PyTorch (f32 products); zero rows
    in the tiles ``tile_valid`` marks 0."""
    wg = _layer(we_gate, layer_index)
    wu = _layer(we_up, layer_index)
    gate = _tiles_times_experts(x_padded, wg, tile_expert, tile_m)
    up = _tiles_times_experts(x_padded, wu, tile_expert, tile_m)
    h = _zero_invalid_tiles(F.silu(gate) * up, tile_valid).to(x_padded.dtype)
    return h.reshape(x_padded.shape[0], wg.shape[-1])


def grouped_down_plain(h_padded, we_down, tile_expert, tile_m: int = TILE_M,
                       layer_index: Optional[int] = None,
                       tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The down kernel's function in PyTorch (f32 product); zero rows in
    the tiles ``tile_valid`` marks 0."""
    wd = _layer(we_down, layer_index)
    out = _tiles_times_experts(h_padded, wd, tile_expert, tile_m)
    out = _zero_invalid_tiles(out, tile_valid).to(h_padded.dtype)
    return out.reshape(h_padded.shape[0], wd.shape[-1])


def _refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a backward through a CUDA kernel here."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward on the card yet (MoE training); call it "
            "under torch.no_grad() or with inputs that do not require grad")


def _check_kernel_args(x, ws, tile_expert, tile_m, layer_index,
                       w_dtype=torch.bfloat16):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"grouped kernels need CUDA tensors, got {dev}")
    m_pad, k = x.shape
    w = ws[0]
    if w.ndim not in (3, 4):
        raise ValueError(f"expert weights must be [E,K,N] or [L,E,K,N], got {tuple(w.shape)}")
    e, wk, n = w.shape[-3:]
    for name, t, dt in [("x", x, torch.bfloat16)] + [
            (f"w{i}", wi, w_dtype) for i, wi in enumerate(ws)]:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            kind = "bf16" if dt == torch.bfloat16 else "int8"
            raise ValueError(f"{name} must be a contiguous {kind} tensor on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if any(wi.shape != w.shape for wi in ws):
        raise ValueError("gate and up weights differ in shape")
    if wk != k:
        raise ValueError(f"x has K={k}, weights K={wk}")
    # One 16-byte copy carries 8 bf16 or 16 int8 values of a row (TMA's
    # global strides, too, are multiples of 16 bytes).
    n_align = 16 // w.element_size()
    if k % 8 or n % n_align:
        raise ValueError(f"K and N must be multiples of 8 and {n_align}, "
                         f"got {k}, {n}")
    if tile_m % KERNEL_ROWS or m_pad % tile_m:
        raise ValueError(f"tile_m {tile_m} must be a multiple of {KERNEL_ROWS} "
                         f"dividing m_pad {m_pad}")
    if (tile_expert.device != dev or tile_expert.dtype != torch.int32
            or tuple(tile_expert.shape) != (m_pad // tile_m,)
            or not tile_expert.is_contiguous()):
        raise ValueError("tile_expert must be contiguous int32 [m_pad / tile_m] "
                         f"on {dev}")
    if w.ndim == 4:
        if layer_index is None or not 0 <= layer_index < w.shape[0]:
            raise ValueError(f"layer_index {layer_index} out of range for {w.shape[0]} layers")
        layer = int(layer_index)
    else:
        layer = 0
    return m_pad, k, n, e, layer


def _tile_valid_ptr(tile_valid, tile_expert) -> Optional[int]:
    """The kernel's ``tile_valid`` pointer: None (null) for none, else the
    checked vector's address; it must match ``tile_expert`` in device, type
    and shape."""
    if tile_valid is None:
        return None
    if (tile_valid.device != tile_expert.device or tile_valid.dtype != torch.int32
            or tile_valid.shape != tile_expert.shape or not tile_valid.is_contiguous()):
        raise ValueError("tile_valid must be contiguous int32 "
                         f"{tuple(tile_expert.shape)} on {tile_expert.device}")
    return tile_valid.data_ptr()


def _num_layers(w: torch.Tensor) -> int:
    """Layers of a bf16 expert stack: L of [L, E, K, N], 1 of [E, K, N]."""
    return w.shape[0] if w.ndim == 4 else 1


def grouped_gateup(x_padded, we_gate, we_up, tile_expert, tile_m: int = TILE_M,
                   layer_index: Optional[int] = None,
                   tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h [M_pad, F] = silu(x @ Wg[e]) * (x @ Wu[e]) per row tile; zeros in
    the tiles ``tile_valid`` marks 0."""
    if x_padded.device.type == "cpu":
        return grouped_gateup_plain(x_padded, we_gate, we_up, tile_expert,
                                    tile_m, layer_index, tile_valid)
    _refuse_grad("grouped_gateup", x_padded, we_gate, we_up)
    m_pad, d, f, e, layer = _check_kernel_args(
        x_padded, (we_gate, we_up), tile_expert, tile_m, layer_index)
    valid = _tile_valid_ptr(tile_valid, tile_expert)
    h = torch.empty((m_pad, f), dtype=x_padded.dtype, device=x_padded.device)
    stream = torch.cuda.current_stream(x_padded.device).cuda_stream
    GATEUP_KERNEL(x_padded.data_ptr(), we_gate.data_ptr(), we_up.data_ptr(),
                  h.data_ptr(), tile_expert.data_ptr(), m_pad, d, f, e,
                  _num_layers(we_gate), layer, tile_m, valid, stream)
    return h


def grouped_down(h_padded, we_down, tile_expert, tile_m: int = TILE_M,
                 layer_index: Optional[int] = None,
                 tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [M_pad, D] = h @ Wd[e] per row tile; zeros in the tiles
    ``tile_valid`` marks 0."""
    if h_padded.device.type == "cpu":
        return grouped_down_plain(h_padded, we_down, tile_expert, tile_m,
                                  layer_index, tile_valid)
    _refuse_grad("grouped_down", h_padded, we_down)
    m_pad, f, d, e, layer = _check_kernel_args(
        h_padded, (we_down,), tile_expert, tile_m, layer_index)
    valid = _tile_valid_ptr(tile_valid, tile_expert)
    out = torch.empty((m_pad, d), dtype=h_padded.dtype, device=h_padded.device)
    stream = torch.cuda.current_stream(h_padded.device).cuda_stream
    DOWN_KERNEL(h_padded.data_ptr(), we_down.data_ptr(), out.data_ptr(),
                tile_expert.data_ptr(), m_pad, f, d, e, _num_layers(we_down),
                layer, tile_m, valid, stream)
    return out


# ---------------------------------------------------------------------------
# fused FFN (one kernel, h on chip)
# ---------------------------------------------------------------------------

def fused_mode() -> bool:
    """``CTDB_GROUPED_FUSED``: "1" takes the fused kernel for aligned plain
    weights; anything else, or unset, leaves the pair."""
    return os.environ.get("CTDB_GROUPED_FUSED", "0") == "1"


def grouped_ffn_fused_plain(x_padded, we_gate, we_up, we_down, tile_expert,
                            tile_m: int = TILE_M,
                            layer_index: Optional[int] = None,
                            tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused kernel's function in PyTorch: the gate/up pair's plain
    version (h rounded to x's dtype, the reference's ``.astype(x.dtype)``)
    and then the down one's; zero rows in the tiles ``tile_valid`` marks 0."""
    h = grouped_gateup_plain(x_padded, we_gate, we_up, tile_expert, tile_m,
                             layer_index)
    return grouped_down_plain(h, we_down, tile_expert, tile_m, layer_index,
                              tile_valid)


def grouped_ffn_fused(x_padded, we_gate, we_up, we_down, tile_expert,
                      tile_m: int = TILE_M,
                      layer_index: Optional[int] = None,
                      tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [M_pad, D] = bf16(silu(x @ Wg[e]) * (x @ Wu[e])) @ Wd[e] per row
    tile, in one kernel; zeros in the tiles ``tile_valid`` marks 0.  D and F
    multiples of 128, F at most 1024."""
    if x_padded.device.type == "cpu":
        return grouped_ffn_fused_plain(x_padded, we_gate, we_up, we_down,
                                       tile_expert, tile_m, layer_index,
                                       tile_valid)
    if is_quantized(we_gate):
        raise ValueError("the fused FFN kernel takes bf16 weights; int8 experts "
                         "go through grouped_gateup_q / grouped_down_q")
    _refuse_grad("grouped_ffn_fused", x_padded, we_gate, we_up, we_down)
    m_pad, d, f, e, layer = _check_kernel_args(
        x_padded, (we_gate, we_up), tile_expert, tile_m, layer_index)
    want = tuple(we_gate.shape[:-2]) + (f, d)
    if (tuple(we_down.shape) != want or we_down.dtype != torch.bfloat16
            or we_down.device != x_padded.device or not we_down.is_contiguous()
            or we_down.data_ptr() % 16):
        raise ValueError(f"down weights must be a contiguous, 16-byte aligned bf16 "
                         f"{want} tensor on {x_padded.device}, got "
                         f"{we_down.dtype} {tuple(we_down.shape)}")
    if d % 128 or f % 128:
        raise ValueError(f"fused FFN needs D, F % 128 == 0, got {d}, {f}")
    if f > FUSED_MAX_F:
        raise ValueError(f"fused FFN: F={f} needs a cluster of {f // 128} CTAs of "
                         f"128 columns of h, more than the portable cluster size 8 "
                         f"(F at most {FUSED_MAX_F})")
    valid = _tile_valid_ptr(tile_valid, tile_expert)
    out = torch.empty((m_pad, d), dtype=x_padded.dtype, device=x_padded.device)
    stream = torch.cuda.current_stream(x_padded.device).cuda_stream
    FUSED_KERNEL(x_padded.data_ptr(), we_gate.data_ptr(), we_up.data_ptr(),
                 we_down.data_ptr(), out.data_ptr(), tile_expert.data_ptr(),
                 m_pad, d, f, e, _num_layers(we_gate), layer, tile_m, valid, stream)
    return out


# ---------------------------------------------------------------------------
# int8 weight-only pair
# ---------------------------------------------------------------------------

def _layer_q(w: dict, layer_index: Optional[int]):
    """(q [E, K, N], s [E, N]) of one layer of a quantized expert stack."""
    if w["q"].ndim == 4:
        if layer_index is None:
            raise ValueError("stacked [L, E, K, N] weights need layer_index")
        return w["q"][layer_index], w["s"][layer_index]
    return w["q"], w["s"]


def _tiles_times_experts_q(x_padded, w, tile_expert, tile_m, layer_index):
    """f32 product of every row tile with its expert's int8 weights, the
    expert's per-column scale applied to the product."""
    q, s = _layer_q(w, layer_index)
    acc = _tiles_times_experts(x_padded, q, tile_expert, tile_m)
    return acc * s.float()[tile_expert.long()][:, None, :]


def grouped_gateup_q_plain(x_padded, we_gate: dict, we_up: dict, tile_expert,
                           tile_m: int = TILE_M,
                           layer_index: Optional[int] = None,
                           tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 gate/up kernel's function in PyTorch: per-tile f32 products
    with ``q`` (exact in any float type), scaled before the SiLU; zero rows
    in the tiles ``tile_valid`` marks 0."""
    gate = _tiles_times_experts_q(x_padded, we_gate, tile_expert, tile_m, layer_index)
    up = _tiles_times_experts_q(x_padded, we_up, tile_expert, tile_m, layer_index)
    h = _zero_invalid_tiles(F.silu(gate) * up, tile_valid).to(x_padded.dtype)
    return h.reshape(x_padded.shape[0], we_gate["q"].shape[-1])


def grouped_down_q_plain(h_padded, we_down: dict, tile_expert,
                         tile_m: int = TILE_M,
                         layer_index: Optional[int] = None,
                         tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 down kernel's function in PyTorch: scaled before the cast;
    zero rows in the tiles ``tile_valid`` marks 0."""
    out = _tiles_times_experts_q(h_padded, we_down, tile_expert, tile_m, layer_index)
    out = _zero_invalid_tiles(out, tile_valid).to(h_padded.dtype)
    return out.reshape(h_padded.shape[0], we_down["q"].shape[-1])


def _check_scales(ws, n):
    for i, w in enumerate(ws):
        q, s = w["q"], w["s"]
        if (s.device != q.device or s.dtype != torch.float32
                or not s.is_contiguous() or tuple(s.shape) != q.shape[:-2] + (n,)):
            raise ValueError(f"s{i} must be contiguous f32 {q.shape[:-2] + (n,)} "
                             f"on {q.device}, got {s.dtype} {tuple(s.shape)}")


def grouped_gateup_q(x_padded, we_gate: dict, we_up: dict, tile_expert,
                     tile_m: int = TILE_M,
                     layer_index: Optional[int] = None,
                     tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h [M_pad, F] = silu((x @ q_g[e]) * s_g[e]) * ((x @ q_u[e]) * s_u[e])
    per row tile; zeros in the tiles ``tile_valid`` marks 0."""
    if x_padded.device.type == "cpu":
        return grouped_gateup_q_plain(x_padded, we_gate, we_up, tile_expert,
                                      tile_m, layer_index, tile_valid)
    _refuse_grad("grouped_gateup_q", x_padded)
    m_pad, d, f, e, layer = _check_kernel_args(
        x_padded, (we_gate["q"], we_up["q"]), tile_expert, tile_m, layer_index,
        w_dtype=torch.int8)
    _check_scales((we_gate, we_up), f)
    valid = _tile_valid_ptr(tile_valid, tile_expert)
    h = torch.empty((m_pad, f), dtype=x_padded.dtype, device=x_padded.device)
    stream = torch.cuda.current_stream(x_padded.device).cuda_stream
    GATEUP_Q_KERNEL(x_padded.data_ptr(), we_gate["q"].data_ptr(),
                    we_up["q"].data_ptr(), we_gate["s"].data_ptr(),
                    we_up["s"].data_ptr(), h.data_ptr(), tile_expert.data_ptr(),
                    m_pad, d, f, e, layer, tile_m, valid, stream)
    return h


def grouped_down_q(h_padded, we_down: dict, tile_expert, tile_m: int = TILE_M,
                   layer_index: Optional[int] = None,
                   tile_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out [M_pad, D] = (h @ q_d[e]) * s_d[e] per row tile; zeros in the
    tiles ``tile_valid`` marks 0."""
    if h_padded.device.type == "cpu":
        return grouped_down_q_plain(h_padded, we_down, tile_expert, tile_m,
                                    layer_index, tile_valid)
    _refuse_grad("grouped_down_q", h_padded)
    m_pad, f, d, e, layer = _check_kernel_args(
        h_padded, (we_down["q"],), tile_expert, tile_m, layer_index,
        w_dtype=torch.int8)
    _check_scales((we_down,), d)
    valid = _tile_valid_ptr(tile_valid, tile_expert)
    out = torch.empty((m_pad, d), dtype=h_padded.dtype, device=h_padded.device)
    stream = torch.cuda.current_stream(h_padded.device).cuda_stream
    DOWN_Q_KERNEL(h_padded.data_ptr(), we_down["q"].data_ptr(),
                  we_down["s"].data_ptr(), out.data_ptr(), tile_expert.data_ptr(),
                  m_pad, f, d, e, layer, tile_m, valid, stream)
    return out


def valid_tiles(sizes: torch.Tensor, tile_expert: torch.Tensor, tile_m: int,
                m_pad: int) -> torch.Tensor:
    """int32 [m_pad / tile_m]: 1 where a tile holds a real row, as the
    reference builds ``tile_valid``: the tile starts before its expert's
    last real row ends."""
    padded = _round_up(sizes, tile_m)
    pend_real = torch.cumsum(padded, 0, dtype=torch.int32) - padded + sizes
    tile_start = torch.arange(m_pad // tile_m, dtype=torch.int32,
                              device=sizes.device) * tile_m
    return (tile_start < pend_real[tile_expert.long()]).to(torch.int32)


def gather_rows(x: torch.Tensor, dest: torch.Tensor, k: int, m_pad: int):
    """x_padded [m_pad, D]: row ``dest[slot]`` holds token ``slot // k``;
    padding rows hold token 0 (their outputs get combine weight 0)."""
    m = dest.shape[0]
    token_of_slot = torch.arange(m, device=x.device) // k
    src = torch.zeros(m_pad, dtype=torch.long, device=x.device)
    src.scatter_(0, dest, token_of_slot)
    return x.index_select(0, src)


def combine(out_padded, dest, topk_probs, n: int, k: int, dtype):
    """Weighted unsort: K accumulated f32 gathers of [N, D] (the reference's
    ``kloop`` form)."""
    dest_k = dest.reshape(n, k)
    out = torch.zeros((n, out_padded.shape[1]), dtype=torch.float32,
                      device=out_padded.device)
    for kk in range(k):
        rows = out_padded.index_select(0, dest_k[:, kk])
        out.addcmul_(rows, topk_probs[:, kk][:, None])  # in f32, in place
    return out.to(dtype)


def grouped_expert_ffn_cuda(x, topk_probs, topk_idx, we_gate, we_up, we_down,
                            tile_m: int = TILE_M,
                            layer_index: Optional[int] = None) -> torch.Tensor:
    """Full expert FFN on the padded layout: x [N, D] → [N, D].

    Counterpart of ``grouped_expert_ffn_pallas``: counting layout, one row
    gather, the gate/up and down kernels (their int8 forms for quantized
    ``{"q", "s"}`` weights, which need D and F to be multiples of 128, as
    the reference's; the fused kernel instead under ``CTDB_GROUPED_FUSED=1``
    for plain weights with D and F multiples of 128 and F at most
    ``FUSED_MAX_F``, a cluster's reach), each with the pad-skip vector, then
    the weighted combine."""
    quantized = is_quantized(we_gate)
    if x.is_cuda:
        plain = [] if quantized else [we_gate, we_up, we_down]
        _refuse_grad("grouped_expert_ffn_cuda", x, topk_probs, *plain)
    n, d = x.shape
    k = topk_idx.shape[1]
    wg = we_gate["q"] if quantized else we_gate
    e, fm = wg.shape[-3], wg.shape[-1]
    aligned = d % 128 == 0 and fm % 128 == 0
    if quantized and not aligned:
        raise ValueError(f"int8 grouped FFN needs D, F % 128 == 0, got {d}, {fm}")
    if tile_m == TILE_M and n * k >= 65536:
        tile_m = 128
    dest, tile_expert, sizes, m_pad = counting_layout(topk_idx, e, tile_m)
    xs = gather_rows(x, dest, k, m_pad)
    valid = valid_tiles(sizes, tile_expert, tile_m, m_pad)
    if not quantized and aligned and fm <= FUSED_MAX_F and fused_mode():
        out_padded = grouped_ffn_fused(xs, we_gate, we_up, we_down, tile_expert,
                                       tile_m, layer_index, valid)
    else:
        gateup, down = (grouped_gateup_q, grouped_down_q) if quantized else (
            grouped_gateup, grouped_down)
        h = gateup(xs, we_gate, we_up, tile_expert, tile_m, layer_index, valid)
        out_padded = down(h, we_down, tile_expert, tile_m, layer_index, valid)
    return combine(out_padded, dest, topk_probs, n, k, x.dtype)
