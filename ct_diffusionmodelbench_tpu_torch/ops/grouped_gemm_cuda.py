"""Grouped expert GEMMs for the MoE FFN: routing layout, the CUDA kernels
for bf16 and int8 weights, their plain versions, and the weighted combine.

Counterpart of ``ops/grouped_gemm_pallas.py`` (host glue, the gate/up and
down kernels, their int8 weight-only forms and the fused megakernel).  The
padded layout is the reference's, row for row:
``tile_m`` 64 (128 for M ≥ 65536), ``m_pad = round_up(M, tile_m) +
E·tile_m``, every ``tile_m``-row tile owned by one expert
(``tile_expert``), padding rows with combine weight 0 (they duplicate
token 0 on the CPU; the card leaves them unwritten, see G5 below).

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
raises.  The kernels compute forwards only: the bf16 FFN's backward is
``ops/grouped_gemm.py``'s autograd wrapper, which calls
:func:`ffn_padded` under it.  Called directly on the card with grad enabled
and an input that requires it, each wrapper raises rather than return an
output that silently drops the gradient; the int8 pair always does, as
int8 weights are inference-only in the reference too.

The weighted combine after the down product, :func:`combine`, is G3 on the
card (``csrc/moe_combine.cu``): one kernel for the reference's k-loop of
gathers, scales and f32 sums, bit-equal to :func:`combine_plain`, the
PyTorch chain that the CPU takes; it too raises under grad.

The routing before the expert kernels is two kernels on the card
(``csrc/moe_route.cu``).  :func:`router_topk` is G4: the router's softmax,
stable top-k and renormalisation from its f32 logits (or, in its sigmoid
mode, DeepSeek-V3's biased sigmoid selection and scaled weights), bit-equal
to :func:`router_topk_plain`, the chain that the CPU takes; under grad its
backward (:func:`router_topk_backward`) is the chain's autograd written
out, so training launches G4 too.  :func:`routed_layout` is G5: the padded
layout, the pad-skip vector and the row gather in one call, equal to
:func:`routed_layout_plain` (:func:`counting_layout`, :func:`valid_tiles`
and :func:`gather_rows`), which the CPU takes, in every index and every
real row; G5 leaves the pad rows unwritten, since only rows of the expert
kernels' outputs that the combine never reads depend on them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import (
    FLOAT, INT, INT64, PTR, Kernel, Library, dtype_code)
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
LIBRARY_COMBINE = Library("moe_combine.cu")
COMBINE_KERNEL = Kernel("moe_combine", LIBRARY_COMBINE, "ctdb_moe_combine",
                        [PTR] * 4 + [INT] * 3 + [INT64] * 3 + [INT] * 2 + [PTR])
LIBRARY_ROUTE = Library("moe_route.cu")
TOPK_KERNEL = Kernel("moe_topk", LIBRARY_ROUTE, "ctdb_moe_topk",
                     [PTR] * 4 + [INT] * 4 + [PTR])
TOPK_SIGMOID_KERNEL = Kernel("moe_topk_sigmoid", LIBRARY_ROUTE, "ctdb_moe_topk_sigmoid",
                             [PTR] * 5 + [INT] * 4 + [FLOAT, PTR])
LAYOUT_KERNEL = Kernel("moe_layout", LIBRARY_ROUTE, "ctdb_moe_layout",
                       [PTR, INT64, INT64] + [PTR] * 4 + [INT64] + [PTR] * 3 + [INT] * 7
                       + [PTR])
# G4 keeps a row of at most 32 columns a lane in one warp and repeats
# PyTorch's sum of a k-slice of at most 32; G5 ranks 2048 routing slots a
# count CTA, keeps per-warp counts of at most 512 groups (the experts and the
# dropped group) and stages at most 64 rows a token.
TOPK_MAX_EXPERTS, TOPK_MAX_K = 1024, 32
LAYOUT_CHUNK, LAYOUT_MAX_GROUPS, LAYOUT_MAX_K = 2048, 512, 64


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


def layout_tile_m(m: int, tile_m: int = TILE_M) -> int:
    """The row tile the layout takes for ``m`` routed rows: 128 from 65536
    rows up where the caller left the default, as the reference's."""
    return 128 if tile_m == TILE_M and m >= 65536 else tile_m


def padded_rows(m: int, e: int, tile_m: int) -> int:
    """m_pad of the layout: every expert's group rounded up to whole tiles
    fits in round_up(m, tile_m) + e·tile_m rows."""
    return _round_up(m, tile_m) + e * tile_m


def counting_layout(topk_idx: torch.Tensor, e: int, tile_m: int = TILE_M,
                    drop_foreign: bool = False):
    """Expert-aligned padded row layout without a sort.

    topk_idx [N, K] → (dest [N·K] padded row of each routing slot in (token,
    k) order, tile_expert [m_pad / tile_m] int32, group_sizes [E] int32,
    m_pad).

    ``drop_foreign`` (expert parallelism): ``topk_idx`` may hold ``e``, a
    slot of an expert another rank holds.  Those slots form one more group
    after the experts' (m_pad counts it); its tiles name expert e - 1 and
    lie past that expert's real rows, so :func:`valid_tiles` marks them
    empty and the kernels write zeros there."""
    flat = topk_idx.reshape(-1).long()
    m = flat.shape[0]
    groups = e + 1 if drop_foreign else e
    m_pad = padded_rows(m, groups, tile_m)
    rank, sizes = expert_rank(flat, groups)
    padded_sizes = _round_up(sizes, tile_m)
    pend = torch.cumsum(padded_sizes, dim=0, dtype=torch.int32)
    pstarts = pend - padded_sizes
    dest = pstarts[flat].long() + rank
    tile_start = torch.arange(m_pad // tile_m, dtype=torch.int32,
                              device=flat.device) * tile_m
    tile_expert = (pend[None, :] <= tile_start[:, None]).sum(dim=1, dtype=torch.int32)
    tile_expert = torch.clamp_max(tile_expert, e - 1)
    return dest, tile_expert, sizes[:e], m_pad


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
    """Raise if autograd would need a backward through a CUDA kernel here:
    the kernels have none of their own.  bf16 experts train through
    ``ops/grouped_gemm.py::grouped_expert_ffn``, whose autograd wrapper
    launches the kernels with grad off; int8 experts are inference-only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} launches a kernel with no backward of its own: train bf16 "
            "experts through "
            "ops/grouped_gemm.py::grouped_expert_ffn (int8 experts do not "
            "train), or call it under torch.no_grad()")


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


# ---------------------------------------------------------------------------
# routing: the router's top-k (G4) and the padded layout with its rows (G5)
# ---------------------------------------------------------------------------

def router_topk_plain(logits: torch.Tensor, top_k: int, norm_topk: bool,
                      sigmoid: bool = False, bias: Optional[torch.Tensor] = None,
                      scale: float = 1.0):
    """(topk_probs [N, K] f32, topk_idx [N, K] int64, full_probs [N, E] f32)
    of the router's f32 logits: softmax, a stable descending sort (ties to
    the lowest expert index, as ``jax.lax.top_k`` orders them; ``torch.topk``
    on CUDA does not promise that), the first K, renormalised to sum 1 with
    ``norm_topk``.

    ``sigmoid`` (DeepSeek-V3's ``noaux_tc`` router with one group): the
    sigmoid of the logits, sorted the same way after adding the f32
    selection ``bias`` [E] (or nothing), the first K's unbiased scores
    renormalised by their sum + 1e-20 with ``norm_topk``, times ``scale``
    (HF's ``DeepseekV3TopkRouter`` op for op)."""
    if sigmoid:
        scores = torch.sigmoid(logits)
        choice = scores if bias is None else scores + bias.float()
        order = torch.sort(choice, dim=-1, descending=True, stable=True)[1]
        topk_idx = order[:, :top_k]
        topk_probs = scores.gather(-1, topk_idx)
        if norm_topk:
            topk_probs = topk_probs / (topk_probs.sum(dim=-1, keepdim=True) + 1e-20)
        return topk_probs * scale, topk_idx, scores
    probs = torch.softmax(logits, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_probs = sorted_p[:, :top_k]
    topk_idx = order[:, :top_k]
    if norm_topk:
        topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True)
    return topk_probs, topk_idx, probs


def router_topk_cuda(logits: torch.Tensor, top_k: int, norm_topk: bool,
                     sigmoid: bool = False, bias: Optional[torch.Tensor] = None,
                     scale: float = 1.0):
    """Launch G4 (``ctdb_moe_topk``, or ``ctdb_moe_topk_sigmoid`` with
    ``sigmoid``) on contiguous f32 logits [N, E], E at most
    ``TOPK_MAX_EXPERTS``, 1 ≤ K ≤ min(E, ``TOPK_MAX_K``); ``bias`` a
    contiguous f32 [E] on the same card or None; returns contiguous
    outputs.  Shape and dtype are checked before the device."""
    if logits.ndim != 2 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be float32 [N, E], got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    n, e = logits.shape
    if not 1 <= e <= TOPK_MAX_EXPERTS:
        raise ValueError(f"G4 takes 1 to {TOPK_MAX_EXPERTS} experts, got {e}")
    if not 1 <= top_k <= min(e, TOPK_MAX_K):
        raise ValueError(f"top_k must lie in [1, {min(e, TOPK_MAX_K)}], got {top_k}")
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"router_topk_cuda needs a CUDA tensor, got {dev}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (e,)
                             or bias.device != dev or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 [{e}] on {dev}, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    probs = torch.empty_like(logits)
    topk_probs = torch.empty((n, top_k), dtype=torch.float32, device=dev)
    topk_idx = torch.empty((n, top_k), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if n and sigmoid:
        TOPK_SIGMOID_KERNEL(logits.data_ptr(), None if bias is None else bias.data_ptr(),
                            probs.data_ptr(), topk_probs.data_ptr(), topk_idx.data_ptr(),
                            n, e, top_k, int(bool(norm_topk)), float(scale), stream)
    elif n:
        TOPK_KERNEL(logits.data_ptr(), probs.data_ptr(), topk_probs.data_ptr(),
                    topk_idx.data_ptr(), n, e, top_k, int(bool(norm_topk)), stream)
    return topk_probs, topk_idx, probs


def router_topk_backward(probs, topk_idx, norm_topk: bool, g_topk, g_probs):
    """The logits' gradient of :func:`router_topk_plain` from the saved
    softmax ``probs`` and ``topk_idx`` and the cotangents of (topk_probs,
    full_probs): the chain's autograd op by op (the renormalisation's
    quotient and sum, the sort's scatter, the softmax's backward)."""
    if norm_topk:
        raw = probs.gather(-1, topk_idx)
        s = raw.sum(dim=-1, keepdim=True)
        g_topk = g_topk / s + (-g_topk * ((raw / s) / s)).sum(dim=-1, keepdim=True)
    g = torch.zeros_like(probs).scatter_(-1, topk_idx, g_topk) + g_probs
    return torch._softmax_backward_data(g, probs, -1, probs.dtype)


class _RouterTopk(torch.autograd.Function):
    """G4 forward, :func:`router_topk_backward` backward."""

    @staticmethod
    def forward(ctx, logits, top_k, norm_topk):
        topk_probs, topk_idx, probs = router_topk_cuda(logits, top_k, norm_topk)
        ctx.mark_non_differentiable(topk_idx)
        ctx.save_for_backward(probs, topk_idx)
        ctx.norm_topk = norm_topk
        return topk_probs, topk_idx, probs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_topk, _, g_probs):
        probs, topk_idx = ctx.saved_tensors
        return (router_topk_backward(probs, topk_idx, ctx.norm_topk, g_topk, g_probs),
                None, None)


def router_topk(logits: torch.Tensor, top_k: int, norm_topk: bool, sigmoid: bool = False,
                bias: Optional[torch.Tensor] = None, scale: float = 1.0):
    """The router's top-k from its f32 logits [N, E] (see
    :func:`router_topk_plain`).  G4 on the card, bit-equal to the chain run
    there, with or without grad (the sigmoid mode without grad only); the
    chain itself on the CPU."""
    if logits.device.type == "cpu":
        return router_topk_plain(logits, top_k, norm_topk, sigmoid, bias, scale)
    if torch.is_grad_enabled() and logits.requires_grad:
        if sigmoid:
            raise NotImplementedError("G4's sigmoid mode has no backward")
        return _RouterTopk.apply(logits, top_k, norm_topk)
    return router_topk_cuda(logits, top_k, norm_topk, sigmoid, bias, scale)


def routed_layout_cuda(x: torch.Tensor, topk_idx: torch.Tensor, e: int, tile_m: int,
                       drop_foreign: bool = False):
    """Launch G5 (``ctdb_moe_layout``): x contiguous bf16 or f32 [N, D] with
    16-byte rows, 16-byte aligned; ``topk_idx`` int64 [N, K] of any strides,
    K at most ``LAYOUT_MAX_K``.  Returns :func:`routed_layout`'s tuple; the
    pad rows of x_padded are left as allocated.  Shapes, dtypes and sizes
    are checked before the device."""
    if x.ndim != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    dtype_code("x", x.dtype)
    n, d = x.shape
    if (d * x.element_size()) % 16:
        raise ValueError(f"G5 copies 16-byte words: a row of x holds {d * x.element_size()} "
                         "bytes")
    if topk_idx.dtype != torch.int64 or topk_idx.ndim != 2 or topk_idx.shape[0] != n:
        raise ValueError(f"topk_idx must be int64 [{n}, K], got {topk_idx.dtype} "
                         f"{tuple(topk_idx.shape)}")
    k = topk_idx.shape[1]
    if not 1 <= k <= LAYOUT_MAX_K:
        raise ValueError(f"G5 takes 1 to {LAYOUT_MAX_K} slots a token, got {k}")
    groups = e + 1 if drop_foreign else e
    if e < 1 or groups > LAYOUT_MAX_GROUPS:
        raise ValueError(f"G5 takes 1 to {LAYOUT_MAX_GROUPS} groups, got {groups}")
    if tile_m < 1:
        raise ValueError(f"tile_m must be positive, got {tile_m}")
    m = n * k
    m_pad = padded_rows(m, groups, tile_m)
    if m_pad >= 2 ** 31:
        raise ValueError(f"m_pad {m_pad} needs 64-bit row indices")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"routed_layout_cuda needs CUDA tensors, got {dev}")
    if topk_idx.device != dev:
        raise ValueError(f"topk_idx must be on {dev}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    tiles = m_pad // tile_m
    chunks = max(1, -(-m // LAYOUT_CHUNK))
    x_padded = torch.empty((m_pad, d), dtype=x.dtype, device=dev)
    dest = torch.empty(m, dtype=torch.int64, device=dev)
    # One int32 allocation for the chunks' bases and the three outputs.
    base, sizes, tile_expert, tile_valid = torch.empty(
        chunks * groups + e + 2 * tiles, dtype=torch.int32, device=dev).split(
            [chunks * groups, e, tiles, tiles])
    LAYOUT_KERNEL(topk_idx.data_ptr(), topk_idx.stride(0), topk_idx.stride(1), x.data_ptr(),
                  x_padded.data_ptr(), dest.data_ptr(), base.data_ptr(), base.numel(),
                  sizes.data_ptr(), tile_expert.data_ptr(), tile_valid.data_ptr(), n, k,
                  groups, e, tile_m, tiles, d * x.element_size() // 16,
                  torch.cuda.current_stream(dev).cuda_stream)
    return x_padded, dest, tile_expert, sizes, tile_valid


def routed_layout_plain(x: torch.Tensor, topk_idx: torch.Tensor, e: int,
                        tile_m: int = TILE_M, drop_foreign: bool = False):
    """:func:`routed_layout` as the PyTorch chain: :func:`counting_layout`,
    :func:`gather_rows` (pad rows hold token 0) and :func:`valid_tiles`."""
    dest, tile_expert, sizes, m_pad = counting_layout(topk_idx, e, tile_m, drop_foreign)
    x_padded = gather_rows(x, dest, topk_idx.shape[1], m_pad)
    return x_padded, dest, tile_expert, sizes, valid_tiles(sizes, tile_expert, tile_m, m_pad)


def routed_layout(x: torch.Tensor, topk_idx: torch.Tensor, e: int, tile_m: int = TILE_M,
                  drop_foreign: bool = False):
    """The expert kernels' inputs: (x_padded [m_pad, D], dest [N·K] int64,
    tile_expert, sizes [E], tile_valid), m_pad being :func:`padded_rows`.
    The CPU takes :func:`routed_layout_plain`; G5 on the card gives the
    same indices and real rows and leaves the pad rows unwritten (the
    combine never reads what they feed).  Forward only (see
    :func:`_refuse_grad`)."""
    if x.device.type == "cpu":
        return routed_layout_plain(x, topk_idx, e, tile_m, drop_foreign)
    _refuse_grad("routed_layout", x)
    return routed_layout_cuda(x, topk_idx, e, tile_m, drop_foreign)


def combine_plain(out_padded, dest, topk_probs, n: int, k: int, dtype):
    """Weighted unsort: K accumulated f32 gathers of [N, D] (the reference's
    ``kloop`` form), as a PyTorch chain."""
    dest_k = dest.reshape(n, k)
    out = torch.zeros((n, out_padded.shape[1]), dtype=torch.float32,
                      device=out_padded.device)
    for kk in range(k):
        rows = out_padded.index_select(0, dest_k[:, kk])
        out.addcmul_(rows, topk_probs[:, kk][:, None])  # in f32, in place
    return out.to(dtype)


def combine_cuda(out_padded, dest, topk_probs, n: int, k: int, dtype) -> torch.Tensor:
    """Launch G3 (``ctdb_moe_combine``): ``out_padded`` contiguous [m_pad, D],
    D a multiple of 8, bf16 or f32; ``dest`` contiguous int64 [N·K];
    ``topk_probs`` f32 [N, K] of any strides (the router's top-k slice).
    The operands' shapes and dtypes are checked before their device."""
    if out_padded.ndim != 2:
        raise ValueError(f"out_padded must be [m_pad, D], got {tuple(out_padded.shape)}")
    m_pad, d = out_padded.shape
    rows_code = dtype_code("out_padded", out_padded.dtype)
    out_code = dtype_code("the output", dtype)
    if topk_probs.dtype != torch.float32:
        raise ValueError(f"topk_probs must be float32, got {topk_probs.dtype}")
    if d % 8:
        raise ValueError(f"combine needs D a multiple of 8, got {d}")
    if dest.dtype != torch.int64 or tuple(dest.shape) != (n * k,):
        raise ValueError(f"dest must be int64 ({n * k},), got {dest.dtype} "
                         f"{tuple(dest.shape)}")
    if tuple(topk_probs.shape) != (n, k):
        raise ValueError(f"topk_probs must be ({n}, {k}), got {tuple(topk_probs.shape)}")
    dev = out_padded.device
    if dev.type != "cuda":
        raise ValueError(f"combine_cuda needs CUDA tensors, got {dev}")
    if dest.device != dev or topk_probs.device != dev:
        raise ValueError(f"dest and topk_probs must be on {dev}")
    if not out_padded.is_contiguous() or out_padded.data_ptr() % 16:
        raise ValueError("out_padded must be contiguous and 16-byte aligned")
    if not dest.is_contiguous():
        raise ValueError("dest must be contiguous")
    out = torch.empty((n, d), dtype=dtype, device=dev)
    if n:
        COMBINE_KERNEL(out_padded.data_ptr(), dest.data_ptr(), topk_probs.data_ptr(),
                       out.data_ptr(), n, k, d, m_pad, topk_probs.stride(0),
                       topk_probs.stride(1), rows_code, out_code,
                       torch.cuda.current_stream(dev).cuda_stream)
    return out


def combine(out_padded, dest, topk_probs, n: int, k: int, dtype):
    """Weighted unsort of the padded rows into [N, D] in ``dtype``:
    token n gets the f32 sum over its slots j of ``out_padded[dest[n·k +
    j]] · topk_probs[n, j]``, in slot order.  :func:`combine_plain` on the
    CPU, G3 on the card (bit-equal); forward only (see
    :func:`_refuse_grad`)."""
    if out_padded.device.type == "cpu":
        return combine_plain(out_padded, dest, topk_probs, n, k, dtype)
    _refuse_grad("combine", out_padded, topk_probs)
    return combine_cuda(out_padded, dest, topk_probs, n, k, dtype)


def ffn_padded(x, topk_idx, we_gate, we_up, we_down, tile_m: int = TILE_M,
               layer_index: Optional[int] = None, drop_foreign: bool = False):
    """The expert FFN's rows on the padded layout, before the combine:
    (out_padded [m_pad, D], dest [N·K], group sizes [E], tile_m).  The
    layout and its rows (:func:`routed_layout`, G5 on the card), then the
    gate/up and down kernels (their int8 forms for quantized ``{"q", "s"}``
    weights, which need D and F to be multiples of 128, as the reference's;
    the fused kernel instead
    under ``CTDB_GROUPED_FUSED=1`` for plain weights with D and F multiples
    of 128 and F at most ``FUSED_MAX_F``, a cluster's reach), each with the
    pad-skip vector.  ``drop_foreign``: see :func:`counting_layout`; the
    dropped slots' rows come out zero."""
    quantized = is_quantized(we_gate)
    n, d = x.shape
    k = topk_idx.shape[1]
    wg = we_gate["q"] if quantized else we_gate
    e, fm = wg.shape[-3], wg.shape[-1]
    aligned = d % 128 == 0 and fm % 128 == 0
    if quantized and not aligned:
        raise ValueError(f"int8 grouped FFN needs D, F % 128 == 0, got {d}, {fm}")
    tile_m = layout_tile_m(n * k, tile_m)
    xs, dest, tile_expert, sizes, valid = routed_layout(x, topk_idx, e, tile_m,
                                                        drop_foreign)
    if not quantized and aligned and fm <= FUSED_MAX_F and fused_mode():
        out_padded = grouped_ffn_fused(xs, we_gate, we_up, we_down, tile_expert,
                                       tile_m, layer_index, valid)
    else:
        gateup, down = (grouped_gateup_q, grouped_down_q) if quantized else (
            grouped_gateup, grouped_down)
        h = gateup(xs, we_gate, we_up, tile_expert, tile_m, layer_index, valid)
        out_padded = down(h, we_down, tile_expert, tile_m, layer_index, valid)
    return out_padded, dest, sizes, tile_m


def grouped_expert_ffn_cuda(x, topk_probs, topk_idx, we_gate, we_up, we_down,
                            tile_m: int = TILE_M,
                            layer_index: Optional[int] = None,
                            drop_foreign: bool = False) -> torch.Tensor:
    """Full expert FFN on the padded layout: x [N, D] → [N, D].

    Counterpart of ``grouped_expert_ffn_pallas``: :func:`ffn_padded`, then
    the weighted combine.  Forward only (see :func:`_refuse_grad`)."""
    if x.is_cuda:
        plain = [] if is_quantized(we_gate) else [we_gate, we_up, we_down]
        _refuse_grad("grouped_expert_ffn_cuda", x, topk_probs, *plain)
    out_padded, dest, *_ = ffn_padded(x, topk_idx, we_gate, we_up, we_down,
                                      tile_m, layer_index, drop_foreign)
    n, k = topk_idx.shape
    return combine(out_padded, dest, topk_probs, n, k, x.dtype)
