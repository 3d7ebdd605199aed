"""The collectives of tensor and data parallelism, written out.

No counterpart in the reference: there XLA inserts every collective from
the ``NamedSharding`` annotations (GSPMD).  Here each one is a call, and the
megatron operators are ``torch.autograd.Function``s so that the training
step differentiates through them:

- :func:`copy_to_model`: identity forward, ``all_reduce`` over ``model``
  backward.  Put on a replicated tensor where it enters a sharded product
  (or a replicated weight used by sharded work, such as the per-head
  qk-norm gain), whose gradient each rank holds only in part.
- :func:`reduce_from_model`: ``all_reduce`` over ``model`` forward, in
  **f32** (the reference reduces the f32 partials and casts once), identity
  backward.
- :func:`gather_from_model`: ``all_gather`` over ``model`` along the last
  dimension forward (the vocab-sharded logits), this rank's slice backward.
- :func:`sum_over_data`: ``all_reduce`` over ``data`` both ways, for
  statistics of the whole batch that every data rank's loss reads (the MoE
  load-balancing loss): the backward sums the data ranks' cotangents, so
  that the training step's gradient mean over ``data`` gives the
  single-device gradient.
- :func:`mean_over_data`: the data-parallel gradient mean, in place.

``gloo`` reduces CUDA tensors itself but refuses some other collectives
on them; :func:`_staged` passes such a tensor through the host,
the one place where that happens, and counts it.  :data:`COUNTS` counts
every collective by kind (``host_staged`` the staged ones);
:func:`timed` adds their wall seconds (each collective then synchronizes the
device before and after it, which costs the overlap it would have had).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from ct_diffusionmodelbench_tpu_torch.parallel.mesh import Mesh, current_mesh

COUNTS = {"all_reduce": 0, "all_gather": 0, "host_staged": 0}
SECONDS = {"total": 0.0}
_TIMING = {"on": False}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    SECONDS["total"] = 0.0


@contextlib.contextmanager
def timed():
    """Sum the collectives' wall seconds into ``SECONDS["total"]``."""
    _TIMING["on"] = True
    try:
        yield SECONDS
    finally:
        _TIMING["on"] = False


@contextlib.contextmanager
def _collective(kind: str, t: torch.Tensor):
    COUNTS[kind] += 1
    if not _TIMING["on"]:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        SECONDS["total"] += time.perf_counter() - t0


def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can take it: on the host for gloo ranks on
    CUDA (counted), else ``t`` itself."""
    if mesh.host_staged and t.is_cuda:
        COUNTS["host_staged"] += 1
        return t.cpu()
    return t


def all_reduce_(t: torch.Tensor, group, mesh: Mesh) -> torch.Tensor:
    """In-place sum over ``group`` (gloo takes CUDA tensors here)."""
    with _collective("all_reduce", t):
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, mesh: Mesh, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    with _collective("all_gather", t):
        src = _staged(mesh, t.contiguous())
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _model_mesh() -> Optional[Mesh]:
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.model > 1 else None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.to(torch.float32, copy=True)
        all_reduce_(g32, ctx.mesh.model_group, ctx.mesh)
        return g32.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.detach().to(torch.float32, copy=True)
        return all_reduce_(y, mesh.model_group, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.n = x.shape[-1]
        return all_gather(x.detach(), mesh.model_group, mesh, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.model_rank * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.detach().to(torch.float32, copy=True)
        return all_reduce_(y, mesh.data_group, mesh)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32, copy=True)
        return all_reduce_(g, ctx.mesh.data_group, ctx.mesh), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    mesh = _model_mesh()
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of the model ranks' partials (f32 out; the caller casts
    once)."""
    mesh = _model_mesh()
    return x.float() if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    mesh = _model_mesh()
    return x if mesh is None else _GatherFromModel.apply(x, mesh)


def sum_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x.float() if mesh.data == 1 else _SumOverData.apply(x, mesh)


@torch.no_grad()
def mean_over_data(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor, in place, the mean of its data ranks' values (summed in
    f32 for a bf16 buffer)."""
    if mesh.data == 1:
        return
    for t in tensors:
        if t.dtype == torch.float32:
            all_reduce_(t, mesh.data_group, mesh).div_(mesh.data)
        else:
            t32 = t.float()
            all_reduce_(t32, mesh.data_group, mesh)
            t.copy_(t32.div_(mesh.data))
