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
- :func:`sum_over_seq`: ``all_reduce`` over ``seq`` forward, identity
  backward, for a sum whose result every seq rank's loss reads alike while
  the gradients are summed over ``seq`` afterwards (the loss's numerator,
  the MoE statistics under sequence parallelism).
- :func:`gather_from_seq`: the seq ranks' slices concatenated along the
  sequence, backward the sum of every rank's cotangent, then this rank's
  slice.
- :func:`shift_seq`: a tensor from the previous seq rank (a ring shift by
  one; seq rank 0 keeps a tensor of its own), backward the reverse shift,
  which every seq rank takes part in.
- :func:`ring_shift` / :func:`exchange`: point-to-point transfers
  (``dist.batch_isend_irecv``, each send paired with its receive and issued
  in the same order on every rank), for the ring attention's K / V chunks
  and the pipeline's activations.

``gloo`` reduces CUDA tensors itself but refuses some other collectives
on them; :func:`_staged` passes such a tensor through the host,
the one place where that happens, and counts it.  :data:`COUNTS` counts
every collective by kind (``host_staged`` the staged ones);
:func:`timed` adds their wall seconds, in all and by kind (each collective
then synchronizes the device before and after it, which costs the overlap
it would have had).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ct_diffusionmodelbench_tpu_torch.parallel.mesh import Mesh, current_mesh

COUNTS = {"all_reduce": 0, "all_gather": 0, "p2p": 0, "host_staged": 0}
SECONDS = {"total": 0.0, **{k: 0.0 for k in COUNTS if k != "host_staged"}}
_TIMING = {"on": False}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    for k in SECONDS:
        SECONDS[k] = 0.0


@contextlib.contextmanager
def timed():
    """Sum the collectives' wall seconds into ``SECONDS["total"]`` and
    ``SECONDS[kind]``."""
    _TIMING["on"] = True
    try:
        yield SECONDS
    finally:
        _TIMING["on"] = False


@contextlib.contextmanager
def _collective(kind: str, t: torch.Tensor):
    COUNTS[kind] += 1
    with _collective_timing(t, kind):
        yield


@contextlib.contextmanager
def _collective_timing(t: torch.Tensor, kind: str):
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
        dt = time.perf_counter() - t0
        SECONDS["total"] += dt
        SECONDS[kind] += dt


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


def exchange(mesh: Mesh, sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[tuple, torch.dtype, int]],
             device: torch.device) -> List[torch.Tensor]:
    """Send each ``(tensor, global rank)`` and receive each ``(shape,
    dtype, global rank)``, all in one batch: the tensors received, on
    ``device``.  Sends to and receives from one peer pair up in order, so
    every rank lists them in the same order.  ``COUNTS["p2p"]`` counts the
    tensors sent."""
    if not sends and not recvs:
        return []
    staged = mesh.host_staged and device.type == "cuda"
    probe = sends[0][0] if sends else torch.empty(0, device=device)
    COUNTS["p2p"] += len(sends)
    with _collective_timing(probe, "p2p"):
        srcs = [_staged(mesh, t.contiguous()) for t, _ in sends]
        bufs = [torch.empty(shape, dtype=dt, device="cpu" if staged else device)
                for shape, dt, _ in recvs]
        ops = [dist.P2POp(dist.isend, t, peer) for t, (_, peer) in zip(srcs, sends)]
        ops += [dist.P2POp(dist.irecv, b, peer) for b, (_, _, peer) in zip(bufs, recvs)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = [b.to(device) for b in bufs]
    return out


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh,
               reverse: bool = False) -> List[torch.Tensor]:
    """Each tensor from the previous seq rank (this rank's go to the next),
    or the other way round with ``reverse``."""
    me, step = mesh.seq_rank, (-1 if reverse else 1)
    nxt, prv = mesh.mid_peer(me + step), mesh.mid_peer(me - step)
    return exchange(mesh, [(t, nxt) for t in tensors],
                    [(t.shape, t.dtype, prv) for t in tensors], tensors[0].device)


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


class _SumOverSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.detach().to(torch.float32, copy=True)
        return all_reduce_(y, mesh.seq_group, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.n = x.shape[1]
        return all_gather(x.detach(), mesh.seq_group, mesh, dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g32 = g.to(torch.float32, copy=True)
        all_reduce_(g32, mesh.seq_group, mesh)
        lo = mesh.seq_rank * ctx.n
        return g32[:, lo:lo + ctx.n].to(g.dtype).contiguous(), None


class _ShiftSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, last, first, mesh):
        ctx.mesh = mesh
        prev = ring_shift([last.detach()], mesh)[0]
        return first.detach().clone() if mesh.seq_rank == 0 else prev

    @staticmethod
    def backward(ctx, g):
        # Every seq rank runs the reverse transfer; seq rank 0's output is
        # its own first row, so it sends the last rank a zero gradient.
        mesh, g = ctx.mesh, g.contiguous()
        head = mesh.seq_rank == 0
        back = ring_shift([torch.zeros_like(g) if head else g], mesh, reverse=True)[0]
        return back, (g if head else None), None


def sum_over_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The f32 sum over ``seq`` (identity backward)."""
    return x.float() if mesh.seq == 1 else _SumOverSeq.apply(x, mesh)


def gather_from_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, S/sp, ...] slices → [B, S, ...] on every seq rank."""
    return x if mesh.seq == 1 else _GatherFromSeq.apply(x, mesh)


def shift_seq(last: torch.Tensor, first: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The previous seq rank's ``last``; seq rank 0 takes its own ``first``."""
    return first if mesh.seq == 1 else _ShiftSeq.apply(last, first, mesh)


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
def _reduce_in_place(tensors: Iterable[torch.Tensor], group, n: int, mesh: Mesh,
                     mean: bool) -> None:
    for t in tensors:
        t32 = t if t.dtype == torch.float32 else t.float()
        all_reduce_(t32, group, mesh)
        if mean:
            t32.div_(n)
        if t32 is not t:
            t.copy_(t32)


def mean_over_data(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor, in place, the mean of its data ranks' values (summed in
    f32 for a bf16 buffer)."""
    if mesh.data > 1:
        _reduce_in_place(tensors, mesh.data_group, mesh.data, mesh, mean=True)


def sum_over_seq_(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Each tensor, in place, the sum of its seq ranks' values (in f32 for
    a bf16 buffer): the gradient of the loss over the whole sequence."""
    if mesh.seq > 1:
        _reduce_in_place(tensors, mesh.seq_group, mesh.seq, mesh, mean=False)
