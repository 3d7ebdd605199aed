"""The (data, model) process mesh on ``torch.distributed``.

Counterpart of ``parallel/mesh.py``.  The reference drives every chip from
one process and lets XLA insert the collectives; the port runs one process
per rank (``torchrun --nproc-per-node N``, or ranks it spawns itself), every
rank running the same code.  Ranks are laid out as ``jax.make_mesh`` lays
out devices, model innermost: rank = d·model + m.  The batch splits over
``data``; attention heads, the FFN hidden, the experts and the vocabulary
split over ``model`` (megatron tensor parallelism, ``parallel/sharding.py``),
through the collectives of ``parallel/comm.py``.

:func:`init_distributed` starts the process group: ``nccl`` when each rank
has a card of its own, ``gloo`` on the CPU, and ``gloo`` on CUDA only when
asked for (``backend="gloo"``), for ranks that share a card.  It refuses
``nccl`` for ranks that would share a card: NCCL does not run two ranks on
one device.

The ``seq`` axis (ring attention) is not ported yet: ``seq > 1`` raises
(ROADMAP Queue 1 #7, part two).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def launch_hint(data: int, model: int) -> str:
    n = data * model
    return (f"a --dp {data} --tp {model} mesh needs {n} processes, one per rank: "
            f"launch with `torchrun --nproc-per-node {n} -m <entry point> ... "
            f"--dp {data} --tp {model}` (or call parallel.init_distributed in "
            f"each of {n} processes first)")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, model) mesh: the axis sizes, its
    coordinates, the process groups of its data and model axes (None for an
    axis of size 1), the backend and the device its tensors live on."""
    data: int
    model: int
    rank: int
    data_group: Optional[object]
    model_group: Optional[object]
    backend: str
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def rows(self, b: int) -> Optional[slice]:
        """This data rank's rows of a batch of ``b`` split over ``data``, or
        None where the batch stays whole on every rank (one data rank, or
        ``b`` does not divide by it: TP stays on, DP idles)."""
        if self.data == 1 or b % self.data:
            return None
        n = b // self.data
        return slice(self.data_rank * n, (self.data_rank + 1) * n)

    @property
    def host_staged(self) -> bool:
        """Whether a collective that gloo refuses on CUDA tensors must pass
        through the host (``parallel/comm.py``)."""
        return self.backend == "gloo" and self.device.type == "cuda"


@dataclass(frozen=True)
class MeshScope:
    """The active mesh and how the current call lays its batch out:
    ``batch`` is the global batch's size when each data rank holds its own
    rows of it (:meth:`Mesh.rows`), None when every rank holds the whole
    batch; ``global_aux``: the MoE load-balancing loss is computed over the
    whole batch, its statistics summed over ``data``."""
    mesh: Mesh
    batch: Optional[int] = None
    global_aux: bool = False

    @property
    def rows(self) -> Optional[slice]:
        """This rank's rows of the global batch, or None (whole batch)."""
        return None if self.batch is None else self.mesh.rows(self.batch)


# The active scope is process-wide, not a contextvar as in the reference:
# PyTorch's autograd engine runs a CUDA backward, and the recomputation of
# checkpointed blocks or CE chunks within it, on threads of its own, which
# would not see the caller's context.  One process is one rank.
_current: list = [None]


def _device_for_rank(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(data: int = 1, model: Optional[int] = None, seq: int = 1,
              device=None) -> Mesh:
    """This rank's (data, model) mesh over the initialized process group.

    ``model=None``: all remaining ranks, as the reference.  The world size
    must equal data·model.  Every rank builds every axis group, in the same
    order (``new_group`` is collective)."""
    if seq > 1:
        raise NotImplementedError(
            "the seq mesh axis (ring attention) is not ported yet "
            "(ROADMAP Queue 1 #7, part two)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model is None:
        if world % data:
            raise ValueError(f"{world} ranks not divisible by data={data}")
        model = world // data
    if data * model == 1 and world == 1:
        return Mesh(1, 1, 0, None, None, "none", _device_for_rank(device))
    if not dist.is_initialized():
        raise RuntimeError(f"no process group is initialized: {launch_hint(data, model)}")
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs WORLD_SIZE {data * model}, "
                         f"have {world}: {launch_hint(data, model)}")
    rank = dist.get_rank()
    backend = dist.get_backend()
    data_group = model_group = None
    for m in range(model):
        ranks = [d * model + m for d in range(data)]
        g = dist.new_group(ranks) if data > 1 else None
        if rank in ranks:
            data_group = g
    for d in range(data):
        ranks = [d * model + m for m in range(model)]
        g = dist.new_group(ranks) if model > 1 else None
        if rank in ranks:
            model_group = g
    return Mesh(data, model, rank, data_group, model_group, backend,
                _device_for_rank(device))


def seq_axis_size(mesh: Optional[Mesh]) -> int:
    """Ring size of the ``seq`` axis: always 1 until part two ports it."""
    return 1


def current_scope() -> Optional[MeshScope]:
    return _current[0]


def current_mesh() -> Optional[Mesh]:
    scope = _current[0]
    return None if scope is None else scope.mesh


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], batch: Optional[int] = None,
             global_aux: bool = False):
    """Activate a mesh for the scope: the forward, the MoE block and the
    samplers' draws read it.  ``batch``: see :class:`MeshScope`.  A mesh of
    one rank activates nothing."""
    if batch is not None and mesh is not None and mesh.rows(batch) is None:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"data={mesh.data}")
    saved = _current[0]
    _current[0] = (MeshScope(mesh, batch, global_aux)
                   if mesh is not None and mesh.size > 1 else None)
    try:
        yield mesh
    finally:
        _current[0] = saved


def is_main_process() -> bool:
    """Rank 0, or no process group: the rank that prints and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def ensure_distributed(data: int, model: int, device=None,
                       backend: Optional[str] = None):
    """The device of this rank of a data·model mesh: the process group is
    started from ``torchrun``'s environment if none is up; with neither, or
    with a ``WORLD_SIZE`` other than data·model, this raises with how to
    launch.  ``device`` passes through when the group is already up."""
    if dist.is_initialized():
        return device
    world = os.environ.get("WORLD_SIZE")
    if world is None or int(world) != data * model:
        raise RuntimeError(f"WORLD_SIZE is {world or 'unset'}: "
                           + launch_hint(data, model))
    return init_distributed(backend=backend, device=device)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> torch.device:
    """Start the process group; returns this rank's device.

    Reads ``torchrun``'s environment by default: ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``coordinator`` is ``host:port``), ``WORLD_SIZE``,
    ``RANK`` and ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``.  A no-op returning
    the device for one process, as the reference.  ``device``: ``"cpu"`` for
    CPU ranks (``gloo``), else the rank's card, ``cuda:<local rank mod
    cards>``.  ``backend`` None picks ``nccl`` on cards of their own and
    ``gloo`` on the CPU; ranks that share a card must ask for ``gloo``."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the ranks "
            "on the CPU with gloo")
    if on_cpu:
        dev = torch.device("cpu")
    else:
        cards = torch.cuda.device_count()
        shared = local_world > cards
        if backend is None:
            if shared:
                raise RuntimeError(
                    f"{local_world} ranks on {cards} card(s) would share a card, "
                    "which nccl refuses; pass backend='gloo' to run them on "
                    "shared cards (slow: not NVLink)")
            backend = "nccl"
        elif backend == "nccl" and shared:
            raise RuntimeError(
                f"nccl cannot run {local_world} ranks on {cards} card(s) (two "
                "ranks would share a device); use backend='gloo'")
        dev = (torch.device(device) if device is not None and torch.device(device).index
               is not None else torch.device("cuda", local_rank % max(cards, 1)))
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "gloo"
    if on_cpu and backend != "gloo":
        raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
    if num_processes <= 1 or dist.is_initialized():
        return dev
    if coordinator is None:
        coordinator = f"{env.get('MASTER_ADDR', 'localhost')}:{env.get('MASTER_PORT', '29500')}"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dev
