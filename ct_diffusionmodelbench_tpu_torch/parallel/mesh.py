"""The (data[, seq | stage], model) process mesh on ``torch.distributed``.

Counterpart of ``parallel/mesh.py``.  The reference drives every chip from
one process and lets XLA insert the collectives; the port runs one process
per rank (``torchrun --nproc-per-node N``, or ranks it spawns itself), every
rank running the same code.  Ranks are laid out as ``jax.make_mesh`` lays
out devices, model innermost: rank = (d·mid + s)·model + m, where the
middle axis is ``seq`` (:func:`make_mesh`) or ``stage``
(``parallel/pipeline.py::make_pp_mesh``) and has size 1 when absent.  The
batch splits over ``data``; the sequence over ``seq`` (ring attention,
``ops/ring_attention.py``); the layers over ``stage`` (GPipe); attention
heads, the FFN hidden, the experts and the vocabulary over ``model``
(megatron tensor parallelism, ``parallel/sharding.py``), through the
collectives of ``parallel/comm.py``.

:func:`init_distributed` starts the process group: ``nccl`` when each rank
has a card of its own, ``gloo`` on the CPU, and ``gloo`` on CUDA only when
asked for (``backend="gloo"``), for ranks that share a card.  It refuses
``nccl`` for ranks that would share a card: NCCL does not run two ranks on
one device.
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
STAGE_AXIS = "stage"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def launch_hint(data: int, model: int, seq: int = 1, stages: int = 1) -> str:
    n = data * model * seq * stages
    flags = f"--dp {data} --tp {model}" + (f" --sp {seq}" if seq > 1 else "") + (
        f" --pp {stages}" if stages > 1 else "")
    return (f"a {flags} mesh needs {n} processes, one per rank: "
            f"launch with `torchrun --nproc-per-node {n} -m <entry point> ... "
            f"{flags}` (or call parallel.init_distributed in "
            f"each of {n} processes first)")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axis sizes, its coordinates, the
    process groups of its axes (None for an axis of size 1), the backend
    and the device its tensors live on.  ``seq`` and ``stage`` are the
    middle axis; at most one of them is above 1."""
    data: int
    model: int
    rank: int
    data_group: Optional[object]
    model_group: Optional[object]
    backend: str
    device: torch.device
    seq: int = 1
    seq_group: Optional[object] = None
    stage: int = 1
    stage_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        out = {DATA_AXIS: self.data}
        if self.seq > 1:
            out[SEQ_AXIS] = self.seq
        if self.stage > 1:
            out[STAGE_AXIS] = self.stage
        out[MODEL_AXIS] = self.model
        return out

    @property
    def mid(self) -> int:
        return self.seq * self.stage

    @property
    def size(self) -> int:
        return self.data * self.mid * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // (self.mid * self.model)

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def seq_rank(self) -> int:
        return (self.rank // self.model) % self.seq

    @property
    def stage_rank(self) -> int:
        return (self.rank // self.model) % self.stage

    def mid_peer(self, index: int) -> int:
        """The global rank of this rank's neighbour at middle-axis
        coordinate ``index`` (mod its size): same data and model
        coordinates."""
        mid = self.mid
        return (self.data_rank * mid + index % mid) * self.model + self.model_rank

    def seq_slice(self, s: int) -> slice:
        """This seq rank's positions of a length-``s`` sequence."""
        n = s // self.seq
        return slice(self.seq_rank * n, (self.seq_rank + 1) * n)

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
    batch; ``seq_len`` the global sequence length when each seq rank holds
    its slice of it (:meth:`Mesh.seq_slice`), None when every rank holds the
    whole sequence; ``global_aux``: the MoE load-balancing loss is computed
    over the whole batch, its statistics summed over the axes that split
    it."""
    mesh: Mesh
    batch: Optional[int] = None
    global_aux: bool = False
    seq_len: Optional[int] = None

    @property
    def rows(self) -> Optional[slice]:
        """This rank's rows of the global batch, or None (whole batch)."""
        return None if self.batch is None else self.mesh.rows(self.batch)

    @property
    def positions(self) -> Optional[slice]:
        """This rank's positions of the global sequence, or None (whole
        sequence)."""
        return None if self.seq_len is None else self.mesh.seq_slice(self.seq_len)


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
    """This rank's (data[, seq], model) mesh over the initialized process
    group.

    ``model=None``: all remaining ranks, as the reference.  ``seq > 1``
    inserts the ring-attention axis between ``data`` and ``model``.  The
    world size must equal data·seq·model."""
    return build_mesh(data, model, seq=seq, device=device)


def build_mesh(data: int, model: Optional[int], seq: int = 1, stage: int = 1,
               device=None) -> Mesh:
    """The mesh of :func:`make_mesh` (``seq``) or of
    ``parallel/pipeline.py::make_pp_mesh`` (``stage``).  Every rank builds
    every axis group, in the same order (``new_group`` is collective)."""
    if seq > 1 and stage > 1:
        raise ValueError("a mesh has a seq or a stage axis, not both")
    mid = seq * stage
    world = dist.get_world_size() if dist.is_initialized() else 1
    hint = launch_hint(data, model or 1, seq, stage)
    if model is None:
        if world % (data * mid):
            raise ValueError(f"{world} ranks not divisible by data={data} x "
                             f"{'seq' if seq > 1 else 'stage'}={mid}")
        model = world // (data * mid)
        hint = launch_hint(data, model, seq, stage)
    n = data * mid * model
    if n == 1 and world == 1:
        return Mesh(1, 1, 0, None, None, "none", _device_for_rank(device))
    if not dist.is_initialized():
        raise RuntimeError(f"no process group is initialized: {hint}")
    if n != world:
        raise ValueError(f"mesh {data}x{mid}x{model} needs WORLD_SIZE {n}, "
                         f"have {world}: {hint}")
    rank = dist.get_rank()

    def groups(size, members):
        """This rank's group along one axis: ``members(fixed)`` lists the
        ranks of the group at each setting of the other coordinates."""
        mine = None
        for fixed in range(n // size):
            ranks = members(fixed)
            g = dist.new_group(ranks) if size > 1 else None
            if rank in ranks:
                mine = g
        return mine

    def at(d, s, m):
        return (d * mid + s) * model + m

    data_group = groups(data, lambda f: [at(d, f // model, f % model) for d in range(data)])
    mid_group = groups(mid, lambda f: [at(f // model, s, f % model) for s in range(mid)])
    model_group = groups(model, lambda f: [at(f // mid, f % mid, m) for m in range(model)])
    if mid > 1:
        # The seq and stage axes send point to point on the default group,
        # some ranks at a time; NCCL needs the group's first collective to
        # involve every rank of it (``dist.batch_isend_irecv``).
        dist.barrier()
    return Mesh(data, model, rank, data_group, model_group, dist.get_backend(),
                _device_for_rank(device), seq=seq,
                seq_group=mid_group if seq > 1 else None, stage=stage,
                stage_group=mid_group if stage > 1 else None)


def seq_axis_size(mesh: Optional[Mesh]) -> int:
    """Ring size of the mesh's ``seq`` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.seq


def current_scope() -> Optional[MeshScope]:
    return _current[0]


def current_mesh() -> Optional[Mesh]:
    scope = _current[0]
    return None if scope is None else scope.mesh


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], batch: Optional[int] = None,
             global_aux: bool = False, seq_len: Optional[int] = None):
    """Activate a mesh for the scope: the forward, the attention dispatch,
    the MoE block, the loss and the samplers' draws read it.  ``batch``,
    ``seq_len``: see :class:`MeshScope`.  A mesh of one rank activates
    nothing."""
    if batch is not None and mesh is not None and mesh.rows(batch) is None:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"data={mesh.data}")
    if seq_len is not None and mesh is not None and (
            mesh.seq == 1 or seq_len % mesh.seq):
        raise ValueError(f"a sequence of {seq_len} does not split over "
                         f"seq={mesh.seq}")
    saved = _current[0]
    _current[0] = (MeshScope(mesh, batch, global_aux, seq_len)
                   if mesh is not None and mesh.size > 1 else None)
    try:
        yield mesh
    finally:
        _current[0] = saved


def is_main_process() -> bool:
    """Rank 0, or no process group: the rank that prints and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def ensure_distributed(data: int, model: int, device=None,
                       backend: Optional[str] = None, seq: int = 1,
                       stages: int = 1):
    """The device of this rank of a data·seq·stages·model mesh: the process
    group is started from ``torchrun``'s environment if none is up; with
    neither, or with another ``WORLD_SIZE``, this raises with how to launch.
    ``device`` passes through when the group is already up."""
    if dist.is_initialized():
        return device
    world = os.environ.get("WORLD_SIZE")
    if world is None or int(world) != data * model * seq * stages:
        raise RuntimeError(f"WORLD_SIZE is {world or 'unset'}: "
                           + launch_hint(data, model, seq, stages))
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
