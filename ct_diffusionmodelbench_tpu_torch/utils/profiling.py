"""Tracing and profiling helpers.

The tracer: :func:`span` and :func:`count` mark the decode path's layer
boundaries (the runner, the samplers, the model's forward and its layers);
:func:`tracing` turns them on for one scope and hands back what they
recorded.  Off, which is the default, a span is one module-level flag test
that returns a shared no-op object: no allocation, no clock read, no CUDA
call.  On, a span records its name, its start and end on the host and the
span that encloses it; it never syncs the device and records no CUDA
event, so the device's work is the same with the tracer on.  Spans are
stamped with ``time.time_ns()``, the clock of ``torch.profiler``'s Kineto
events (the host's launch events and the card's activity alike), so a
profile of the same scope puts each device operation under the span that
launched it.  The tracer keeps one stack of open spans: it follows one
thread.

The profiling helpers:

- :func:`sync`: wait for every CUDA tensor of a tree (the reference forces
  one element of each leaf to the host; here one
  ``torch.cuda.synchronize`` per device is the wait),
- :func:`onchip_device_seconds`: the card's busy time of one call, the
  union of its device intervals (:func:`union_seconds`).

The port's one definition of device busy time is :func:`union_seconds`
over :func:`device_intervals`: kernels, copies and sets on any stream,
overlaps counted once.  ``profile_decode.py`` and ``profile_train.py`` read
it too.
"""

from __future__ import annotations

import contextlib
import operator
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, supported_activities

_ON = False                             # whether span() and count() record
_RECORDING: Optional["Recording"] = None


@dataclass
class Recording:
    """What the tracer recorded in one :func:`tracing` scope: every span in
    the order they started, and each counter's sum."""
    spans: List["Span"] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    _open: List[int] = field(default_factory=list)   # indices of open spans


class Span:
    """One span: ``name``; ``start_ns`` and ``end_ns`` on ``time.time_ns()``;
    ``parent``, the index in :attr:`Recording.spans` of the span that was
    open when it started, or -1.  It holds only its recording's stack of
    open spans: no reference cycle, so a dropped recording is freed at
    once, never by a collector's pass in the middle of a traced run."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "_open")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = 0
        self.parent = -1

    def __enter__(self) -> "Span":
        rec = _RECORDING
        self._open = rec._open
        self.parent = rec._open[-1] if rec._open else -1
        rec._open.append(len(rec.spans))
        rec.spans.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self._open.pop()
        return False


class _Off:
    """The span handed out while the tracer is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str):
    """``with span("model.forward"): ...``: records the block as a span when
    the tracer is on; otherwise returns one shared no-op object."""
    if not _ON:
        return _OFF
    return Span(name)


def tracing_on() -> bool:
    """Whether the tracer records: a counter whose value needs a device
    read (and so a sync) is computed only then."""
    return _ON


def count(name: str, n: int) -> None:
    """Adds the host integer ``n`` to the counter ``name`` when the tracer
    is on.  Refuses a tensor, on or off: reading one would sync the device."""
    if isinstance(n, torch.Tensor):
        raise TypeError(f"count({name!r}) takes a host integer, not a tensor: "
                        "reading a tensor would wait for the device")
    if _ON:
        counters = _RECORDING.counters
        counters[name] = counters.get(name, 0) + operator.index(n)


@contextlib.contextmanager
def tracing() -> Iterator[Recording]:
    """Turns the tracer on for the scope and yields the :class:`Recording`
    that the scope's spans and counters fill; turns it off at exit.  Scopes
    do not nest: a second one inside the first raises."""
    global _ON, _RECORDING
    if _ON:
        raise RuntimeError("tracing() is already on: its scopes do not nest")
    rec = Recording()
    _RECORDING, _ON = rec, True
    try:
        yield rec
    finally:
        _ON, _RECORDING = False, None


def leaves(tree):
    """The leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def sync(tree) -> None:
    """Wait for the work behind every CUDA tensor in ``tree`` (dicts,
    lists, tuples): one ``torch.cuda.synchronize`` per distinct card among
    the leaves.  CPU tensors and other leaves need nothing."""
    devices = {leaf.device for leaf in leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in sorted(devices, key=lambda d: d.index or 0):
        torch.cuda.synchronize(dev)


def _activities() -> list:
    """CUDA where this build and machine trace it; the host otherwise,
    since the profiler refuses an empty list."""
    if ProfilerActivity.CUDA in supported_activities() and torch.cuda.is_available():
        return [ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals, in their unit:
    time covered by at least one of them, overlaps counted once."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_intervals(prof) -> List[Tuple[float, float]]:
    """(start, end) in seconds of every device activity (kernels, copies,
    sets, any stream; not the ranges that annotate the device's timeline)
    of a finished ``torch.profiler.profile``, from the
    first one's start, read from its raw Kineto events: building
    ``prof.events()`` for a decode's hundreds of thousands of launches
    would take the host minutes.  The offsets are taken in integer
    nanoseconds: a float of the clock's absolute nanoseconds keeps only
    about a quarter of a microsecond."""
    cuda = torch.autograd.DeviceType.CUDA
    ns = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and not e.is_user_annotation()]
    t0 = min((s for s, _ in ns), default=0)
    return [((s - t0) * 1e-9, (e - t0) * 1e-9) for s, e in ns]


def onchip_device_seconds(call) -> Optional[float]:
    """Device busy seconds of one ``call()``: the union of every device
    interval in a ``torch.profiler`` trace of it (CUDA activity only).  A
    union, not a sum: NCCL and copies run on their own streams and overlap
    the compute streams.

    ``call`` must end in a device sync (its work must fall inside the
    trace) and be warm (a build or first launch inside the trace would
    count as its time).  None when the trace holds no device event, as a
    call on the CPU gives; on the card, the callers treat None after work
    was launched as a failed profile.

    Left out of the reference's: the xplane parsing and the ``while``-op
    hierarchy (a CUDA trace is flat), and the shared TPU pool's reasons for
    a device-plane number (the card is not time-shared)."""
    with profile(activities=_activities()) as prof:
        call()
    intervals = device_intervals(prof)
    if not intervals:
        return None
    return union_seconds(intervals)
