"""Tracing and profiling helpers.

Counterpart of ``utils/profiling.py``:

- :func:`sync`: wait for every CUDA tensor of a tree (the reference forces
  one element of each leaf to the host; here one
  ``torch.cuda.synchronize`` per device is the wait),
- :func:`device_timer`: a host-clock bracket that syncs what it watches,
- :func:`trace`: a ``torch.profiler`` scope writing a Chrome / TensorBoard
  trace,
- :func:`onchip_device_seconds`: the card's busy time of one call, the
  union of its device intervals (:func:`union_seconds`).

The port's one definition of device busy time is :func:`union_seconds`
over :func:`device_intervals`: kernels, copies and sets on any stream,
overlaps counted once.  ``profile_decode.py`` and ``profile_train.py`` read
it too.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterable, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, supported_activities


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


@contextlib.contextmanager
def device_timer(label: str = "", results: Optional[dict] = None):
    """``with device_timer("generate") as t: out = f(x); t.watch(out)``:
    host seconds from entry until what ``t.watch`` was given is done, in
    ``t.elapsed`` and ``results[label or "elapsed"]``."""

    class _T:
        elapsed = 0.0

        def watch(self, tree):
            self._tree = tree

    t = _T()
    t._tree = None
    t0 = time.time()
    try:
        yield t
    finally:
        if t._tree is not None:
            sync(t._tree)
        t.elapsed = time.time() - t0
        if results is not None:
            results[label or "elapsed"] = t.elapsed


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` scope over the host and, where there is one, the
    card, writing a Chrome / TensorBoard trace into ``log_dir``; a no-op
    when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    with profile(activities=_activities(cpu=True),
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield


def _activities(cpu: bool) -> list:
    """CUDA where this build and machine trace it (with the host if
    ``cpu``); the host alone otherwise, since the profiler refuses an empty
    list."""
    cuda = ProfilerActivity.CUDA in supported_activities() and torch.cuda.is_available()
    if not cuda:
        return [ProfilerActivity.CPU]
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]


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
    with profile(activities=_activities(cpu=False)) as prof:
        call()
    intervals = device_intervals(prof)
    if not intervals:
        return None
    return union_seconds(intervals)
