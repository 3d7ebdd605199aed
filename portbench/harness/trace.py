"""A traced slice of a run: device time by kernel, busy time, idle gaps.

The device's busy time is the union of its activity intervals (kernels,
copies and sets on any stream, overlaps counted once), read from the
profiler's raw Kineto events: building ``prof.events()`` for a decode's
hundreds of thousands of launches would take the host minutes.  Copied
from the program's ``utils/profiling.py`` (``device_intervals``,
``union_seconds``), which the benchmark may not import as its yardstick.

Only the device is traced (CUPTI activity, no host operators): host-side
tracing would slow every launch and make the slice's idle share read high.
Nothing is written to disk: a decode batch's full Chrome trace is hundreds
of megabytes.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

TOP = 10


@dataclass
class Slice:
    window_s: float                       # host clock over the traced call
    busy_s: float                         # union of device intervals
    kernels: Dict[str, List[float]]       # name -> [seconds, calls]
    gaps: List[Tuple[str, float]] = field(default_factory=list)   # longest idle gaps

    def seconds(self, *fragments: str, exclude: Tuple[str, ...] = ()) -> float:
        """Summed device seconds of the operations whose names hold any of
        ``fragments`` and none of ``exclude``."""
        return sum(s for name, (s, _) in self.kernels.items()
                   if any(f in name for f in fragments)
                   and not any(x in name for x in exclude))

    def top(self, n: int = TOP) -> List[List]:
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:160], s] for name, (s, _) in ranked]


def union_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
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


def idle_gaps(events: List[Tuple[int, int, str]], n: int = TOP) -> List[Tuple[str, float]]:
    """The ``n`` longest stretches in which no device activity ran, each
    named by the operations on either side of it."""
    gaps = []
    cur_e, cur_name = None, None
    for s, e, name in sorted(events):
        if cur_e is not None and s > cur_e:
            gaps.append((f"after {cur_name[:70]} / before {name[:70]}", (s - cur_e) * 1e-9))
        if cur_e is None or e > cur_e:
            cur_e, cur_name = e, name
    return sorted(gaps, key=lambda g: -g[1])[:n]


def traced(call: Callable[[], object]) -> Tuple[object, Slice]:
    """Run ``call`` (which must end in a device sync) under the profiler,
    tracing the device only."""
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = call()
        window = time.perf_counter() - t0
    events = [(e.start_ns(), e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and not e.is_user_annotation()]
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, name in events:
        kernels[name][0] += (e - s) * 1e-9
        kernels[name][1] += 1
    # Offsets in integer ns first: a float of the clock's absolute ns keeps
    # only about a quarter of a microsecond.
    t0 = min((s for s, _, _ in events), default=0)
    busy = union_seconds(((s - t0) * 1e-9, (e - t0) * 1e-9) for s, e, _ in events)
    return out, Slice(window_s=window, busy_s=busy, kernels=dict(kernels),
                      gaps=idle_gaps(events))
