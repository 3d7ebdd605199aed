"""A span batch: the device trace joined to the program's spans by launch.

The program's tracer (``ct_diffusionmodelbench_tpu_torch/utils/
profiling.py``: ``tracing``, ``span``, ``count``) records host spans with
their parents, and counters, stamped with ``time.time_ns()``: the clock of
the profiler's Kineto events.  With CUDA activity, Kineto records each
device operation and the runtime call on the host that launched it
(``cudaLaunchKernel``, ``cudaMemcpyAsync`` ...) under one correlation id;
the launch is the earliest host event of that id (the calls it makes,
such as a module load, start inside it).

:func:`join` puts each device operation under the innermost span open on
the host when it was launched, and each idle gap of the device (between
the intervals of its busy union) under the innermost span open when the
gap starts, or :data:`OUTSIDE` where none is.  Device seconds are split
into GEMM (the kernels ``metrics/dense_gemm_roofline.decode.py`` counts),
attention (``metrics/flash_fwd_roofline.decode.py``'s kernels) and other:
the glue between them, the sampler's work, copies and sets.  The busy
time is the union of the operations' intervals, as ``harness/trace.py``
takes it; a span's seconds are sums of its operations' durations.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

from portbench.harness import cells

OUTSIDE = "outside"
CLASSES = ("gemm", "attention", "other")
TOP = 10


@dataclass
class SpanTime:
    """Device seconds by class (:data:`CLASSES`) of one span name: ``incl``
    launched inside any span of the name, ``own`` launched where the
    innermost open span is one of the name (its self time); ``n`` spans of
    the name."""
    n: int = 0
    incl: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    own: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])


@dataclass
class SpanSlice:
    window_s: float                       # host clock over the span batch
    busy_s: float                         # union of device intervals
    spans: Dict[str, SpanTime]            # by span name, with OUTSIDE
    counters: Dict[str, int]
    gaps: List[Tuple[str, float]]         # every idle gap, labelled, longest first
    unlaunched_s: float = 0.0             # device seconds with no launch found

    def seconds(self, name: str, *classes: str) -> float:
        """Device seconds launched inside spans ``name``: of ``classes``,
        or of every class."""
        t = self.spans.get(name)
        if t is None:
            return 0.0
        return sum(s for c, s in zip(CLASSES, t.incl) if not classes or c in classes)

    def top(self, n: int = TOP) -> List[List]:
        """The ``n`` span names with the most device time, each
        ``[name, spans, inclusive s, own s, inclusive GEMM, attention,
        other s]``."""
        ranked = sorted(self.spans.items(), key=lambda kv: -sum(kv[1].incl))[:n]
        return [[name, t.n, sum(t.incl), sum(t.own), *t.incl] for name, t in ranked]

    def idle(self, n: int = TOP) -> Dict[str, List]:
        """The ``n`` longest idle gaps, and idle seconds summed by label."""
        by_label: Dict[str, float] = defaultdict(float)
        for label, s in self.gaps:
            by_label[label] += s
        return {"longest": [[label, s] for label, s in self.gaps[:n]],
                "by_span": sorted(([k, v] for k, v in by_label.items()),
                                  key=lambda kv: -kv[1])}


def classifier(base: Path = cells.PORTBENCH) -> Callable[[str], int]:
    """name → index in :data:`CLASSES`, from the two roofline readers'
    name lists; each name is matched once (a batch launches a few hundred
    names some hundred thousand times)."""
    gemm = cells.reader("dense_gemm_roofline.decode", base)
    flash = cells.reader("flash_fwd_roofline.decode", base)
    known: Dict[str, int] = {}

    def classify(name: str) -> int:
        if name not in known:
            if any(k in name for k in flash.KERNELS):
                known[name] = 1
            elif (any(p in name for p in gemm.PATTERNS)
                  and not any(x in name for x in gemm.EXCLUDE)):
                known[name] = 0
            else:
                known[name] = 2
        return known[name]

    return classify


def innermost(spans: Sequence, times: Iterable[int]) -> List[int]:
    """For each of the ascending ``times`` (ns), the index of the innermost
    span open at it (start ≤ t ≤ end), or -1.  ``spans`` are in the order
    they started and nest, as one thread's spans do: the latest started
    of those still open is the innermost."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j].start_ns <= t:
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]].end_ns < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def join(events, spans: Sequence, counters: Dict[str, int], window_s: float,
         classify: Callable[[str], int]) -> SpanSlice:
    """The span batch from a finished profile's raw Kineto ``events`` and
    the tracer's ``spans`` (``name``, ``start_ns``, ``end_ns``, ``parent``)
    and ``counters``."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, launched_at = [], {}
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                ops.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
        elif e.correlation_id():
            c, s = e.correlation_id(), e.start_ns()
            if s < launched_at.get(c, s + 1):
                launched_at[c] = s
    unlaunched = 0.0
    timed = []                            # (launch ns, seconds, class)
    for s, e, name, corr in ops:
        if corr in launched_at:
            timed.append((launched_at[corr], (e - s) * 1e-9, classify(name)))
        else:
            unlaunched += (e - s) * 1e-9
    timed.sort()
    by_owner: Dict[int, List[float]] = defaultdict(lambda: [0.0, 0.0, 0.0])
    for owner, (_, sec, cls) in zip(innermost(spans, (t for t, _, _ in timed)), timed):
        by_owner[owner][cls] += sec

    times: Dict[str, SpanTime] = defaultdict(SpanTime)
    for sp in spans:
        times[sp.name].n += 1
    for owner, secs in by_owner.items():
        names = [OUTSIDE] if owner < 0 else []
        i = owner
        while i >= 0:                      # the owner and its ancestors, once a name
            if spans[i].name not in names:
                names.append(spans[i].name)
            i = spans[i].parent
        for c in range(3):
            times[names[0]].own[c] += secs[c]
            for name in names:
                times[name].incl[c] += secs[c]

    busy, gaps = _busy_and_gaps(ops)
    labels = innermost(spans, (g for g, _ in gaps))
    labelled = sorted(((OUTSIDE if i < 0 else spans[i].name, sec)
                       for i, (_, sec) in zip(labels, gaps)), key=lambda g: -g[1])
    return SpanSlice(window_s=window_s, busy_s=busy, spans=dict(times),
                     counters=dict(counters), gaps=labelled, unlaunched_s=unlaunched)


def _busy_and_gaps(ops) -> Tuple[float, List[Tuple[int, float]]]:
    """The union of the operations' intervals in seconds, and each stretch
    between its pieces as (start ns, seconds), in time order.  Offsets are
    taken in integer ns."""
    busy_ns, gaps = 0, []
    cur_s = cur_e = None
    for s, e, _, _ in sorted(ops):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
                gaps.append((cur_e, (s - cur_e) * 1e-9))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    return busy_ns * 1e-9, gaps
