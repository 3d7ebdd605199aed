"""The port's profiling helpers (``utils/profiling.py``) on the CPU: the
busy-time union, the device intervals of a profile and the on-chip
companion off the card.  The tracer's tests are
``tests/test_torch_port_tracing.py``."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ct_diffusionmodelbench_tpu_torch.utils import profiling as tprof
from tests.torch_port_threads import one_torch_thread  # noqa: F401


def _brute_union(intervals):
    """Union length of integer intervals: the unit cells any one covers."""
    cells = set()
    for s, e in intervals:
        cells.update(range(s, e))
    return len(cells)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 300), st.integers(0, 60)), max_size=40))
def test_union_seconds_matches_brute_force(pairs):
    intervals = [(s, s + d) for s, d in pairs]
    got = tprof.union_seconds(intervals)
    assert got == _brute_union(intervals)
    assert got <= sum(e - s for s, e in intervals)


def test_union_seconds_nested_and_touching():
    # A span inside another counts once; touching spans join; order is free.
    assert tprof.union_seconds([(0.0, 10.0), (2.0, 3.0), (10.0, 12.5)]) == 12.5
    assert tprof.union_seconds([(5.0, 6.0), (0.0, 1.0)]) == 2.0
    assert tprof.union_seconds([]) == 0.0


def test_onchip_device_seconds_of_a_cpu_call_is_none():
    ran = []

    def call():
        x = torch.randn((32, 32))
        ran.append(float((x @ x).sum()))

    assert tprof.onchip_device_seconds(call) is None
    assert len(ran) == 1 and np.isfinite(ran[0])


class _Event:
    def __init__(self, kind, start_ns, end_ns):
        self.kind, self.s, self.e = kind, start_ns, end_ns

    def device_type(self):
        on_card = self.kind.startswith("gpu") or self.kind == "kernel"
        return torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.kind.endswith("user_annotation")

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


class _Prof:
    """A finished profile's raw Kineto events, as ``device_intervals``
    reads them."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_device_intervals_keep_device_work_at_nanosecond_offsets():
    base = 1_792_268_346_947_780_750   # a clock reading in ns, past float64's ulp
    events = [_Event("kernel", base + 1_000, base + 6_001),
              _Event("gpu_memcpy", base + 5_000, base + 9_000),      # overlaps the kernel
              _Event("gpu_memset", base + 20_000, base + 20_003),
              _Event("cpu_op", base, base + 50_000),
              _Event("cuda_runtime", base + 900, base + 1_200),
              _Event("gpu_user_annotation", base, base + 40_000),
              _Event("kernel", base + 1_000, base + 1_001)]          # inside the first
    got = tprof.device_intervals(_Prof(events))
    assert len(got) == 4 and got[0] == (0.0, 5_001e-9)
    assert tprof.union_seconds(got) == pytest.approx(8_003e-9, abs=1e-15)
    assert tprof.device_intervals(_Prof([_Event("cpu_op", 0, 5)])) == []
