"""One run of one cell: the driver, the metrics, the result line.

:func:`run_cell` is the whole run but the look for a card, which the
command line makes first (``portbench/run.py``); the tests call it on the
CPU at a tiny size.  A driver (``portbench/drivers/<kind>.py``) builds the
program from the cell's files, warms it up, measures its window, reads the
trace when asked, and judges what the window produced against the plain
reference; it fills a :class:`Run`, which the metric readers read.  A
reader takes only the Run's fields, never the mix or the driver's name:
``BENCHMARK.json``'s ``workloads`` lists choose the cells a metric is read
in, and a new driver that fills the fields serves every reader.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from portbench.harness import cells
from portbench.harness.peaks import peaks
from portbench.harness.trace import Slice


@dataclass
class Check:
    """One number compared, with its limit: within it when value ≤ limit."""
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass(frozen=True)
class Call:
    """One forward pass of the model: each row's real tokens (padding not
    counted) and the positions the LM head covers in each row."""
    rows: Tuple[int, ...]
    head: int


@dataclass
class Run:
    cell: cells.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                         # perf_counter at the process's start
    chips: int = 1
    card: str = "cpu"                 # the CUDA device name
    setup_s: Optional[float] = None
    window_s: Optional[float] = None  # window start to the last completion
    # The window's work, which the rates and the FLOP counts read: the
    # tokens a rate counts (generated, or trained and not padding), and
    # each forward pass of the model as a Call.
    tokens: int = 0
    units: int = 0                    # batches or steps the window completed
    calls: List[Call] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    slice: Optional[Slice] = None     # the traced slice, with --trace 1
    slice_calls: List[Call] = field(default_factory=list)   # its work
    spans: Dict[str, float] = field(default_factory=dict)   # ms per step
    checks: Dict[str, Check] = field(default_factory=dict)
    memory_peak_bytes: int = 0

    @property
    def sizes(self) -> dict:
        from portbench.harness.model import sizes
        return sizes(self.cell.config)

    @property
    def mix(self) -> dict:
        return self.cell.traffic

    @property
    def peaks(self) -> Optional[Dict[str, float]]:
        return peaks(self.card)

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t0

    def log(self, msg: str) -> None:
        print(f"[portbench +{time.perf_counter() - self.t0:.1f}s] {msg}",
              file=sys.stderr, flush=True)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float,
             base: Path = cells.PORTBENCH) -> dict:
    """Run the cell once; returns the result line's object."""
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, t0=t0,
              chips=cell.chips)
    if device.type == "cuda":
        run.card = torch.cuda.get_device_name(device)
    cells.driver(cell.traffic["kind"], base).run(run)
    metrics = cells.read_metrics(cell.per_layer if trace else cell.end_to_end, run, base)
    correct = bool(run.checks) and all(c.ok for c in run.checks.values()) and run.failed == 0
    out = {
        "correct": correct,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": device_info(run),
    }
    if trace and run.slice is not None:
        out["breakdown"] = {"device_ops": run.slice.top(),
                            "idle_gaps": [[n, s] for n, s in run.slice.gaps]}
    out["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in run.checks.items()}
    return out


def device_info(run: Run) -> dict:
    info = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
            "kind": run.card, "count": run.chips,
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace and run.slice is not None:
        info["busy_s"] = run.slice.busy_s
        info["window_s"] = run.slice.window_s
    return info
