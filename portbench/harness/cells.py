"""Everything the harness reads by name: ``BENCHMARK.json``, a cell's
configuration, traffic mix, limits and metric readers.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The files behind them are found by name, never listed in code:

- ``portbench/configs/<config>.json``: the model's sizes (the ``file`` that
  ``BENCHMARK.json`` gives the configuration);
- ``portbench/traffic/<traffic>.json``: the mix's parameters, with ``kind``
  naming the driver ``portbench/drivers/<kind>.py`` that runs it;
- ``portbench/workloads/<cell>.json``: the limits of the cell's comparison
  with the plain reference;
- ``portbench/metrics/<metric>.py``: one reader per metric, which reads
  only the run's fields (``portbench/harness/runtime.py``), never the mix
  or its kind; ``BENCHMARK.json``'s ``workloads`` lists choose its cells.

So a later change adds a cell, a configuration, a mix, a driver or a
metric by adding files and entries, and edits none.  A decode mix passes
its ``runner`` and ``generate`` options to the program whole (the block
cache, int8 weights, ``avoid_eos``, threshold decoding, other lengths and
batches are each a new mix file); a training mix takes the keys that
``portbench/drivers/sft.py`` and the reference read, at rows of one length.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents
    limits: dict            # the cell's limits file's contents
    end_to_end: List[dict] = field(default_factory=list)   # metrics it reports
    per_layer: List[dict] = field(default_factory=list)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with a ``workloads`` list is the listed cells'; an end-to-end
    metric without one is every cell's; a per-layer metric without one is
    every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, bench: Optional[dict] = None, base: Path = PORTBENCH) -> Cell:
    bench = bench if bench is not None else benchmark(base.parent)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=load_json(base.parent / conf["file"]),
                traffic=load_json(base / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(base / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, base: Path = PORTBENCH) -> ModuleType:
    return _load_module(base / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def reader(metric: str, base: Path = PORTBENCH) -> ModuleType:
    return _load_module(base / "metrics" / f"{metric}.py",
                        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def read_metrics(metrics: List[dict], run, base: Path = PORTBENCH) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader found something
    to read; a reader that finds nothing returns None and its metric is
    left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"], base).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
