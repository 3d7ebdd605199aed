"""The harness finds a configuration, a mix, a cell and a metric that are
dropped in as new files, with no edit to a file it already has."""

import json
import shutil

import pytest
import torch

from portbench.harness import cells
from portbench.harness.runtime import run_cell
from portbench.tests.tiny import base


def test_new_files_make_a_new_cell_with_a_new_metric(tmp_path):
    pb = base(tmp_path)
    (pb / "metrics" / "requests_per_s.py").write_text(
        "def read(run):\n    return run.attempted / run.window_s if run.window_s else None\n")
    bench = json.loads((pb.parent / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "requests_per_s", "unit": "requests/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny-dense-eval"]})
    (pb.parent / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.cell("tiny-dense-eval", base=pb)
    assert cell.config["name"] == "tiny-dense" and cell.traffic["batch"] == 4
    assert [m["name"] for m in cell.end_to_end] == ["decode_tokens_per_s", "setup_s",
                                                    "requests_per_s"]
    assert "grouped_ffn_roofline.decode" not in [m["name"] for m in cell.per_layer]
    out = run_cell(cell, 5, 0.5, False, torch.device("cpu"), 0.0, base=pb)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"decode_tokens_per_s", "setup_s", "requests_per_s"}
    assert list(out)[-1] == "checks"


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tmp_path):
    pb = base(tmp_path)
    cell = cells.cell("tiny-moe-eval", base=pb)
    out = run_cell(cell, 6, 0.2, False, torch.device("cpu"), 0.0, base=pb)
    run_metrics = cells.read_metrics(cell.per_layer, _Empty(cell), pb)
    assert out["correct"] and run_metrics == {}


class _Empty:
    """A run with no trace and no window."""

    def __init__(self, cell):
        self.cell, self.mix, self.slice, self.window_s = cell, cell.traffic, None, None
        self.calls, self.slice_calls, self.tokens, self.spans, self.peaks = [], [], 0, {}, None


def _add_cell(pb, name, mix, limits, config="tiny-moe", like="tiny-moe-eval"):
    """A new mix file and limits file, and the cell's entry, listed in every
    metric that ``like`` is listed in."""
    (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (pb / "workloads" / f"{name}.json").write_text(json.dumps(limits))
    bench = json.loads((pb.parent / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": config, "traffic": name,
                               "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (pb.parent / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("extra", [
    {"runner": {"accel": "block-cache"}},
    {"generate": {"avoid_eos": True}},
    {"generate": {"parallel_threshold": 0.9, "steps": 32}},
], ids=["block-cache", "avoid-eos", "threshold"])
def test_a_mix_names_the_runner_and_sampler_options(tmp_path, extra):
    """Runner and sampler options reach the program from the mix file
    alone; the decode check follows their steps."""
    from portbench.tests.tiny import TINY_LIMITS, TINY_MIX

    pb = base(tmp_path)
    mix = json.loads(json.dumps(TINY_MIX))
    mix["runner"].update(extra.get("runner", {}))
    mix["generate"].update(extra.get("generate", {}))
    _add_cell(pb, "tiny-option", mix, {"limits": {"token_gap": 100.0}})
    out = run_cell(cells.cell("tiny-option", base=pb), 8, 0.2, False, torch.device("cpu"),
                   0.0, base=pb)
    assert out["checks"]["structure"]["value"] == 0 and out["correct"], out["checks"]
    assert set(out["metrics"]) == {"decode_tokens_per_s", "setup_s"}


def test_a_new_driver_kind_is_read_by_every_metric(tmp_path):
    """A driver dropped in under a new kind fills the run; the readers,
    which never look at the kind, read it in the cells listed."""
    from portbench.tests.tiny import TINY_LIMITS, TINY_MIX

    pb = base(tmp_path)
    shutil.copy(pb / "drivers" / "eval_decode.py", pb / "drivers" / "eval_decode_copy.py")
    _add_cell(pb, "tiny-copy", dict(TINY_MIX, kind="eval_decode_copy"), TINY_LIMITS)
    cell = cells.cell("tiny-copy", base=pb)
    out = run_cell(cell, 9, 0.2, False, torch.device("cpu"), 0.0, base=pb)
    assert out["correct"] and set(out["metrics"]) == {"decode_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("name", ["tiny-moe-eval", "tiny-dense-eval", "tiny-moe-sft"])
def test_a_traced_run_reports_every_metric_its_cell_lists(tmp_path, monkeypatch, name):
    """With ``--trace 1`` each per-layer metric listed for the cell is in
    the line (the profiler's slice stood in for by one that names every
    kernel the readers match; the optimizer's CUDA-event span is the
    card's alone)."""
    from portbench.harness import trace

    def fake(call):
        out = call()
        kernels = {k: [0.5, 10] for k in ("grouped_gemm_kernel<2>", "flash_fwd_kernel",
                                          "nvjet_tss_gemm", "flash_bwd_dq_kernel",
                                          "flash_bwd_dkv_kernel")}
        return out, trace.Slice(window_s=4.0, busy_s=0.01, kernels=kernels)

    from portbench.harness import peaks, runtime

    monkeypatch.setattr(trace, "traced", fake)
    monkeypatch.setattr(runtime, "peaks", lambda card: peaks.peaks("NVIDIA H100 80GB HBM3"))
    pb = base(tmp_path)
    cell = cells.cell(name, base=pb)
    out = run_cell(cell, 10, 0.2, True, torch.device("cpu"), 0.0, base=pb)
    listed = {m["name"] for m in cell.per_layer} - {"optimizer_ms.train"}
    assert out["correct"] and set(out["metrics"]) == listed
    assert out["device"]["busy_s"] == 0.01 and "breakdown" in out
