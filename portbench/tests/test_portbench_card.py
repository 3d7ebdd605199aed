"""The command line's refusals, and a tiny cell on the card.

The card's tests carry the ``cuda`` marker and skip, inside a fixture,
where there is no card: ``python -m pytest -m cuda portbench/tests``."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness import cells
from portbench.harness.runtime import run_cell
from portbench.tests.tiny import base

RUN = ["--workload", "dense8b-eval", "--seed", "1", "--seconds", "1", "--trace", "0"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_the_files_under_paths_alone_print_no_result(tmp_path):
    """Without the program beside it (or without a card) a run exits with
    another code than 0 and prints no result."""
    shutil.copytree(cells.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", *RUN], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", *RUN], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


@pytest.mark.cuda
def test_tiny_cells_run_traced_on_the_card(card, tmp_path):
    """The tiny cells' limits are the CPU's float32 ones, which bf16 on the
    card does not meet; here only the decode's structure is held exact."""
    pb = base(tmp_path)
    for name in ("tiny-moe-eval", "tiny-dense-sft"):
        out = run_cell(cells.cell(name, base=pb), 3, 1.0, True, card, 0.0, base=pb)
        assert out["checks"].get("structure", {"value": 0})["value"] == 0
        assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
        assert len(out["breakdown"]["device_ops"]) <= 10
        json.dumps(out)
