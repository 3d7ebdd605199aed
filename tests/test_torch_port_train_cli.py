"""The port's training CLI and plotting against the JAX package's, on the
CPU: the parser flag for flag, the train → chat → MiniF2F journey through
the port's CLIs (the reference's ``tests/test_cli_journey.py``) and the
re-plotting CLI."""

import json

import numpy as np
import pytest

from ct_diffusionmodelbench_tpu.cli import train as j_train_cli
from ct_diffusionmodelbench_tpu.io.checkpoint import load_checkpoint as j_load
from ct_diffusionmodelbench_tpu_torch.cli import replot as t_replot
from ct_diffusionmodelbench_tpu_torch.cli import train as t_train_cli
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import load_checkpoint
from ct_diffusionmodelbench_tpu_torch.models import get_config
from ct_diffusionmodelbench_tpu_torch.train import plotting
from tests.torch_port_threads import one_torch_thread  # noqa: F401


def _flags(parser):
    """{option strings: (dest, default, choices, type, nargs, action kind)}."""
    return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.type, a.nargs,
                                      type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_train_parser_matches_reference():
    """Every reference flag with its destination, default, choices and
    type; the port adds ``--device`` (the card unless told otherwise) and
    ``--dist-backend`` (the torch.distributed backend of a --dp/--tp run)."""
    ref, port = _flags(j_train_cli.build_parser()), _flags(t_train_cli.build_parser())
    assert port.pop(("--device",))[:2] == ("device", None)
    assert port.pop(("--dist-backend",))[:3] == ("dist_backend", None, ["nccl", "gloo"])
    assert port == ref


def test_remat_policy_dots_implies_remat(monkeypatch):
    """``--remat-policy dots`` turns remat on without ``--remat``; ``full``
    alone leaves it off, as the reference's ``main``."""
    seen = []

    class Stub:
        def __init__(self, cfg, params, tc, rows, **kw):
            seen.append((tc.remat, kw["device"], tc.optimizer_state_dtype))

        def train(self):
            return {}

    monkeypatch.setattr(t_train_cli, "Trainer", Stub)
    cfg = get_config("llada-tiny")
    for argv, want in ((["--remat-policy", "dots"], "dots"), ([], False),
                       (["--remat"], True), (["--remat", "--remat-policy", "full"], True)):
        args = t_train_cli.build_parser().parse_args(
            argv + ["--device", "cpu", "--optimizer-state-dtype", "int8"])
        t_train_cli.run(args, cfg, {}, None, [], [])
        assert seen.pop() == (want, "cpu", "int8")


@pytest.fixture(scope="module")
def numina_jsonl(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "numina.jsonl"
    with open(p, "w") as f:
        for i in range(40):
            f.write(json.dumps({
                "problem": f"Compute {i} + 0.",
                "formal_statement": f"theorem t{i} (n : Nat) : n + {i % 3} = n + {i % 3} := by",
                "formal_ground_truth": "simp",
                "formal_proof": "exact rfl",
                "answer": str(i),
            }) + "\n")
    return p


def test_train_chat_minif2f_journey(tmp_path, numina_jsonl, capsys):
    """Train a tiny model on a local jsonl through the port's
    ``cli/train.py``, chat with the saved checkpoint, run MiniF2F on it
    (fake Lean), all with ``--device cpu``; the reference's loader reads the
    trained checkpoint back to the port's weights."""
    pytest.importorskip("datasets")
    from ct_diffusionmodelbench_tpu_torch.cli import chat, minif2f

    out_dir = tmp_path / "trained"
    t_train_cli.main([
        "--preset", "llada-tiny", "--dataset", str(numina_jsonl),
        "--format", "lean_sft", "--output-dir", str(out_dir),
        "--train-samples", "16", "--epochs", "1", "--batch-size", "2",
        "--grad-accum", "2", "--max-length", "64", "--eval-steps", "0",
        "--logging-steps", "1", "--warmup-steps", "1", "--device", "cpu",
    ])
    for name in ("model.safetensors", "config.json", "training_metrics.json",
                 "training_plots.png", "tokenizer_config.json"):
        assert (out_dir / name).exists(), name
    logs = json.loads((out_dir / "training_metrics.json").read_text())
    assert logs[-1]["status"] == "completed" and logs[-1]["step"] == 4
    cfg_t, params_t = load_checkpoint(out_dir, device="cpu")
    _, params_j = j_load(out_dir)
    np.testing.assert_array_equal(np.asarray(params_j["embed"], np.float32),
                                  params_t["embed"].float().numpy())
    capsys.readouterr()

    chat.main(["--model-dir", str(out_dir), "--prompt", "prove it", "--gen-length", "8",
               "--steps", "8", "--block-length", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== Generation Result ===" in out
    assert "mask_id=500" in out  # persisted in the exported config.json

    problems = [{"name": "p0", "split": "test", "informal_statement": "s",
                 "formal_statement": "theorem p0 : True := by",
                 "header": "import Mathlib"}]
    mp = tmp_path / "m.json"
    mp.write_text(json.dumps(problems))
    minif2f.main(["--model-dir", str(out_dir), "--json-path", str(mp),
                  "--output-dir", str(tmp_path / "eval"), "--fake-lean",
                  "--gen-length", "8", "--steps", "8", "--block-length", "4",
                  "--device", "cpu"])
    files = list((tmp_path / "eval").glob("minif2f_lean4_results_test_*.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["stats"]["total"] == 1


def test_replot_cli(tmp_path, capsys):
    """``tests/test_eval.py::test_replot_cli`` in the port."""
    metrics = [{"step": i, "loss": 1.0 / (i + 1)} for i in range(5)]
    mp = tmp_path / "training_metrics.json"
    mp.write_text(json.dumps(metrics))
    t_replot.main([str(mp), "--output-dir", str(tmp_path)])
    assert (tmp_path / "training_plots.png").exists()
    assert "Plots written." in capsys.readouterr().out


def test_replot_from_file_panels_and_empty(tmp_path):
    """Train and eval panels render beside the metrics file by default; a
    log with no plottable series writes nothing."""
    logs = [{"step": 1, "loss": 2.0}, {"step": 1, "eval_loss": 2.5},
            {"step": 2, "train_loss": 1.5, "status": "completed"}]
    mp = tmp_path / "run" / "training_metrics.json"
    mp.parent.mkdir()
    mp.write_text(json.dumps(logs))
    assert plotting.replot_from_file(mp) is True
    assert (mp.parent / "training_plots.png").exists()
    assert plotting.plot_training_metrics([{"step": 1}], tmp_path / "run2") is False
    assert not (tmp_path / "run2").exists()
