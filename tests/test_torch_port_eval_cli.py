"""The port's dataset IO and eval CLIs against the JAX package's, on the CPU.

Dataset functions run on the same ``datasets`` objects; the CLIs' mains run
on the same local files, each side's ``runner_from_args`` patched to return
a runner on the same bridged weights (the port's with ``--device cpu``).
Result files must be equal field for field, timings and the device aside.
"""

import json

import numpy as np
import pytest

datasets = pytest.importorskip("datasets")

from ct_diffusionmodelbench_tpu.cli import analyze as j_analyze  # noqa: E402
from ct_diffusionmodelbench_tpu.cli import bench as j_bench_cli  # noqa: E402
from ct_diffusionmodelbench_tpu.cli import infer_split as j_infer  # noqa: E402
from ct_diffusionmodelbench_tpu.cli import lean_check as j_lean_check  # noqa: E402
from ct_diffusionmodelbench_tpu.cli import minif2f as j_minif2f_cli  # noqa: E402
from ct_diffusionmodelbench_tpu.io import datasets_io as j_dio  # noqa: E402
from ct_diffusionmodelbench_tpu.io import tokenizer as j_tok  # noqa: E402
from ct_diffusionmodelbench_tpu_torch import io as t_io  # noqa: E402
from ct_diffusionmodelbench_tpu_torch.cli import analyze as t_analyze  # noqa: E402
from ct_diffusionmodelbench_tpu_torch.cli import bench as t_bench_cli  # noqa: E402
from ct_diffusionmodelbench_tpu_torch.cli import infer_split as t_infer  # noqa: E402
from ct_diffusionmodelbench_tpu_torch.cli import lean_check as t_lean_check  # noqa: E402
from ct_diffusionmodelbench_tpu_torch.cli import minif2f as t_minif2f_cli  # noqa: E402
from ct_diffusionmodelbench_tpu_torch.io import datasets_io as t_dio  # noqa: E402
from ct_diffusionmodelbench_tpu_torch.io import tokenizer as t_tok  # noqa: E402
from tests.test_torch_port_eval import (  # noqa: E402
    Recording,
    assert_same_files,
    entries,
    minif2f_json,
    runner_pair,
    strip_timing,
)
from tests.torch_port_threads import one_torch_thread  # noqa: E402,F401

TINY_GEN = ["--gen-length", "16", "--steps", "8", "--block-length", "4"]


@pytest.fixture(scope="module")
def toks():
    return (j_tok.Tokenizer.byte_fallback(), t_tok.Tokenizer.byte_fallback())


def numina_ds(n=100):
    return datasets.Dataset.from_dict({
        "index": list(range(n)),
        "problem": [f"problem {i}" for i in range(n)],
        "formal_statement": [f"theorem t{i} : True := by" if i % 3 else ""
                             for i in range(n)],
        "formal_ground_truth": [f"trivial -- {i}" if i % 4 else "" for i in range(n)],
        "formal_proof": [f"exact trivial -- {i}" if i % 5 else "" for i in range(n)],
        "answer": [str(i) if i % 7 else "" for i in range(n)],
    })


def write_jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return path


def numina_rows(n=30):
    return [{"problem": f"Compute {i}.", "formal_statement": f"theorem t{i} : True := by",
             "formal_proof": "trivial", "answer": str(i)} for i in range(n)]


# ---------------------------------------------------------------------------
# dataset IO
# ---------------------------------------------------------------------------

def test_formatters_match_jax(toks):
    tj, tt = toks
    ds = numina_ds(40)
    for i in range(len(ds)):
        row = ds[i]
        assert t_dio.format_instruction_lean_sft(row, tt) == \
            j_dio.format_instruction_lean_sft(row, tj)
        for extra in ("", "Lean only.", "  padded  "):
            assert t_dio.format_instruction_problem(row, tt, extra_system=extra) == \
                j_dio.format_instruction_problem(row, tj, extra_system=extra)


@pytest.mark.parametrize("n,seed", [(100, 42), (57, 42), (100, 7)])
def test_seeded_splits_match_jax(n, seed):
    """The same rows, in the same order, as the reference's splits."""
    ds = numina_ds(n)
    for got, want in zip(t_dio.split_80_10_10(ds, seed=seed),
                         j_dio.split_80_10_10(ds, seed=seed)):
        assert got["index"] == want["index"] and len(got) > 0
    for got, want in zip(t_dio.split_fresh_for_inference(ds, seed=seed),
                         j_dio.split_fresh_for_inference(ds, seed=seed)):
        assert got["index"] == want["index"] and len(got) > 0
    for m in (20, 40, 1000):
        got = t_dio.split_val_from_training(ds, max_samples=m, seed=seed)
        want = j_dio.split_val_from_training(ds, max_samples=m, seed=seed)
        assert got["index"] == want["index"] and got[:] == want[:]
    assert t_io.split_80_10_10 is t_dio.split_80_10_10    # exported beside the bridge


def test_load_hub_or_local_and_pick_split(tmp_path):
    p = write_jsonl(tmp_path / "data.jsonl",
                    [{"problem": f"p{i}", "category": "alg"} for i in range(5)])
    got, want = t_dio.load_hub_or_local(str(p)), j_dio.load_hub_or_local(str(p))
    assert got[:] == want[:] and len(got) == 5
    assert t_dio.pick_bench_split(got)[1] == j_dio.pick_bench_split(want)[1] == "train"

    ds = datasets.Dataset.from_dict({"a": [1, 2, 3]})
    dd = datasets.DatasetDict({"train": ds, "test": ds.select([0])})
    dd.save_to_disk(str(tmp_path / "dict"))
    ds.save_to_disk(str(tmp_path / "plain"))
    for path, split in (("dict", "test"), ("dict", "train"), ("dict", "missing"),
                        ("dict", None), ("plain", "train")):
        got = t_dio.load_hub_or_local(str(tmp_path / path), split=split)
        want = j_dio.load_hub_or_local(str(tmp_path / path), split=split)
        assert got[:] == want[:]
    loaded = datasets.load_from_disk(str(tmp_path / "dict"))
    (gs, gn), (ws, wn) = t_dio.pick_bench_split(loaded), j_dio.pick_bench_split(loaded)
    assert gn == wn == "test" and gs[:] == ws[:]
    only = datasets.DatasetDict({"validation": ds})
    assert t_dio.pick_bench_split(only)[1] == j_dio.pick_bench_split(only)[1] == "validation"


def test_load_minif2f_filters_split(tmp_path, capsys):
    data = [{"name": "a", "split": "test"}, {"name": "b", "split": "valid"},
            {"name": "c", "split": "test"}]
    p = tmp_path / "m.json"
    p.write_text(json.dumps(data))
    for split, n in (("test", None), ("valid", None), ("test", 1), ("test", 0)):
        assert t_dio.load_minif2f(p, split, n) == j_dio.load_minif2f(p, split, n)
    assert [x["name"] for x in t_dio.load_minif2f(p, "test")] == ["a", "c"]


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

@pytest.fixture()
def patched(monkeypatch):
    """Point each side's ``runner_from_args`` at the bridged runner pair of
    ``--preset``; the port's must be asked for the CPU."""
    def patch(*cli_pairs):
        for j_cli, t_cli in cli_pairs:
            monkeypatch.setattr(j_cli, "runner_from_args",
                                lambda args: runner_pair(args.preset)[0])

            def port_runner(args):
                assert args.device == "cpu"
                return runner_pair(args.preset)[1]

            monkeypatch.setattr(t_cli, "runner_from_args", port_runner)
    return patch


@pytest.mark.parametrize("style,preset,extra", [
    ("llada", "llada-tiny", TINY_GEN + ["--batch-size", "2"]),
    ("llada", "llada-moe-tiny", TINY_GEN),
    ("dream", "dream-tiny", ["--max-new-tokens", "16", "--steps", "8",
                             "--dream-temperature", "0", "--batch-size", "2"]),
    ("diffucoder", "dream-tiny", ["--max-new-tokens", "16", "--steps", "8",
                                  "--dream-temperature", "0"]),
])
def test_bench_main_matches_jax(tmp_path, monkeypatch, capsys, patched, style,
                                preset, extra):
    patched((j_bench_cli, t_bench_cli))
    jr, tr = runner_pair(preset)
    rec_j, rec_t = Recording(jr, monkeypatch), Recording(tr, monkeypatch)
    data = write_jsonl(tmp_path / "oly.jsonl", entries(3))
    common = ["--style", style, "--preset", preset, "--dataset-path", str(data),
              "--max-samples", "3", "--save-interval", "2", "--fake-lean",
              "--quiet"] + extra
    j_bench_cli.main(common + ["--results-dir", str(tmp_path / "j")])
    out_j = capsys.readouterr().out
    t_bench_cli.main(common + ["--results-dir", str(tmp_path / "t"), "--device", "cpu"])
    out_t = capsys.readouterr().out
    assert len(rec_t.ids) == len(rec_j.ids) > 0
    for got, want in zip(rec_t.ids, rec_j.ids):
        np.testing.assert_array_equal(got, want)
    assert_same_files(tmp_path / "j", tmp_path / "t")
    assert "Using split: train  (3 entries)" in out_t and "Benchmark completed!" in out_t
    metrics = lambda out: strip_timing(json.loads(out[out.rindex("\n{"):]))
    assert metrics(out_t) == metrics(out_j)
    report = json.loads((tmp_path / "t" / "final_report.json").read_text())
    assert report["benchmark_info"]["device"] == "cpu"
    assert report["benchmark_info"]["total_samples"] == 3


@pytest.mark.parametrize("extra", [["--batch-size", "2"], ["--no-pipeline"],
                                   ["--prompt-bucket", "1", "--num-samples", "2"],
                                   ["--no-verify"]])
def test_minif2f_main_matches_jax(tmp_path, monkeypatch, patched, extra):
    patched((j_minif2f_cli, t_minif2f_cli))
    jr, tr = runner_pair("llada-tiny")
    rec_j, rec_t = Recording(jr, monkeypatch), Recording(tr, monkeypatch)
    path = minif2f_json(tmp_path / "m.json")
    common = ["--preset", "llada-tiny", "--json-path", str(path), "--fake-lean"] \
        + TINY_GEN + extra
    try:
        j_minif2f_cli.main(common + ["--output-dir", str(tmp_path / "j")])
        bucket_j = jr.prompt_bucket
        t_minif2f_cli.main(common + ["--output-dir", str(tmp_path / "t"),
                                     "--device", "cpu"])
        bucket_t = tr.prompt_bucket
    finally:
        jr.prompt_bucket = tr.prompt_bucket = 64
    assert bucket_t == bucket_j
    for got, want in zip(rec_t.ids, rec_j.ids):
        np.testing.assert_array_equal(got, want)
    assert len(rec_t.ids) == len(rec_j.ids) > 0
    assert_same_files(tmp_path / "j", tmp_path / "t")
    (res,) = (tmp_path / "t").glob("minif2f_lean4_results_test_*.json")
    assert json.loads(res.read_text())["stats"]["errors"] == 0


@pytest.mark.parametrize("split,extra", [
    ("test", []), ("val", ["--no-lean-only"]),
    ("val_from_training", ["--training-like-max-samples", "20"]),
    ("train", ["--no-avoid-eos", "--no-truncate-at-eos"])])
def test_infer_split_main_matches_jax(tmp_path, monkeypatch, patched, split, extra):
    patched((j_infer, t_infer))
    data = write_jsonl(tmp_path / "numina.jsonl", numina_rows(30))
    common = ["--preset", "llada-tiny", "--dataset", str(data), "--split", split,
              "--num-samples", "2", "--seed", "5"] + TINY_GEN + extra
    j_infer.main(common + ["--save-dir", str(tmp_path / "j")])
    t_infer.main(common + ["--save-dir", str(tmp_path / "t"), "--device", "cpu"])
    rows = lambda tag: [json.loads(line) for line in
                        (tmp_path / tag / "generations.jsonl").read_text().splitlines()]
    got, want = rows("t"), rows("j")
    assert len(got) == len(want) == 2
    assert strip_timing(got) == strip_timing(want)
    assert all(r["reference"] == "trivial" for r in got)


def test_analyze_main_matches_jax(tmp_path):
    results = [{"generated_solution": "theorem t : True := by trivial",
                "lean_compilation_success": True, "has_proof_structure": True,
                "generation_time": 2.0, "lean_keywords_used": 3,
                "has_theorem_declaration": True},
               {"generated_solution": "", "generation_time": 1.0}]
    rp = tmp_path / "results_batch_2.json"
    rp.write_text(json.dumps(results))
    for flags in (["--no-syntax-check"], []):
        for tag, mod in (("j", j_analyze), ("t", t_analyze)):
            mod.main(["--results", f"llada={rp}", f"dream={rp}",
                      "--output-dir", str(tmp_path / tag)] + flags)
        for name in ("model_performance.md", "model_performance.csv",
                     "model_performance.json"):
            assert (tmp_path / "t" / name).read_bytes() == \
                (tmp_path / "j" / name).read_bytes(), name


def _lean_check(mod, argv, capsys):
    try:
        mod.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    except ValueError as e:
        code = f"ValueError: {e}"
    return code, capsys.readouterr().out


def test_lean_check_main_matches_jax(tmp_path, capsys, monkeypatch):
    """Exit codes and messages; no lean binary here, so every snippet is
    invalid."""
    monkeypatch.setenv("HOME", str(tmp_path))
    listed = tmp_path / "r.json"
    listed.write_text(json.dumps([{"generated_solution": "x"}, {"other": 1},
                                  {"generated_solution": ""}]))
    scalar = tmp_path / "s.json"
    scalar.write_text(json.dumps({"generated_solution": "x"}))
    cases = [[], ["--check_lean_syntax"], ["--check_lean_syntax", "theorem t : True"],
             ["--check_lean_syntax", "  "], [str(listed)], [str(scalar)]]
    seen = []
    for argv in cases:
        got = _lean_check(t_lean_check, argv, capsys)
        want = _lean_check(j_lean_check, argv, capsys)
        assert got == want, argv
        seen.append(got[0])
    assert seen == [1, 1, 1, 1, 0, "ValueError: Expected top-level array"]
