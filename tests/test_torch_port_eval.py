"""The port's eval harness against the JAX package's, on the CPU.

Both harnesses run on runners that hold the same weights (one JAX
``init_params`` tree bridged to torch) and the same byte-fallback
tokenizer.  Their result files must be equal field for field, except the
fields that time something (they differ between frameworks) and
``benchmark_info.device``, which names the device the run used.  Each
runner's ``generate`` and ``generate_batch`` are wrapped to record the token
ids they returned, so the tokens behind each row are compared too.  With
random weights most ids lie outside the byte tokenizer's range and decode
to nothing, so both tokenizers decode each id to one of a few Lean words
(``word_decode``): the texts, and so the metrics and verdicts, vary.
"""

import functools
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from ct_diffusionmodelbench_tpu.eval import analyzer as j_analyzer
from ct_diffusionmodelbench_tpu.eval import benchmark as j_bench
from ct_diffusionmodelbench_tpu.eval import lean as j_lean
from ct_diffusionmodelbench_tpu.eval import minif2f as j_minif2f
from ct_diffusionmodelbench_tpu.eval import quality as j_quality
from ct_diffusionmodelbench_tpu.eval.runner import ModelRunner as JRunner
from ct_diffusionmodelbench_tpu.io import tokenizer as j_tok
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.eval import analyzer as t_analyzer
from ct_diffusionmodelbench_tpu_torch.eval import benchmark as t_bench
from ct_diffusionmodelbench_tpu_torch.eval import lean as t_lean
from ct_diffusionmodelbench_tpu_torch.eval import minif2f as t_minif2f
from ct_diffusionmodelbench_tpu_torch.eval import quality as t_quality
from ct_diffusionmodelbench_tpu_torch.io import tokenizer as t_tok
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

# Fields that time something, and the device: the only ones the port's
# result files may differ in.
TIMING = {"generation_time", "average_generation_time", "median_generation_time",
          "avg_generation_time", "generation_time_stats", "generation_time_sec",
          "verification_time_sec", "timestamp", "latency_sec", "device"}

GOOD_PROOF = """import Mathlib
theorem add_zero_custom (n : Nat) : n + 0 = n := by
  simp
"""
SOLUTIONS = [
    GOOD_PROOF,
    GOOD_PROOF.replace("simp", "sorry"),
    "theorem t : (a := by simp",
    "lemma l : ∀ x, x ≥ 0 ∧ x ≠ 1 → x ∈ S := by\n  intro x\n  calc x = x := rfl\n  qed",
    "",
    "hello world, no proof here [ ] { }",
    "theorem t : True := by\n  trivial\n  done",
]


LEAN_WORDS = ["theorem", "n", "0", "by", "simp", ":=", "(", "sorry", ")", "lemma",
              "qed", "∀", "done", "≤", "import", "var", "calc", "exact", "```lean\n",
              "```", "{"]


def word_decode(ids, skip_special_tokens=True):
    """A word for each id and position (the random tiny models repeat one
    id for long stretches)."""
    return " ".join(LEAN_WORDS[(int(i) + k) % len(LEAN_WORDS)]
                    for k, i in enumerate(ids))


def _runners(name, seed=0):
    cfg_j = j_get_config(name, dtype="float32")
    cfg_t = t_get_config(name, dtype="float32")
    params_j = j_init(cfg_j, jax.random.key(seed))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    tok_j = j_tok.Tokenizer.byte_fallback(vocab_size=cfg_j.vocab_size, eos_token_id=2)
    tok_t = t_tok.Tokenizer.byte_fallback(vocab_size=cfg_t.vocab_size, eos_token_id=2)
    tok_j.decode = tok_t.decode = word_decode
    return (JRunner(cfg_j, params_j, tok_j),
            ModelRunner(cfg_t, params_t, tok_t, device="cpu"))


@functools.cache
def runner_pair(name):
    """(JAX runner, port runner) on the same weights, built once a process."""
    return _runners(name)


class Recording:
    """Wraps ``runner.generate`` and ``generate_batch`` to keep the token ids
    of every call, one [B, P + G] array a call."""

    def __init__(self, runner, monkeypatch):
        self.ids = []
        one, batch = runner.generate, runner.generate_batch

        def generate(*a, **kw):
            res = one(*a, **kw)
            self.ids.append(np.asarray(res.token_ids)[None])
            return res

        def generate_batch(*a, **kw):
            res = batch(*a, **kw)
            self.ids.append(np.stack([np.asarray(r.token_ids) for r in res]))
            return res

        monkeypatch.setattr(runner, "generate", generate)
        monkeypatch.setattr(runner, "generate_batch", generate_batch)


def strip_timing(obj):
    if isinstance(obj, dict):
        return {k: strip_timing(v) for k, v in obj.items() if k not in TIMING}
    if isinstance(obj, list):
        return [strip_timing(v) for v in obj]
    return obj


def assert_same_files(dir_j: Path, dir_t: Path):
    """The same file names (timestamps masked), JSON equal without the
    timing fields, text equal without the lines that report a time."""
    def names(d):
        return sorted(re.sub(r"\d{8}_\d{6}", "T", p.name) for p in d.iterdir()
                      if p.is_file())

    assert names(dir_t) == names(dir_j)
    for pj in sorted(p for p in dir_j.iterdir() if p.is_file()):
        pattern = re.sub(r"\d{8}_\d{6}", "*", pj.name)
        (pt,) = list(dir_t.glob(pattern))
        if pj.suffix == ".json":
            assert strip_timing(json.loads(pt.read_text())) == \
                strip_timing(json.loads(pj.read_text())), pj.name
        else:
            keep = lambda s: [l for l in s.splitlines() if "Generation Time" not in l]
            assert keep(pt.read_text()) == keep(pj.read_text()), pj.name


def untimed_lines(text):
    return [l for l in text.splitlines() if "time" not in l.lower()]


def entries(n=3):
    return [{"problem_id": f"p{i}", "name": f"Problem {i}",
             "category": "algebra" if i % 2 else "number_theory",
             "tags": ["t"] if i == 0 else [],
             "informal_prefix": f"Prove that {i} + 0 = {i}.",
             "formal_statement": f"theorem t{i} (n : Nat) : n + 0 = n := by"}
            for i in range(n)]


# ---------------------------------------------------------------------------
# quality metrics, code extraction, verifiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["llada", "dream", "diffucoder"])
@pytest.mark.parametrize("solution", SOLUTIONS)
def test_quality_metrics_match_jax(solution, style):
    for verifier in (None, "fake"):
        want = j_quality.evaluate_solution_quality(
            solution, "theorem add_zero_custom (n : Nat)", "a problem about n",
            verifier=verifier and j_lean.FakeLeanVerifier(), style=style)
        got = t_quality.evaluate_solution_quality(
            solution, "theorem add_zero_custom (n : Nat)", "a problem about n",
            verifier=verifier and t_lean.FakeLeanVerifier(), style=style)
        assert got == want
        assert list(got) == list(want)          # key order too
    for ref in ("", "x y z", "theorem simp"):
        assert t_quality._overlap_ratio(ref, solution.lower()) == \
            j_quality._overlap_ratio(ref, solution.lower())


@pytest.mark.parametrize("raw", [
    "```lean\nsimp\n```", "text\n```\nsimp\n```\nmore", "  simp  ", "```only one",
    "by simp", ":= by simp", ":= simp", "BY ring", "simp", ":=  by  linarith",
    "```lean\n:= by\n  norm_num\n```"])
def test_extract_and_strip_match_jax(raw):
    assert t_minif2f.extract_lean_code(raw) == j_minif2f.extract_lean_code(raw)
    assert t_minif2f.strip_proof_prefix(raw) == j_minif2f.strip_proof_prefix(raw)
    for text in (raw, "```" + raw):
        assert t_analyzer.strip_markdown_fence(text) == \
            j_analyzer.strip_markdown_fence(text)


def test_fake_verifier_matches_jax():
    vj, vt = j_lean.FakeLeanVerifier(), t_lean.FakeLeanVerifier()
    for s in SOLUTIONS + ["example : True := trivial", "theorem x : True"]:
        assert vt.verify(s) == vj.verify(s)
        for stmt in ("theorem t (n : Nat) : n = n := by", "lemma t : True := by"):
            assert vt.verify_proof("import Mathlib", stmt, s) == \
                vj.verify_proof("import Mathlib", stmt, s)
    assert vt.calls == vj.calls == 27
    aj, at = j_lean.AsyncVerifier(vj), t_lean.AsyncVerifier(vt)
    futs = [(aj.submit(s), at.submit(s)) for s in SOLUTIONS]
    futs += [(aj.submit("", "theorem t : True := by", s),
              at.submit("", "theorem t : True := by", s)) for s in SOLUTIONS]
    for fj, ft in futs:
        assert ft.result()[:2] == fj.result()[:2]
    aj.shutdown()
    at.shutdown()
    assert vt.calls == vj.calls == 41


def test_fake_verifier_counts_every_call_under_threads():
    """``calls`` stays exact when threads verify at once, as the async
    pool's do (the port guards the count with a lock).  The interpreter
    rarely switches threads inside ``calls += 1`` on its own, so a subclass
    reads ``calls`` through a property that yields the thread between the
    read and the write: without the lock the threads then overwrite each
    other's counts."""

    class YieldingCount(t_lean.FakeLeanVerifier):
        @property
        def calls(self):
            value = self._calls
            time.sleep(1e-4)
            return value

        @calls.setter
        def calls(self, value):
            self._calls = value

    v = YieldingCount()
    n_threads, per_thread = 16, 20
    start = threading.Barrier(n_threads)

    def hammer():
        start.wait(timeout=60)
        for _ in range(per_thread):
            v.verify(GOOD_PROOF)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert v.calls == n_threads * per_thread


def test_lean_missing_branches_match_jax(monkeypatch, tmp_path):
    """Neither lean nor lake here: the verifiers' not-found messages, and
    ``is_valid_lean`` / ``lean_available`` false, as the reference's."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert t_lean.lean_available() is j_lean.lean_available() is False
    assert t_lean.LeanVerifier(timeout=5).verify(GOOD_PROOF) == \
        j_lean.LeanVerifier(timeout=5).verify(GOOD_PROOF)
    for snippet in ("", "   ", GOOD_PROOF):
        assert t_lean.is_valid_lean(snippet) is j_lean.is_valid_lean(snippet) is False
    got = t_lean.LakeProjectVerifier(work_dir=tmp_path / "t").verify_proof(
        "import Mathlib", "theorem t : True := by", "trivial")
    want = j_lean.LakeProjectVerifier(work_dir=tmp_path / "j").verify_proof(
        "import Mathlib", "theorem t : True := by", "trivial")
    assert got == want == (False, "lake not found - install Lean 4 toolchain")
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("build_rc", [0, 1])
def test_lake_project_verifier_matches_jax(monkeypatch, tmp_path, build_rc):
    """A stand-in ``lake`` on PATH: the workspace bootstrap (toolchain,
    lakefile, one ``lake update``), the proof file and both build outcomes
    equal the reference's, through the async pool too."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    lake = bin_dir / "lake"
    lake.write_text("#!/bin/sh\necho \"lake $1\" >> calls.log\n"
                    f"if [ \"$1\" = build ]; then echo out; echo err >&2; exit {build_rc}; fi\n")
    lake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    results = {}
    for tag, mod in (("j", j_lean), ("t", t_lean)):
        v = mod.LakeProjectVerifier(work_dir=tmp_path / tag, timeout=30)
        first = v.verify_proof("import Mathlib", "theorem t : True := by", "trivial")
        pool = mod.AsyncVerifier(v, max_workers=2)
        later = [pool.submit("import Aesop", f"theorem u{i} : True := by", "simp")
                 for i in range(3)]
        later = [f.result()[:2] for f in later]
        pool.shutdown()
        results[tag] = (first, later, v.verify("theorem w : True := by trivial"))
    assert results["t"] == results["j"]
    assert results["t"][0][0] is (build_rc == 0)
    for name in ("lean-toolchain", "lakefile.lean", "MinifF2FEval.lean", "calls.log"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    assert (tmp_path / "t" / "calls.log").read_text().count("lake update") == 1


# ---------------------------------------------------------------------------
# benchmark sweeps
# ---------------------------------------------------------------------------

# serial: one prompt per generate, verification inline; pipelined: one
# prompt per generate, verification in the async pool; batched: chunks of
# two prompts (the last chunk of one takes the single-prompt path).
MODES = {"serial": dict(batch_size=1, pipeline=False),
         "pipelined": dict(batch_size=1, pipeline=True),
         "batched": dict(batch_size=2, pipeline=True)}


def _sweep(mod, runner, verifier, results_dir, style, mode, **over):
    kw = dict(style=style, gen_length=16, steps=8, block_length=4,
              max_new_tokens=32, dream_temperature=0.0, seed=3)
    kw.update(over)
    cfg = mod.BenchmarkConfig(results_dir=str(results_dir),
                              batch_size=MODES[mode]["batch_size"], **kw)
    bench = mod.DiffusionBenchmark(runner, cfg, verifier=verifier, quiet=False,
                                   pipeline_verification=MODES[mode]["pipeline"])
    report = bench.run_benchmark(entries(3), max_samples=3, save_interval=2)
    return bench, report


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("style", ["llada", "dream", "diffucoder"])
@pytest.mark.parametrize("name", ["llada-tiny", "llada-moe-tiny"])
def test_benchmark_sweep_matches_jax(tmp_path, monkeypatch, capsys, name, style, mode):
    """Greedy sweeps (the dream / diffucoder styles at temperature 0; their
    32 new tokens are one of the LLaDA sampler's default 32-token blocks)."""
    jr, tr = runner_pair(name)
    rec_j, rec_t = Recording(jr, monkeypatch), Recording(tr, monkeypatch)
    vj, vt = j_lean.FakeLeanVerifier(), t_lean.FakeLeanVerifier()
    bj, rep_j = _sweep(j_bench, jr, vj, tmp_path / "j", style, mode)
    out_j = capsys.readouterr().out
    bt, rep_t = _sweep(t_bench, tr, vt, tmp_path / "t", style, mode)
    out_t = capsys.readouterr().out

    assert len(rec_t.ids) == len(rec_j.ids) == (2 if mode == "batched" else 3)
    for got, want in zip(rec_t.ids, rec_j.ids):
        np.testing.assert_array_equal(got, want)
    assert_same_files(tmp_path / "j", tmp_path / "t")
    assert strip_timing(rep_t) == strip_timing(rep_j)
    assert rep_t["benchmark_info"]["device"] == "cpu"
    assert rep_j["benchmark_info"]["device"].startswith("tpu:")
    assert vt.calls == vj.calls == 3
    assert all(r["generation_success"] for r in bt.results)
    untimed = lambda stats: {k: v for k, v in stats.items() if k != "generation_times"}
    assert untimed(bt.stats) == untimed(bj.stats)
    expected = {"final_report.json", "all_results.json", "results_batch_2.json",
                "results_batch_3.json"} | ({"summary_report.txt"} if style == "dream"
                                            else set())
    assert {p.name for p in (tmp_path / "t").iterdir()} == expected
    assert untimed_lines(out_t.replace(str(tmp_path / "t"), "D")) == \
        untimed_lines(out_j.replace(str(tmp_path / "j"), "D"))   # the printout


def test_benchmark_auto_adjust_matches_jax(tmp_path, monkeypatch, capsys):
    jr, tr = runner_pair("llada-tiny")
    rec_j, rec_t = Recording(jr, monkeypatch), Recording(tr, monkeypatch)
    cfgs = []
    for tag, mod, runner in (("j", j_bench, jr), ("t", t_bench, tr)):
        cfg = mod.BenchmarkConfig(style="llada", gen_length=18, steps=7, block_length=4,
                                  results_dir=str(tmp_path / tag))
        mod.DiffusionBenchmark(runner, cfg, quiet=True).run_benchmark(
            entries(1), max_samples=1, save_interval=1)
        cfgs.append((cfg.gen_length, cfg.steps, capsys.readouterr().out))
    (gj, sj, out_j), (gt, st, out_t) = cfgs
    assert (gt, st) == (gj, sj) == (16, 8)
    warn = lambda s: [l for l in s.splitlines() if l.startswith("[Warning]")]
    assert warn(out_t) == warn(out_j) and len(warn(out_t)) == 2
    np.testing.assert_array_equal(rec_t.ids[0], rec_j.ids[0])
    assert_same_files(tmp_path / "j", tmp_path / "t")


@pytest.mark.parametrize("exc", [RuntimeError("tensor shape mismatch"),
                                 MemoryError("out of memory"),
                                 ValueError("dimension 3 too large"),
                                 TimeoutError("timeout after 5s")])
def test_failing_generation_rows_match_jax(tmp_path, monkeypatch, capsys, exc):
    """A runner whose generate raises: the batch falls back to per-sample
    generation with the reference's warning, and the error rows, failure
    files and ``failure_analysis`` are the reference's."""
    jr, tr = runner_pair("llada-tiny")

    def boom(*a, **kw):
        raise exc

    outs, reports = [], []
    for tag, mod, lean_mod, runner in (("j", j_bench, j_lean, jr),
                                       ("t", t_bench, t_lean, tr)):
        monkeypatch.setattr(runner, "generate", boom)
        monkeypatch.setattr(runner, "generate_batch", boom)
        _, rep = _sweep(mod, runner, lean_mod.FakeLeanVerifier(), tmp_path / tag,
                        "dream", "batched")
        outs.append(capsys.readouterr().out)
        reports.append(rep)
    assert_same_files(tmp_path / "j", tmp_path / "t")
    assert strip_timing(reports[1]) == strip_timing(reports[0])
    fa = reports[1]["failure_analysis"]
    assert fa["total_failures"] == 3 and fa["failure_rate"] == 100.0
    warn = lambda s: [l for l in s.splitlines() if "[Warning]" in l]
    assert warn(outs[1]) == warn(outs[0]) and len(warn(outs[1])) == 1
    assert (tmp_path / "t" / "failures_2.json").exists()


# ---------------------------------------------------------------------------
# MiniF2F
# ---------------------------------------------------------------------------

def minif2f_json(path: Path, n=3):
    problems = [{"name": f"prob_{i}", "split": "test",
                 "informal_statement": f"Show that n + {i} = {i} + n.",
                 "formal_statement": f"theorem prob_{i} (n : ℕ) : n + {i} = {i} + n := by",
                 "header": "import Mathlib\nimport Aesop\n\nset_option maxHeartbeats 400000\n\n"
                           "open BigOperators Real Nat Topology Rat"}
                for i in range(n)]
    problems.append({"name": "valid_one", "split": "valid", "informal_statement": "x",
                     "formal_statement": "theorem v : True := by",
                     "header": "import Mathlib"})
    path.write_text(json.dumps(problems))
    return path


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["llada-tiny", "llada-moe-tiny"])
def test_minif2f_matches_jax(tmp_path, monkeypatch, name, mode):
    jr, tr = runner_pair(name)
    rec_j, rec_t = Recording(jr, monkeypatch), Recording(tr, monkeypatch)
    path = minif2f_json(tmp_path / "m.json")
    outs = []
    for tag, mod, lean_mod, runner in (("j", j_minif2f, j_lean, jr),
                                       ("t", t_minif2f, t_lean, tr)):
        outs.append(mod.run_minif2f_evaluation(
            runner, path, output_dir=tmp_path / tag, split="test", gen_length=16,
            steps=8, block_length=4, verifier=lean_mod.FakeLeanVerifier(),
            pipeline_verification=MODES[mode]["pipeline"],
            batch_size=MODES[mode]["batch_size"]))
    assert len(rec_t.ids) == len(rec_j.ids) == (2 if mode == "batched" else 3)
    for got, want in zip(rec_t.ids, rec_j.ids):
        np.testing.assert_array_equal(got, want)
    assert strip_timing(outs[1]) == strip_timing(outs[0])
    assert_same_files(tmp_path / "j", tmp_path / "t")
    stats = outs[1]["stats"]
    assert stats["total"] == 3 and stats["errors"] == 0
    for r in outs[1]["results"]:
        assert {"generated_proof", "verified", "verification_time_sec"} <= set(r)


def test_minif2f_error_rows_match_jax(tmp_path, monkeypatch):
    """Generation that raises gives ``error`` rows, serial and batched, and
    no verification at all (``verify_proofs=False``) the skipped rows."""
    jr, tr = runner_pair("llada-tiny")
    path = minif2f_json(tmp_path / "m.json")

    def boom(*a, **kw):
        raise RuntimeError("device lost")

    for bs in (1, 2):
        outs = []
        for tag, mod, lean_mod, runner in (("j", j_minif2f, j_lean, jr),
                                           ("t", t_minif2f, t_lean, tr)):
            with monkeypatch.context() as m:
                m.setattr(runner, "generate", boom)
                m.setattr(runner, "generate_batch", boom)
                outs.append(mod.run_minif2f_evaluation(
                    runner, path, output_dir=tmp_path / f"{tag}{bs}",
                    gen_length=16, steps=8, block_length=4,
                    verifier=lean_mod.FakeLeanVerifier(), batch_size=bs))
        assert strip_timing(outs[1]) == strip_timing(outs[0])
        assert outs[1]["stats"]["errors"] == 3
    outs = [mod.run_minif2f_evaluation(runner, path, output_dir=tmp_path / f"{tag}n",
                                       gen_length=16, steps=8, block_length=4,
                                       verify_proofs=False)
            for tag, mod, runner in (("j", j_minif2f, jr), ("t", t_minif2f, tr))]
    assert strip_timing(outs[1]) == strip_timing(outs[0])
    assert {r["verification_message"] for r in outs[1]["results"]} == \
        {"Verification skipped"}


# ---------------------------------------------------------------------------
# analyzer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("checker", ["theorem", "default"])
def test_analyzer_matches_jax_byte_for_byte(tmp_path, checker):
    rows = [
        {"generated_solution": GOOD_PROOF, "lean_compilation_success": True,
         "has_proof_structure": True, "generation_time": 1.5,
         "lean_keywords_used": 4, "has_theorem_declaration": True},
        {"generated_solution": "", "lean_compilation_success": False,
         "has_proof_structure": False, "generation_time": 0.5,
         "lean_keywords_used": 0, "has_theorem_declaration": False},
        {"generated_solution": "```lean\ntheorem x : True := trivial\n```",
         "generation_time": 0.25, "lean_keywords_used": 1},
    ]
    paths = {}
    for model, n in (("llada", 3), ("dream", 2), ("mystery", 1)):
        p = tmp_path / f"{model}.json"
        p.write_text(json.dumps(rows[:n]))
        paths[model] = str(p)
    check = (lambda code: "theorem" in code) if checker == "theorem" else None
    got = t_analyzer.ModelAnalyzer(paths, syntax_checker=check,
                                   output_dir=str(tmp_path / "t")).run_analysis()
    want = j_analyzer.ModelAnalyzer(paths, syntax_checker=check,
                                    output_dir=str(tmp_path / "j")).run_analysis()
    assert got == want
    for name in ("model_performance.md", "model_performance.csv",
                 "model_performance.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def test_port_modules_import_without_datasets():
    """Every port module imports where ``datasets`` is missing (the card's
    machine has none): only loading a dataset needs it."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['datasets'] = None\n"
        "import ct_diffusionmodelbench_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from ct_diffusionmodelbench_tpu_torch.io import load_hub_or_local\n"
        "try:\n"
        "    load_hub_or_local('x.jsonl')\n"
        "except ImportError:\n"
        "    print('lazy')\n"
        "print(sorted(n for n in names if '.cli.' in n or '.eval.' in n))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lazy, names = res.stdout.strip().splitlines()[-2:]
    assert lazy == "lazy"
    for mod in ("cli.bench", "cli.minif2f", "cli.infer_split", "cli.analyze",
                "cli.lean_check", "eval.benchmark", "eval.minif2f", "eval.lean",
                "eval.quality", "eval.analyzer"):
        assert f"'ct_diffusionmodelbench_tpu_torch.{mod}'" in names, mod
