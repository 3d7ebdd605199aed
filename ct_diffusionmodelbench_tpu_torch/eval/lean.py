"""Lean 4 verification: single-file compile, lake-project build, async pool.

Counterpart of ``eval/lean.py``:

- single-file ``lean file.lean`` with a timeout, return code 0 ⇒ compiled
  (``~/.elan/bin`` prepended to PATH),
- the syntax-check oracle with a 5 s timeout (:func:`is_valid_lean`),
- the MiniF2F lake project: ``lean-toolchain``, a ``lakefile.lean`` that
  requires mathlib4, ``MinifF2FEval.lean``; ``lake update`` once per
  workspace (30 min budget), ``lake build`` per proof with its own timeout,
- :class:`FakeLeanVerifier`, the deterministic offline oracle,
- :class:`AsyncVerifier`, a thread pool that overlaps CPU-bound Lean builds
  with generation on the card.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

LAKEFILE = """import Lake
open Lake DSL

package minif2f_eval

require mathlib from git
  "https://github.com/leanprover-community/mathlib4.git"

@[default_target]
lean_lib MinifF2FEval
"""


def _lean_binary() -> str:
    """Prefer the elan-managed binary like the Dream benchmark (dream.py:115-117)."""
    elan = os.path.expanduser("~/.elan/bin/lean")
    return elan if os.path.exists(elan) else "lean"


def lean_available() -> bool:
    return shutil.which(_lean_binary()) is not None or os.path.exists(_lean_binary())


def _env_with_elan() -> dict:
    env = os.environ.copy()
    env["PATH"] = f"{os.path.expanduser('~/.elan/bin')}:{env.get('PATH', '')}"
    return env


class LeanVerifier:
    """Single-file ``lean file.lean`` compilation check."""

    def __init__(self, timeout: int = 60):
        self.timeout = timeout

    def verify(self, solution: str) -> Tuple[bool, str]:
        if not lean_available():
            return False, "Lean 4 not found - install Lean 4 to enable verification"
        with tempfile.NamedTemporaryFile(mode="w", suffix=".lean", delete=False) as f:
            f.write(solution)
            temp_file = f.name
        try:
            result = subprocess.run(
                [_lean_binary(), temp_file], capture_output=True, text=True,
                timeout=self.timeout, env=_env_with_elan())
            return result.returncode == 0, result.stderr or ""
        except subprocess.TimeoutExpired:
            return False, f"Compilation timeout ({self.timeout}s)"
        except FileNotFoundError:
            return False, f"Lean 4 not found at {_lean_binary()}"
        except Exception as e:
            return False, f"Verification error: {e}"
        finally:
            try:
                os.unlink(temp_file)
            except OSError:
                pass


def is_valid_lean(snippet: str, timeout: int = 5) -> bool:
    """lean_check.py:7-27 semantics: empty → False; compile with 5s budget."""
    if not snippet.strip():
        return False
    ok, _ = LeanVerifier(timeout=timeout).verify(snippet)
    return ok


class LakeProjectVerifier:
    """MiniF2F-style verification inside a (reusable) lake project."""

    def __init__(self, work_dir: Optional[Path] = None, timeout: int = 60,
                 update_timeout: int = 1800):
        self.work_dir = Path(work_dir) if work_dir else \
            Path(tempfile.mkdtemp(prefix="lean4_verify_"))
        self.timeout = timeout
        self.update_timeout = update_timeout
        self._updated = False
        # One proof file + one lake workspace: builds must serialize even
        # when driven from AsyncVerifier's pool (the pipeline win is
        # generation/verification overlap, not concurrent builds).
        self._lock = threading.Lock()

    def _bootstrap(self) -> Optional[str]:
        wd = self.work_dir
        wd.mkdir(parents=True, exist_ok=True)
        toolchain = wd / "lean-toolchain"
        if not toolchain.exists():
            toolchain.write_text("leanprover/lean4:stable\n")
        lakefile = wd / "lakefile.lean"
        if not lakefile.exists():
            lakefile.write_text(LAKEFILE)
        if not self._updated and not (wd / "lake-packages").exists() \
                and not (wd / ".lake").exists():
            try:
                r = subprocess.run(["lake", "update"], cwd=wd, capture_output=True,
                                   text=True, timeout=self.update_timeout,
                                   env=_env_with_elan())
                if r.returncode != 0:
                    return f"Lake update failed: {r.stderr}"
            except Exception as e:
                return f"Lake update error: {e}"
        self._updated = True
        return None

    def verify_proof(self, header: str, formal_statement: str,
                     generated_proof: str) -> Tuple[bool, str]:
        """The formal_statement ends with ``by``; append the tactic body
        (benchmark_finetuned.py:157-161)."""
        if shutil.which("lake") is None:
            return False, "lake not found - install Lean 4 toolchain"
        with self._lock:
            err = self._bootstrap()
            if err:
                return False, err
            lean_content = f"{header}\n\n{formal_statement}\n{generated_proof}\n"
            (self.work_dir / "MinifF2FEval.lean").write_text(lean_content)
            try:
                r = subprocess.run(["lake", "build"], cwd=self.work_dir,
                                   capture_output=True, text=True,
                                   timeout=self.timeout, env=_env_with_elan())
                if r.returncode == 0:
                    return True, "Proof verified successfully"
                return False, f"Compilation failed:\n{r.stderr}\n{r.stdout}"
            except subprocess.TimeoutExpired:
                return False, f"Verification timeout ({self.timeout}s)"
            except Exception as e:
                return False, f"Verification error: {e}"

    # uniform interface with LeanVerifier
    def verify(self, solution: str) -> Tuple[bool, str]:
        return self.verify_proof("", "", solution)


class FakeLeanVerifier:
    """Deterministic offline oracle for harness tests (SURVEY.md §4
    implication (e)): 'verifies' iff the solution contains a theorem/lemma
    and a proof body and no `sorry`."""

    def __init__(self, timeout: int = 0):
        self.calls = 0
        # AsyncVerifier's pool calls verify from several threads; the lock
        # keeps the count exact.
        self._lock = threading.Lock()

    def verify(self, solution: str) -> Tuple[bool, str]:
        with self._lock:
            self.calls += 1
        low = solution.lower()
        ok = (bool(re.search(r"\b(theorem|lemma|example)\b", low))
              and ("by" in low or ":=" in low)
              and "sorry" not in low
              and bool(solution.strip()))
        return ok, "" if ok else "fake verifier: incomplete proof"

    def verify_proof(self, header, formal_statement, generated_proof):
        return self.verify(f"{formal_statement}\n{generated_proof}"
                           if "theorem" in formal_statement.lower()
                           else generated_proof)


class AsyncVerifier:
    """Overlap Lean verification (CPU/subprocess) with generation (card).

    Submitted jobs self-time: futures resolve to (ok, msg, build_seconds),
    so pipelined drivers report the actual Lean build time instead of queue
    wait (the reference's serial loop times the build directly,
    benchmark_finetuned.py:390-399).
    """

    def __init__(self, verifier, max_workers: int = 4):
        self.verifier = verifier
        self.pool = ThreadPoolExecutor(max_workers=max_workers)

    def _timed(self, fn, *args):
        t0 = time.time()
        ok, msg = fn(*args)
        return ok, msg, time.time() - t0

    def submit(self, *args) -> Future:
        if hasattr(self.verifier, "verify_proof") and len(args) == 3:
            return self.pool.submit(self._timed, self.verifier.verify_proof, *args)
        return self.pool.submit(self._timed, self.verifier.verify, *args)

    def shutdown(self):
        self.pool.shutdown(wait=True)
