"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the checkout's root and the cell's files under
``portbench/`` (``portbench/harness/cells.py``), runs the cell's driver on
one card (or the cell's count of cards), and prints one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit, which also end
standard error.  Progress goes to standard error.

Exits 2 without printing a result where there is no CUDA card, fewer cards
than the cell asks for, or no program beside ``portbench/``; exits 3 where
JAX, Flax or the JAX package was loaded into this process.  Every build
and kernel cache lies inside the checkout (``build/``), at fixed paths.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench-cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "ct_diffusionmodelbench_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is JAX's, Flax's
    or the JAX package's (the port's own name only begins with the last)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit in W, as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cells
    from portbench.harness.runtime import run_cell

    cell = cells.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    try:
        import ct_diffusionmodelbench_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0)
    result["device"]["power_limit_w"] = power_limit_w()
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port must not", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
