"""No module a run loads has the top-level name jax, jaxlib, flax or the
JAX package's: compared whole, since the port's name begins with it."""

import subprocess
import sys
import textwrap

from portbench.harness import cells


def _forbidden():
    import importlib.util

    spec = importlib.util.spec_from_file_location("portbench_run", cells.PORTBENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.forbidden_modules


def test_names_compare_whole():
    f = _forbidden()
    assert f({"ct_diffusionmodelbench_tpu_torch": 0, "ct_diffusionmodelbench_tpu_torch.ops": 0,
              "jaxtyping": 0, "flaxen": 0}) == []
    assert f({"ct_diffusionmodelbench_tpu.models": 0}) == ["ct_diffusionmodelbench_tpu"]
    assert f({"jax._src.core": 0, "jaxlib": 0, "flax.linen": 0}) == ["flax", "jax", "jaxlib"]


def test_the_harness_sources_name_no_jax():
    for path in cells.PORTBENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for bad in ("import jax", "from jax", "import flax", "from flax",
                    "ct_diffusionmodelbench_tpu ", "ct_diffusionmodelbench_tpu."):
            assert bad not in text, (path, bad)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run, in a process of its own, then its module table."""
    code = textwrap.dedent(f"""
        import sys, torch
        sys.path.insert(0, {str(cells.ROOT)!r})
        from pathlib import Path
        from portbench.harness import cells
        from portbench.harness.runtime import run_cell
        from portbench.tests.tiny import base
        pb = base(Path({str(tmp_path)!r}))
        out = run_cell(cells.cell("tiny-moe-eval", base=pb), 3, 0.2, False,
                       torch.device("cpu"), 0.0, base=pb)
        assert out["correct"], out
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "ct_diffusionmodelbench_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "ct_diffusionmodelbench_tpu"}
