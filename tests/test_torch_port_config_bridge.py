"""PyTorch port: config mirror, weight bridge, import and device guards.

The port (``ct_diffusionmodelbench_tpu_torch``) keeps its own copy of the
config; every preset must equal the JAX package's field by field and in the
analytic counts.  The bridge must carry bf16 and f32 leaves bit for bit.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.models import config as jcfg
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import config as tcfg

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ct_diffusionmodelbench_tpu_torch"


# The int8 serving slice's modules, named so that the import checks below
# provably cover them.
NEW_IN_INT8_SLICE = ("eval.runner", "io.checkpoint", "io.tokenizer",
                     "ops.quant", "quantize_ckpt")
# ... and the single-prompt serving slice's.
NEW_IN_SINGLE_PROMPT_SLICE = ("cli.chat", "cli.chat_base", "cli.common",
                              "sampling.dream", "sampling.simple")


def _is_forbidden(module: str) -> bool:
    # Beware the prefix: ct_diffusionmodelbench_tpu_torch starts with the
    # JAX package's name, so match the exact name or the dotted prefix.
    return (module == "jax" or module.startswith("jax.")
            or module == "ct_diffusionmodelbench_tpu"
            or module.startswith("ct_diffusionmodelbench_tpu."))


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_matches_jax(name):
    j, t = jcfg.PRESETS[name], tcfg.PRESETS[name]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.is_moe, j.q_size, j.kv_size) == (t.is_moe, t.q_size, t.kv_size)
    assert j.param_count() == t.param_count()
    assert j.active_param_count() == t.active_param_count()
    for seq, head in ((320, 32), (320, None), (2048, None)):
        assert j.forward_flops(seq, head) == t.forward_flops(seq, head)


def test_preset_names_match():
    assert sorted(jcfg.PRESETS) == sorted(tcfg.PRESETS)


def test_config_from_hf_matches_jax():
    hf = {"model_type": "lladamoe", "vocab_size": 1000, "hidden_size": 256,
          "num_hidden_layers": 3, "num_attention_heads": 8,
          "num_key_value_heads": 2, "num_experts": 16,
          "num_experts_per_tok": 4, "moe_intermediate_size": 96,
          "use_qk_norm": True, "eos_token_id": [7, 8], "rope_theta": 5e5}
    assert (dataclasses.asdict(jcfg.config_from_hf(hf, name="x"))
            == dataclasses.asdict(tcfg.config_from_hf(hf, name="x")))
    assert tcfg.get_config("llada-tiny", dtype="float32").dtype == "float32"


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_bridge_round_trip_exact(dtype):
    rng = np.random.default_rng(0)
    tree = {"a": jnp.asarray(rng.standard_normal((3, 5)), dtype),
            "blocks": {"w": jnp.asarray(rng.standard_normal((2, 4, 6)), dtype)},
            "ids": jnp.arange(7, dtype=jnp.int32)}
    np_tree = jax.tree.map(np.asarray, tree)
    out = params_from_numpy(np_tree, device="cpu")
    want_t = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert out["a"].dtype == want_t and out["blocks"]["w"].dtype == want_t
    assert out["blocks"]["w"].shape == (2, 4, 6)
    for got, want in ((out["a"], np_tree["a"]),
                      (out["blocks"]["w"], np_tree["blocks"]["w"])):
        if dtype == jnp.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(out["ids"].numpy(), np.arange(7))


def test_port_imports_no_jax_at_runtime():
    """Importing every port module (and chip_smoke.py) pulls in neither jax
    nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ct_diffusionmodelbench_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ct_diffusionmodelbench_tpu'\n"
        "       or m.startswith('ct_diffusionmodelbench_tpu.')]\n"
        "print(sorted(bad))\n"
        "n = sum(1 for m in sys.modules\n"
        "        if m.startswith('ct_diffusionmodelbench_tpu_torch.'))\n"
        "print(sorted(m for m in sys.modules if m.startswith(p.__name__)))\n"
        "print(n)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    bad, names, n = res.stdout.strip().splitlines()[-3:]
    assert bad == "[]"
    assert int(n) >= 15  # every module was really imported
    for mod in NEW_IN_INT8_SLICE + NEW_IN_SINGLE_PROMPT_SLICE:
        assert f"'ct_diffusionmodelbench_tpu_torch.{mod}'" in names, mod


def test_each_port_module_imports_first():
    """Every module imports as the first of the package in a process (no
    import cycle that only a lucky import order hides)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ct_diffusionmodelbench_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "failed = []\n"
        "for name in names:\n"
        "    for m in [m for m in sys.modules if m.startswith(p.__name__)]:\n"
        "        del sys.modules[m]\n"
        "    try:\n"
        "        importlib.import_module(name)\n"
        "    except ImportError as e:\n"
        "        failed.append(f'{name}: {e}')\n"
        "print(len(names))\n"
        "print(failed)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, failed = res.stdout.strip().splitlines()[-2:]
    assert int(n) >= 15
    assert failed == "[]"


def test_port_sources_import_no_jax():
    """No import statement anywhere in the port, lazy ones included, names
    jax or the JAX package."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [(f.name, n) for n in names if _is_forbidden(n)]
    assert len(files) >= 15
    for mod in NEW_IN_INT8_SLICE + NEW_IN_SINGLE_PROMPT_SLICE:
        assert PORT / (mod.replace(".", "/") + ".py") in files, mod
    assert found == []


def test_entry_points_raise_without_card(monkeypatch):
    from ct_diffusionmodelbench_tpu_torch.models import init_params, make_forward_fn
    from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.get_config("llada-tiny", dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_forward_fn(cfg)
    fwd = make_forward_fn(cfg, device="cpu")
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llada_generate(fwd, params, torch.zeros((1, 4), dtype=torch.long),
                       steps=2, gen_length=4, block_length=4, mask_id=500)

    from ct_diffusionmodelbench_tpu_torch.train.trainer import (
        TrainConfig, Trainer, make_optimizer, make_train_step)

    rows = [{"input_ids": [5] * 8, "prompt_lengths": 1}] * 4
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, params, TrainConfig(), rows)
    opt, _ = make_optimizer(TrainConfig(), 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, TrainConfig(), opt)
    assert Trainer(cfg, params, TrainConfig(), rows, device="cpu").device.type == "cpu"
