"""The port's headline bench and perf sweep (``bench.py``,
``bench_sweep.py``) against the root ``bench.py`` / ``bench_sweep.py`` on
the CPU: the rows' arithmetic value for value, the decode token for token on
bridged weights, the line's schema, the failure path, and every sweep
section at tiny sizes."""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
import bench_sweep as jsweep
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init_params
from ct_diffusionmodelbench_tpu.models import make_cached_fns as j_cached_fns
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_forward_fn
from ct_diffusionmodelbench_tpu.sampling import llada_generate as j_generate
from ct_diffusionmodelbench_tpu.train.trainer import TrainConfig as JTrainConfig
from ct_diffusionmodelbench_tpu_torch import bench as tbench
from ct_diffusionmodelbench_tpu_torch import bench_sweep as tsweep
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import make_cached_fns as t_cached_fns
from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn as t_forward_fn
from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm import grouped_expert_ffn
from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig as TTrainConfig
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
H100 = 989.0


# ---------------------------------------------------------------------------
# the headline's arithmetic and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset,steps,batch,dt,peak", [
    ("llada-moe-7b", 128, 8, 7.418, H100),
    ("llada-moe-7b", 128, 1, 2.127, H100),
    ("llada-moe-7b", 128, 32, 13.0031, 756.0),
    ("llada-2b", 256, 8, 4.5, float("nan")),
])
def test_batch_row_matches_jax(monkeypatch, preset, steps, batch, dt, peak):
    monkeypatch.setattr(jbench, "measure", lambda *a, **k: dt)
    monkeypatch.setattr(tbench, "measure", lambda *a, **k: dt)
    kw = dict(steps=steps, batch=batch, reps=2, peak=peak, n_chips=1, with_onchip=False)
    want = jbench.batch_row(j_get_config(preset), None, None, **kw)
    got = tbench.batch_row(t_get_config(preset), None, None, **kw)
    assert got == want
    assert (got["mfu"] is None) == np.isnan(peak)


@pytest.mark.parametrize("fl,dt,n,peak", [(1.5e15, 7.4, 1, H100), (3e12, 0.5, 4, 197.0),
                                         (1e15, 2.0, 1, float("nan"))])
def test_mfu_matches_jax(fl, dt, n, peak):
    assert tbench._mfu(fl, dt, n, peak) == jbench._mfu(fl, dt, n, peak)


def test_peak_table_keys_cuda_names():
    cpu = torch.device("cpu")
    kind, peak = tbench.chip_peak_tflops(cpu)
    assert kind == "cpu" and np.isnan(peak)
    assert tbench.PEAK_BF16_TFLOPS["NVIDIA H100 80GB HBM3"] == 989.0
    assert tbench.PEAK_BF16_TFLOPS["NVIDIA H100 PCIe"] == 756.0
    assert tbench.REFERENCE_DENOISED_TOK_PER_SEC == jbench.REFERENCE_DENOISED_TOK_PER_SEC
    assert (tbench.PROMPT_LEN, tbench.GEN_LENGTH, tbench.BLOCK_LENGTH) == (
        jbench.PROMPT_LEN, jbench.GEN_LENGTH, jbench.BLOCK_LENGTH)


@pytest.mark.parametrize("mode", ["exact", "block-cache", "block-cache+threshold"])
def test_decode_matches_jax(mode):
    """The bench's decode call (its ``kw`` at the CPU shape: 16 steps, gen
    256, block 32, greedy) on bridged ``llada-moe-tiny`` weights equals JAX
    ``llada_generate`` token for token."""
    jcfg = j_get_config("llada-moe-tiny", dtype="float32")
    tcfg = t_get_config("llada-moe-tiny", dtype="float32")
    jparams = j_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    prompt = np.random.default_rng(1).integers(10, 490, (2, tbench.PROMPT_LEN))
    extra_j, extra_t = {}, {}
    if mode != "exact":
        extra_j = dict(block_cache=True, cached_fns=j_cached_fns(jcfg))
        extra_t = dict(cached_fns=t_cached_fns(tcfg))
    if mode == "block-cache+threshold":
        extra_j["parallel_threshold"] = extra_t["parallel_threshold"] = 0.9
    want = np.asarray(j_generate(
        j_forward_fn(jcfg), jparams, jnp.asarray(prompt, jnp.int32), steps=16,
        gen_length=jbench.GEN_LENGTH, block_length=jbench.BLOCK_LENGTH, temperature=0.0,
        mask_id=jcfg.mask_token_id, **extra_j))
    got = tbench.decode(t_forward_fn(tcfg, "cpu"), tparams, torch.from_numpy(prompt),
                        tbench.decode_kw(tcfg, 16, **extra_t), "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_prompt_ids_never_the_mask_id():
    cfg = t_get_config("llada-moe-tiny")
    p = tbench.prompt_ids(cfg, 4)
    assert p.shape == (4, tbench.PROMPT_LEN)
    assert int(p.min()) >= 10 and int(p.max()) < min(cfg.vocab_size - 10, cfg.mask_token_id)
    assert torch.equal(p, tbench.prompt_ids(cfg, 4))   # seeded


# ---------------------------------------------------------------------------
# the line: schema, error line, exit codes
# ---------------------------------------------------------------------------

def _reference_line():
    return json.loads((REPO / "BENCH_r05.json").read_text())["parsed"]


def test_main_cpu_prints_one_line_in_the_reference_schema(capsys):
    assert tbench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line, ref = json.loads(out[0]), _reference_line()
    assert list(line) == list(ref)
    assert list(line["config"]) == list(ref["config"])
    assert line["metric"] == ref["metric"] and line["unit"] == ref["unit"]
    assert line["value"] > 0 and line["config"]["value_source"] == "wall_clock"
    head = line["config"]["headline"]
    assert head["model"] == "llada-moe-tiny" and head["batch"] == 2
    assert line["config"]["backend"] == "cpu" and line["config"]["chip_kind"] == "cpu"


def test_error_line_keys_match_jax(capsys):
    jbench.emit_error_line("boom")
    want = json.loads(capsys.readouterr().out)
    tbench.emit_error_line("boom", tbench.Budget(1200.0))
    got = json.loads(capsys.readouterr().out)
    assert list(got) == list(want)
    assert list(got["config"]) == list(want["config"])
    assert got["value"] is None and got["error"] == "boom"


def test_failure_prints_the_error_line_and_exits_1(monkeypatch, capsys):
    """Without a card and without ``--device cpu`` the run fails: the
    error line, rc 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbench.main([]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["value"] is None and "no CUDA device" in line["error"]


def test_forced_failure_mid_run_exits_1(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("decode broke")

    monkeypatch.setattr(tbench, "measure", broken)
    assert tbench.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip())
    assert line["error"] == "RuntimeError: decode broke"


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt,oc,remat,state,accum", [
    (0.681, 0.6123, True, "float32", "float32"),
    (2.1789, None, True, "int8", "bfloat16"),
    (1.25, 1.1, False, "bfloat16", "float32"),
])
def test_sft_row_matches_jax(monkeypatch, dt, oc, remat, state, accum):
    for mod in (jsweep, tsweep):
        monkeypatch.setattr(mod, "_measure_train_step", lambda *a, **k: (dt, 123, oc))
        monkeypatch.setattr(mod, "_peak", lambda: H100 * 1e12)
    kw = dict(learning_rate=5e-5, grad_accum=4, batch_size=1, max_length=2048, remat=remat,
              optimizer_state_dtype=state, grad_accum_dtype=accum)
    for preset in ("llada-2b", "llada-moe-7b"):
        want = jsweep._sft_row(j_get_config(preset), JTrainConfig(**kw), "label",
                               A=4, B=1, L=2048)
        got = tsweep._sft_row(t_get_config(preset), TTrainConfig(**kw), "label",
                              A=4, B=1, L=2048)
        assert got == want


def _tiny(name, **over):
    return t_get_config(name, dtype="float32", **over)


TINY = {
    "attention_crossover": dict(shapes=((1, (32, 64)), (2, (32,))), heads=4, head_dim=16,
                                dtype=torch.float32, iters=2, reps=1),
    "grouped_gemm": dict(N=16, K=2, E=4, D=32, Fm=16, dtype=torch.float32, iters=2, reps=1),
    "dream_reference_config": dict(cfg=_tiny("dream-tiny"), steps=4, gen_length=8,
                                   prompt_len=8, batch=2, reps=1),
    "sft_train_step": dict(cfg=_tiny("llada-tiny"), A=2, B=1, L=32),
    "sft_train_step_int8_adam": dict(cfg=_tiny("llada-tiny"), A=2, B=1, L=32),
    "sft_train_step_moe": dict(cfg=_tiny("llada-moe-tiny"), ladder=(2,), A=2, B=1, L=32),
    "llada_8b_int8_single_chip": dict(cfg=_tiny("llada-tiny"), steps=4, gen_length=8,
                                      block_length=4, prompt_len=8, batch=2, reps=1),
}
ROW_KEYS = {
    "grouped_gemm": {"grouped_mm_ms", "kernel_ms", "kernel_speedup", "shape"},
    "dream_reference_config": {"single_sample_sec", "batched_sec_per_sample", "batch",
                               "mfu", "vs_dream_baseline_49.61s"},
    "sft_train_step": {"seconds_per_step", "tokens_per_second_per_chip", "train_mfu",
                       "hardware_util_with_remat"},
    "llada_8b_int8_single_chip": {"weights_gb", "tok_per_sec_per_chip", "mfu"},
}


@pytest.mark.parametrize("name", list(tsweep.SECTIONS))
def test_sweep_section_runs_tiny_on_cpu(name, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the MoE rung's process
    out = tsweep.SECTIONS[name](device="cpu", **TINY[name])
    rows = out if isinstance(out, list) else [out]
    assert rows and all("error" not in r for r in rows)
    keys = ROW_KEYS.get(name.replace("_int8_adam", "").replace("_moe", ""), set())
    assert keys <= set(rows[0])
    if name == "attention_crossover":
        assert [(r["batch"], r["seq_len"]) for r in rows] == [(1, 32), (1, 64), (2, 32)]
        assert all(r["reference_ms"] > 0 and r["flash_ms"] > 0 for r in rows)
    if name.startswith("sft"):
        assert rows[0]["seconds_per_step"] > 0
    if name == "sft_train_step_moe":
        assert "2 layers" in rows[0]["model"]
    if name == "llada_8b_int8_single_chip":
        assert rows[0]["weights_gb"] >= 0


def test_grouped_mm_ffn_is_the_kernels_function():
    gen = torch.Generator().manual_seed(3)
    n, k, e, d, f = 24, 2, 4, 32, 16
    x = torch.randn((n, d), generator=gen)
    probs = torch.softmax(torch.randn((n, k), generator=gen), -1)
    idx = torch.randint(0, e, (n, k), generator=gen)
    wg, wu = (torch.randn((e, d, f), generator=gen) * 0.2 for _ in range(2))
    wd = torch.randn((e, f, d), generator=gen) * 0.2
    want = grouped_expert_ffn(x, probs, idx, wg, wu, wd)
    got = tsweep.grouped_mm_ffn(x, probs, idx, wg, wu, wd)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sweep_writes_its_file_and_reports_errors(tmp_path, monkeypatch, capsys):
    out = tmp_path / "sweep.json"
    monkeypatch.setitem(tsweep.SECTIONS, "grouped_gemm",
                        lambda device=None: (_ for _ in ()).throw(RuntimeError("no")))
    monkeypatch.setitem(tsweep.SECTIONS, "attention_crossover",
                        functools.partial(tsweep.attention_crossover,
                                          **TINY["attention_crossover"]))
    ledger = tsweep.sweep({"grouped_gemm", "attention_crossover"}, "cpu", out)
    assert json.loads(out.read_text()) == ledger
    assert ledger["chip_kind"] == "cpu"
    assert ledger["grouped_gemm"] == {"error": "RuntimeError: no"}
    assert tsweep.erred(ledger) == ["grouped_gemm"]
    with pytest.raises(SystemExit):
        tsweep.main(["--only", "sft_train_step_moe_max", "--device", "cpu"])
    assert "sft_train_step_moe_max" in capsys.readouterr().err
    assert tsweep.DEFAULT_OUT.startswith("build/") and tbench.DEFAULT_OUT.startswith("build/")
