"""The port's entry module (``entry.py``) and model probes
(``probe_models.py``) against ``__graft_entry__.py`` and
``examples/probe_models.py`` on the CPU.

The entry forward runs on the JAX ``entry()`` weights through the bridge,
both in bf16: within 2^-5 of the largest |logit|.  The dp × tp dry-run
step runs on four ``gloo`` ranks on the JAX init with the JAX trainer's
noise and gives the JAX dry run's loss and gradient norm within the
reference's sharded-trainer tolerance (rtol 5e-4, atol 5e-5,
``tests/test_torch_port_parallel_train.py``).  The greedy probes give the
JAX probes' text and ids.
"""

import importlib.util
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import __graft_entry__ as jentry
from ct_diffusionmodelbench_tpu.eval.runner import ModelRunner as JRunner
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu.parallel import make_mesh, make_sharded_forward, shard_params
from ct_diffusionmodelbench_tpu.train import TrainConfig as JTrainConfig
from ct_diffusionmodelbench_tpu.train.trainer import make_optimizer as j_make_optimizer
from ct_diffusionmodelbench_tpu.train.trainer import make_train_step as j_make_train_step
from ct_diffusionmodelbench_tpu_torch import entry as tentry
from ct_diffusionmodelbench_tpu_torch import probe_models as tprobe
from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner as TRunner
from ct_diffusionmodelbench_tpu_torch.io import tokenizer as t_tok
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread_ranks(monkeypatch):
    """Spawned ranks start with one torch thread each, as the test process."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)
LOGITS_RTOL_OF_MAX = 2 ** -5


def test_entry_forward_matches_jax():
    jfn, (jparams, jids) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jids), np.float32)
    fn, (params, ids) = tentry.entry(device="cpu")
    assert tuple(ids.shape) == tuple(jids.shape) == (1, tentry.ENTRY_SEQ)
    assert params["embed"].dtype == torch.bfloat16   # llada-tiny's bf16, as JAX's
    bridged = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    got = fn(bridged, ids).float().numpy()
    assert got.shape == want.shape == (1, 320, 512)
    err = np.abs(got - want).max()
    assert err <= LOGITS_RTOL_OF_MAX * np.abs(want).max(), err
    assert torch.isfinite(fn(params, ids)).all()


def _jax_draws(key, a, b, l):
    """Per-micro-batch noise of one JAX train step's key (the JAX
    trainer's draws), stacked."""
    ts, us = [], []
    for k in jax.random.split(key, a):
        k_t, k_mask = jax.random.split(k)
        ts.append(np.asarray(jax.random.uniform(k_t, (b,), jnp.float32)))
        us.append(np.asarray(jax.random.uniform(k_mask, (b, l), jnp.float32)))
    return np.stack(ts), np.stack(us)


def _jax_dryrun_step(dp, tp, init):
    """The JAX dry run's dp × tp step (``__graft_entry__.py:136-163``) on a
    dp × tp mesh from ``init``: (loss, grad norm)."""
    mesh = make_mesh(data=dp, model=tp)
    cfg = j_get_config("llada-moe-tiny", dtype="float32").replace(pad_token_id=0)
    params = shard_params(cfg, init, mesh)
    fwd = make_sharded_forward(cfg, mesh, remat=True)
    tc = JTrainConfig(batch_size=dp * 2, grad_accum=2, max_length=32, learning_rate=1e-4,
                      warmup_steps=1)
    optimizer, _ = j_make_optimizer(tc, total_steps=10)
    step, _ = j_make_train_step(cfg, tc, optimizer, forward_fn=fwd)
    a, b, l = tc.grad_accum, tc.batch_size, 16
    rng = np.random.default_rng(0)
    ids = jax.device_put(rng.integers(3, cfg.vocab_size - 2, size=(a, b, l)).astype(np.int32),
                         NamedSharding(mesh, P(None, "data", None)))
    plens = jax.device_put(np.full((a, b), 4, np.int32), NamedSharding(mesh, P(None, "data")))
    _, _, metrics = step(params, optimizer.init(params), ids, plens, jax.random.key(1))
    return float(metrics["loss"]), float(metrics["grad_norm"])


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")
def test_dryrun_dp_tp_step_matches_jax(capsys):
    """The four port ranks run while this process runs the JAX step."""
    cfg = j_get_config("llada-moe-tiny", dtype="float32").replace(pad_token_id=0)
    init = j_init(cfg, jax.random.key(0))
    noise = _jax_draws(jax.random.key(1), 2, 4, 16)
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(tentry.dryrun_multichip, 4, device="cpu",
                           params=jax.tree.map(np.asarray, init), noise=noise)
        loss, grad_norm = _jax_dryrun_step(2, 2, init)
        res = port.result(timeout=300)
    assert res["mesh"] == (2, 2)
    np.testing.assert_allclose([res["loss"], res["grad_norm"]], [loss, grad_norm], **TRAJ_TOL)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"dryrun_multichip ok: mesh=(2x2), loss={res['loss']:.4f}, "
                     f"grad_norm={res['grad_norm']:.4f}"]


def test_dryrun_eight_ranks_prints_its_four_lines(capsys):
    res = tentry.dryrun_multichip(8, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    prefixes = ["dryrun_multichip ok: mesh=(2x4), loss=", "dryrun sp ok: mesh=(2x2x2), loss=",
                "dryrun pp ok: mesh=(2x4 stages), max_abs_err=",
                "dryrun pp-tp ok: mesh=(dp2 x pp2 x tp2), max_abs_err="]
    assert len(lines) == 4
    for line, prefix in zip(lines, prefixes):
        assert line.startswith(prefix), line
    assert np.isfinite([res["loss"], res["grad_norm"], res["sp_loss"]]).all()
    assert res["pp_err"] < tentry.LOGITS_ATOL_F32 and res["pptp_err"] < tentry.LOGITS_ATOL_F32


def test_dryrun_rank_failure_raises():
    """A rank that fails stops every rank and the dry run raises with its
    traceback (here: a parameter tree without the model's leaves)."""
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        tentry.dryrun_multichip(1, device="cpu", params={})


def _load_jax_probe():
    spec = importlib.util.spec_from_file_location("jax_probe_models",
                                                  REPO / "examples" / "probe_models.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_greedy_probes_match_jax(tmp_path, monkeypatch):
    """The LLaDA families' probes (greedy) on bridged weights: the same
    ``.lean`` text and the same generated ids as the JAX probe's."""
    jprobe = _load_jax_probe()
    greedy = [f for f in jprobe.FAMILIES if f[0].startswith("llada")]
    assert greedy == [f for f in tprobe.FAMILIES if f[0].startswith("llada")]
    assert jprobe.PROMPTS == tprobe.PROMPTS
    monkeypatch.setattr(jprobe, "FAMILIES", greedy)
    monkeypatch.setattr(tprobe, "FAMILIES", greedy)

    def bridged(family, preset, model_dir, device):
        jr = JRunner.random_init(preset, family=family)
        cfg = t_get_config(preset, dtype=jr.cfg.dtype)
        tok = t_tok.Tokenizer.byte_fallback(vocab_size=cfg.vocab_size,
                                            eos_token_id=cfg.eos_token_id or 2)
        return TRunner(cfg, params_from_numpy(jax.tree.map(np.asarray, jr.params),
                                              device="cpu"),
                       tok, family=family, device=device)

    ids = {"jax": [], "port": []}
    for name, cls in (("jax", JRunner), ("port", TRunner)):
        plain = cls.generate

        def recording(self, *a, _plain=plain, _ids=ids[name], **k):
            res = _plain(self, *a, **k)
            _ids.append(np.asarray(res.token_ids))
            return res

        monkeypatch.setattr(cls, "generate", recording)
    monkeypatch.setattr(tprobe, "make_runner", bridged)
    jprobe.main(["--out", str(tmp_path / "jax")])
    assert tprobe.main(["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert len(ids["port"]) == len(ids["jax"]) == 6
    for got, want in zip(ids["port"], ids["jax"]):
        np.testing.assert_array_equal(got, want)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "lladou_ar_probe.lean" in names
    for name in names:
        if name.startswith("llada"):
            assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
