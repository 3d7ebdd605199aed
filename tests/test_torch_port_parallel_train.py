"""The port's dp×tp, dp×sp×tp and dp×pp×tp training against its
single-device run, the JAX trainer's and the JAX package's checkpoint
reader, on the CPU.

Four ``gloo`` ranks (``tests/torch_port_dist.py``) train at dp 2 × tp 2 on
weights from the JAX ``init_params``; this process runs the port's
single-device ``Trainer`` on the same weights and rows.  The noise is the
trainer's seeded ``torch.Generator``: under dp each data rank draws the
global batch's noise and takes its rows, so the trajectories are the same
run's.  The single-device port trainer is held to the JAX trainer in
``tests/test_torch_port_train.py``.  Tolerances are the reference's for its
sharded trainer (``tests/test_train.py``): losses and gradient norms rtol
5e-4, atol 5e-5; saved weights rtol 1e-4, atol 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.io.checkpoint import load_checkpoint as j_load
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu.train import trainer as jtr
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import load_checkpoint as t_load
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import save_checkpoint as t_save
from ct_diffusionmodelbench_tpu_torch.io.safetensors_io import load_safetensors
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import init_params as t_init
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import Mesh
from ct_diffusionmodelbench_tpu_torch.parallel.pipeline import pp_param_specs, stage_leaf
from ct_diffusionmodelbench_tpu_torch.parallel.sharding import local_specs, shard_leaf
from ct_diffusionmodelbench_tpu_torch.train.optim import flatten_params
from ct_diffusionmodelbench_tpu_torch.train import trainer as ttr
from tests.torch_port_dist import RankPool, train_run
from tests.torch_port_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)
SAVE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _dataset(n, rng, vocab=512):
    rows = []
    for _ in range(n):
        plen = int(rng.integers(2, 6))
        total = plen + int(rng.integers(4, 12))
        rows.append({"input_ids": rng.integers(3, vocab - 2, size=total).tolist(),
                     "prompt_lengths": plen})
    return rows


def _weights(preset, seed):
    cfg = j_get_config(preset, dtype="float32")
    return jax.tree.map(np.asarray, j_init(cfg, jax.random.key(seed)))


def _both(pool, tmp_path, preset, init_seed, rows, **kw):
    """(single-device result, the four ranks' results) of the same run,
    the ranks' beside this process's."""
    params = _weights(preset, init_seed)
    return pool.run_beside(
        lambda: train_run(preset, params, rows, 1, 1, str(tmp_path / "one"), **kw),
        "train_run", preset, params, rows, 2, 2, str(tmp_path / "dp2tp2"), **kw)


BASE = dict(num_epochs=2, batch_size=2, grad_accum=2, learning_rate=1e-3,
            warmup_steps=2, logging_steps=1, eval_steps=4, max_length=32,
            bucket=32, seed=0)


def test_trainer_sharded_matches_single_device(pool, tmp_path):
    """dp 2 × tp 2: the per-step loss and gradient norm (clipped at 1: the
    norms run far above it), the eval losses and the saved weights match
    the single-device run; both packages read the sharded save."""
    rows = _dataset(16, np.random.default_rng(1))
    (logs, evals, _), many = _both(pool, tmp_path, "llada-tiny", 0, rows,
                                   eval_rows=rows[:4], **BASE)
    assert len(logs) == 8 and len(evals) == 2 and max(g for _, g in logs) > 1.0
    for m_logs, m_evals, status in many:
        assert status == "completed"
        np.testing.assert_allclose(m_logs, logs, **TRAJ_TOL)
        np.testing.assert_allclose(m_evals, evals, **TRAJ_TOL)
    cfg = j_get_config("llada-tiny", dtype="float32")
    _, ref = j_load(tmp_path / "one", dtype="float32")
    _, got_j = j_load(tmp_path / "dp2tp2", cfg=cfg, dtype="float32")
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), **SAVE_TOL), ref, got_j)
    _, got_t = t_load(tmp_path / "dp2tp2", dtype="float32", device="cpu")
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), b.numpy(), **SAVE_TOL), ref, got_t,
        is_leaf=lambda x: not isinstance(x, dict))


@pytest.mark.parametrize("remat", [False, "dots"])
def test_trainer_sharded_moe_runs(pool, tmp_path, remat):
    """Expert-parallel MoE training (4 of 8 experts a rank, the shared
    expert split, the aux loss over the whole batch) follows the
    single-device trajectory; with ``remat='dots'`` the recomputed blocks
    run their collectives again in the backward."""
    rows = _dataset(8, np.random.default_rng(2))
    kw = dict(BASE, num_epochs=1, warmup_steps=1, eval_steps=0, remat=remat)
    (logs, _, _), many = _both(pool, tmp_path, "llada-moe-tiny", 3, rows, **kw)
    assert len(logs) == 2 and all(np.isfinite(logs).ravel())
    for m_logs, _, status in many:
        assert status == "completed"
        np.testing.assert_allclose(m_logs, logs, **TRAJ_TOL)


def test_trainer_sharded_eval_tail_batch(pool, tmp_path):
    """A tail eval batch (5 rows at batch 2) evaluates under dp 2 and
    gives the single-device eval loss."""
    rows = _dataset(8, np.random.default_rng(3))
    kw = dict(BASE, num_epochs=1, warmup_steps=1, eval_steps=2)
    (_, evals, _), many = _both(pool, tmp_path, "llada-tiny", 4, rows,
                                eval_rows=rows[:5], **kw)
    assert evals and all(np.isfinite(evals))
    for _, m_evals, _ in many:
        np.testing.assert_allclose(m_evals, evals, **TRAJ_TOL)


def test_trainer_sharded_chunked_ce_with_remat(pool, tmp_path):
    """The chunked cross-entropy (L 128 in chunks of 64) through the
    vocab-sharded head, with every block recomputed in the backward: the
    recomputations run the head's gather and the blocks' all-reduces again
    and give the single-device trajectory."""
    rows = _dataset(8, np.random.default_rng(7))
    kw = dict(BASE, num_epochs=1, warmup_steps=1, eval_steps=0, max_length=128,
              bucket=128, ce_chunk=64, remat=True)
    (logs, _, _), many = _both(pool, tmp_path, "llada-moe-tiny", 8, rows, **kw)
    assert len(logs) == 2
    for m_logs, _, _ in many:
        np.testing.assert_allclose(m_logs, logs, **TRAJ_TOL)


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_trainer_sharded_optimizer_state_save_and_resume(pool, tmp_path, moments):
    """Saved under dp×tp, the optimizer state has the single-device file's
    keys and layouts; f32 and bf16 moments (elementwise) hold its values to
    the save tolerance (bf16 to one ulp), and a resume under dp×tp from the single-device
    save continues as the single-device resume.  int8 moments quantize in
    blocks, and a shard's blocks are not the full leaf's: the update's
    ``v_err`` term then differs, so the runs part (by design, the moments
    are kept per shard) and are held to 2e-2 only."""
    rows = _dataset(8, np.random.default_rng(5))
    # A constant rate after one warm-up step: the resumed steps update at
    # the full rate from the loaded moments.
    kw = dict(BASE, num_epochs=1, warmup_steps=1, eval_steps=0, lr_schedule="constant",
              save_optimizer_state=True, optimizer_state_dtype=moments)
    _both(pool, tmp_path, "llada-tiny", 6, rows, **kw)
    one = load_safetensors(tmp_path / "one" / "optimizer.safetensors")
    many = load_safetensors(tmp_path / "dp2tp2" / "optimizer.safetensors")
    assert one.keys() == many.keys()
    for k, v in one.items():
        assert many[k].shape == v.shape and many[k].dtype == v.dtype, k
        if moments != "int8":   # bf16: one ulp where an f32 sum rounded apart
            np.testing.assert_allclose(many[k].float().numpy(), v.float().numpy(),
                                       **(SAVE_TOL if moments == "float32"
                                          else dict(rtol=2 ** -7, atol=1e-5)))
    params = _weights("llada-tiny", 6)
    resumed, many = pool.run_beside(
        lambda: train_run("llada-tiny", params, rows, 1, 1, str(tmp_path / "r1"),
                          resume_from=str(tmp_path / "one"), **kw)[0],
        "train_run", "llada-tiny", params, rows, 2, 2, str(tmp_path / "r4"),
        resume_from=str(tmp_path / "one"), **kw)
    tol = TRAJ_TOL if moments != "int8" else dict(rtol=2e-2, atol=2e-2)
    for m_logs, _, _ in many:
        np.testing.assert_allclose(m_logs, resumed, **tol)


@pytest.mark.parametrize("source", ["preset", "model_dir"])
def test_train_cli_loads_each_rank_its_shard(pool, tmp_path, source):
    """Under ``--dp 2 --tp 2``, ``cli/train.py``'s ``load_model`` hands each
    rank its shard of the one-process model, bit for bit: a preset's seeded
    draws sliced, or a checkpoint read on the host and sliced, so no rank
    places the whole model on its device."""
    cfg = t_get_config("llada-tiny")
    full = t_init(cfg, seed=3, device="cpu")
    argv = ["--device", "cpu", "--dp", "2", "--tp", "2", "--seed", "3"]
    if source == "preset":
        argv += ["--preset", "llada-tiny"]
    else:
        t_save(tmp_path / "ckpt", cfg, full)
        argv += ["--model-dir", str(tmp_path / "ckpt")]
    dims = flatten_params(local_specs(cfg, 2))
    flat = flatten_params(full)
    for model_rank, shard in pool.run("train_cli_shard", argv):
        mesh = Mesh(1, 2, model_rank, None, None, "gloo", flat["embed"].device)
        assert shard.keys() == flat.keys()
        for k, t in flat.items():
            want = shard_leaf(t, dims[k], mesh).float().numpy()
            np.testing.assert_array_equal(shard[k], want, err_msg=k)
        assert shard["blocks/wq"].shape[2] == flat["blocks/wq"].shape[2] // 2


@pytest.mark.parametrize("dims,saved", [(dict(dp=2, tp=2, batch_size=2), False),
                                        (dict(dp=1, tp=2, pp=2, batch_size=2), True)])
def test_save_gathers_onto_rank_zero_only(pool, dims, saved):
    """A save gathers the full model onto rank 0 alone (the other ranks take
    part in each leaf's gathers and drop it), and the optimizer state only
    when it is saved: four ranks sharing one card ran out of its memory
    under pp 4 when every rank of the model and stage groups kept the full
    model and state."""
    dims = dict(dims)
    held = pool.run("gathered_where", "llada-tiny", _weights("llada-tiny", 0),
                    dims.pop("dp"), dims.pop("tp"), save_optimizer_state=saved, **dims)
    assert held == [(True, saved)] + [(False, False)] * 3


def test_trainer_refusals(monkeypatch):
    """pp with sp raises the reference's error; sp / pp / dp / tp without a
    process group say how to launch; a pipeline whose layers or batch do
    not divide, and a batch that does not divide by dp, raise."""
    cfg = t_get_config("llada-tiny", dtype="float32")
    params = params_from_numpy(_weights("llada-tiny", 0), device="cpu")
    rows = [{"input_ids": [5] * 8, "prompt_lengths": 1}] * 4
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="pp composes with dp and tp, not sp"):
        ttr.Trainer(cfg, params, ttr.TrainConfig(sp=2, pp=2), rows, device="cpu")
    for bad, n in ((dict(sp=2, tp=2), 4), (dict(pp=2, batch_size=2), 2),
                   (dict(dp=2, tp=2, batch_size=2), 4)):
        with pytest.raises(RuntimeError, match=f"torchrun --nproc-per-node {n}"):
            ttr.Trainer(cfg, params, ttr.TrainConfig(**bad), rows, device="cpu")
    with pytest.raises(ValueError, match="num_layers=2 must divide by stages=4"):
        ttr.Trainer(cfg, params, ttr.TrainConfig(pp=4, batch_size=4), rows, device="cpu")
    with pytest.raises(ValueError, match="must divide by pp_microbatches=2"):
        ttr.Trainer(cfg, params, ttr.TrainConfig(pp=2, batch_size=3), rows, device="cpu")
    with pytest.raises(ValueError, match="per-microbatch rows 1 must divide by dp=2"):
        ttr.Trainer(cfg, params, ttr.TrainConfig(pp=2, dp=2, batch_size=2), rows,
                    device="cpu")
    with pytest.raises(ValueError, match="must divide by dp=2"):
        ttr.Trainer(cfg, params, ttr.TrainConfig(dp=2, batch_size=3), rows,
                    device="cpu")


# ---------------------------------------------------------------------------
# Sequence and pipeline parallelism: the steps against the JAX trainer's
# one-device trajectory (its noise drawn from its keys and handed to the
# port), then the Trainer end to end against the port's one-device run.
# ---------------------------------------------------------------------------

def _jax_draws(key, a, b, l):
    """Per-micro-batch draws of one JAX train step's key, stacked."""
    ts, us = [], []
    for k in jax.random.split(key, a):
        k_t, k_mask = jax.random.split(k)
        ts.append(np.asarray(jax.random.uniform(k_t, (b,), jnp.float32)))
        us.append(np.asarray(jax.random.uniform(k_mask, (b, l), jnp.float32)))
    return np.stack(ts), np.stack(us)


STEP_CFG = dict(learning_rate=1e-3, warmup_steps=1, lr_schedule="constant", seed=0)


def _step_key(i):
    return jax.random.key(100 + i)


@functools.lru_cache(maxsize=None)
def _batches(a, b, l, steps=3, seed=4):
    """Each step's (ids, prompt lengths) and the noise the JAX trainer
    draws from that step's key, for the port."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        ids = rng.integers(3, 400, (a, b, l)).astype(np.int32)
        plens = rng.integers(0, 6, (a, b)).astype(np.int32)
        out.append((ids, plens) + _jax_draws(_step_key(i), a, b, l))
    return out


@functools.lru_cache(maxsize=None)
def _jax_trajectory(preset, init_seed, a, b, l, ce_chunk):
    """The JAX trainer's one-device (loss, grad norm) per step of
    :func:`_batches` (kept for the cases that share it)."""
    cfg = j_get_config(preset, dtype="float32")
    params = j_init(cfg, jax.random.key(init_seed))
    tcfg = jtr.TrainConfig(grad_accum=a, batch_size=b, max_length=l, donate_state=False,
                           ce_chunk=ce_chunk, **STEP_CFG)
    opt, _ = jtr.make_optimizer(tcfg, 10)
    step, _ = jtr.make_train_step(cfg, tcfg, opt)
    state = opt.init(params)
    out = []
    for i, (ids, plens, _, _) in enumerate(_batches(a, b, l)):
        params, state, m = step(params, state, jnp.asarray(ids), jnp.asarray(plens),
                                _step_key(i))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return tuple(out)


def _steps_beside_jax(pool, preset, init_seed, a, b, l, ce_chunk=512, **dims):
    """(the JAX trajectory, each rank's port trajectory) on the same
    batches and noise: the ranks run while this process runs JAX."""
    return pool.run_beside(
        lambda: _jax_trajectory(preset, init_seed, a, b, l, ce_chunk),
        "train_steps", preset, _weights(preset, init_seed), _batches(a, b, l),
        grad_accum=a, batch_size=b, max_length=l, ce_chunk=ce_chunk, **STEP_CFG, **dims)


@pytest.mark.parametrize("preset,dp,sp,tp,l", [
    ("llada-tiny", 1, 2, 2, 32),
    ("llada-moe-tiny", 2, 2, 1, 32),
    ("llada-tiny", 1, 4, 1, 30),      # 30 does not divide by 4: whole rows
])
def test_sequence_parallel_steps_match_jax(pool, preset, dp, sp, tp, l):
    """dp × sp × tp steps (ring attention, the loss summed over seq, the
    MoE statistics summed over seq and data) follow the JAX trainer's
    one-device trajectory (JAX ``test_train.py``'s SP case)."""
    want, many = _steps_beside_jax(pool, preset, 3, 2, 2, l, dp=dp, sp=sp, tp=tp)
    for got in many:
        np.testing.assert_allclose(got, want, **TRAJ_TOL)


@pytest.mark.parametrize("dp,sp,tp,l,ce_chunk", [
    (1, 2, 2, 32, 512),     # 16 a slice: the logits path
    (2, 2, 1, 128, 64),     # 64 a slice: the chunked cross-entropy
])
def test_sequence_parallel_shifted_logits_steps_match_jax(pool, dp, sp, tp, l, ce_chunk):
    """Dream's shifted logits under a split sequence: every seq rank takes
    part in the one-row shift's backward (seq rank 0 keeps its own first
    row), and the steps follow the JAX trainer's one-device trajectory,
    rtol 5e-4 / atol 5e-5."""
    want, many = _steps_beside_jax(pool, "dream-tiny", 3, 2, 2, l, dp=dp, sp=sp, tp=tp,
                                   ce_chunk=ce_chunk)
    for got in many:
        np.testing.assert_allclose(got, want, **TRAJ_TOL)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
def test_pipeline_parallel_steps_match_jax(pool, dp, tp):
    """pp 2 GPipe steps (2 microbatches of 4 rows; dp × pp and pp × tp)
    follow the JAX trainer's one-device trajectory (JAX ``test_train.py``'s
    PP case)."""
    want, many = _steps_beside_jax(pool, "llada-tiny", 0, 1, 4, 32, dp=dp, pp=2, tp=tp,
                                   pp_microbatches=2)
    for got in many:
        np.testing.assert_allclose(got, want, **TRAJ_TOL)


def _dims_run(pool, tmp_path, preset, init_seed, rows, name, dims, **kw):
    """(single-device result, the four ranks' results under ``dims``)."""
    params = _weights(preset, init_seed)
    dp, tp = dims.pop("dp", 1), dims.pop("tp", 1)
    return pool.run_beside(
        lambda: train_run(preset, params, rows, 1, 1, str(tmp_path / "one"), **kw),
        "train_run", preset, params, rows, dp, tp, str(tmp_path / name), **dims, **kw)


def test_trainer_sequence_parallel_matches_single_device(pool, tmp_path):
    """sp 2 × tp 2 through ``Trainer.train()`` (the generator's noise drawn
    for the whole batch, then sliced), with evaluation and a save that both
    packages read, against the one-device trainer."""
    rows = _dataset(16, np.random.default_rng(11))
    (logs, evals, _), many = _dims_run(pool, tmp_path, "llada-moe-tiny", 2, rows, "sp",
                                       dict(sp=2, tp=2), eval_rows=rows[:4], **BASE)
    assert len(logs) == 8 and len(evals) == 2
    for m_logs, m_evals, status in many:
        assert status == "completed"
        np.testing.assert_allclose(m_logs, logs, **TRAJ_TOL)
        np.testing.assert_allclose(m_evals, evals, **TRAJ_TOL)
    _, ref = j_load(tmp_path / "one", dtype="float32")
    _, got = j_load(tmp_path / "sp", dtype="float32")
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), **SAVE_TOL), ref, got)


def test_trainer_pipeline_parallel_save_and_resume(pool, tmp_path):
    """pp 2 × tp 2 through ``Trainer.train()``: the trajectory, the saved
    weights and optimizer state (gathered over stage and model) equal the
    one-device run's, and a resume from the one-device save continues as
    the one-device resume."""
    rows = _dataset(8, np.random.default_rng(12))
    kw = dict(BASE, num_epochs=1, warmup_steps=1, eval_steps=0, lr_schedule="constant",
              save_optimizer_state=True)
    (logs, _, _), many = _dims_run(pool, tmp_path, "llada-tiny", 5, rows, "pp",
                                   dict(pp=2, tp=2), **kw)
    for m_logs, _, status in many:
        assert status == "completed"
        np.testing.assert_allclose(m_logs, logs, **TRAJ_TOL)
    one = load_safetensors(tmp_path / "one" / "optimizer.safetensors")
    got = load_safetensors(tmp_path / "pp" / "optimizer.safetensors")
    assert one.keys() == got.keys()
    for k, v in one.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **SAVE_TOL)
    params = _weights("llada-tiny", 5)
    resumed, many = pool.run_beside(
        lambda: train_run("llada-tiny", params, rows, 1, 1, str(tmp_path / "r1"),
                          resume_from=str(tmp_path / "one"), **kw)[0],
        "train_run", "llada-tiny", params, rows, 1, 2, str(tmp_path / "r4"), pp=2,
        resume_from=str(tmp_path / "one"), **kw)
    for m_logs, _, _ in many:
        np.testing.assert_allclose(m_logs, resumed, **TRAJ_TOL)


def test_train_cli_loads_each_rank_its_stage(pool):
    """Under ``--pp 2 --tp 2``, ``cli/train.py``'s ``load_model`` hands each
    rank its stage's layers, column / row split, of the one-process draws;
    the embedding, final norm and head whole."""
    cfg = t_get_config("llada-tiny")
    full = flatten_params(t_init(cfg, seed=3, device="cpu"))
    specs = pp_param_specs(cfg, 2)
    argv = ["--device", "cpu", "--pp", "2", "--tp", "2", "--seed", "3",
            "--preset", "llada-tiny"]
    for (st, m), shard in pool.run("train_cli_stage_shard", argv):
        mesh = Mesh(1, 2, m, None, None, "gloo", torch.device("cpu"), stage=2)
        mesh = dataclasses.replace(mesh, rank=st * 2 + m)
        assert shard.keys() == full.keys()
        for k, t in full.items():
            spec = specs["blocks"][k.split("/")[1]] if k.startswith("blocks/") else specs[k]
            np.testing.assert_array_equal(shard[k], stage_leaf(t, spec, mesh).float().numpy(),
                                          err_msg=k)
        assert shard["blocks/wq"].shape[0] == 1
