"""The port's dp×tp training step against its single-device run and the
JAX package's checkpoint reader, on the CPU.

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

import jax
import numpy as np
import pytest

from ct_diffusionmodelbench_tpu.io.checkpoint import load_checkpoint as j_load
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import load_checkpoint as t_load
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import save_checkpoint as t_save
from ct_diffusionmodelbench_tpu_torch.io.safetensors_io import load_safetensors
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import init_params as t_init
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import Mesh
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
    """(single-device result, the four ranks' results) of the same run."""
    params = _weights(preset, init_seed)
    one = train_run(preset, params, rows, 1, 1, str(tmp_path / "one"), **kw)
    many = pool.run("train_run", preset, params, rows, 2, 2, str(tmp_path / "dp2tp2"),
                    **kw)
    return one, many


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
    resumed = train_run("llada-tiny", params, rows, 1, 1, str(tmp_path / "r1"),
                        resume_from=str(tmp_path / "one"), **kw)[0]
    tol = TRAJ_TOL if moments != "int8" else dict(rtol=2e-2, atol=2e-2)
    for m_logs, _, _ in pool.run("train_run", "llada-tiny", params, rows, 2, 2,
                                 str(tmp_path / "r4"), resume_from=str(tmp_path / "one"),
                                 **kw):
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


def test_trainer_refusals(monkeypatch):
    """sp / pp still raise (Queue 1 #7, part two); dp / tp without a process
    group say how to launch; a batch that does not divide by dp raises."""
    cfg = t_get_config("llada-tiny", dtype="float32")
    params = params_from_numpy(_weights("llada-tiny", 0), device="cpu")
    rows = [{"input_ids": [5] * 8, "prompt_lengths": 1}] * 4
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for bad in (dict(sp=2), dict(pp=2)):
        with pytest.raises(NotImplementedError, match="Queue 1 #7"):
            ttr.Trainer(cfg, params, ttr.TrainConfig(**bad), rows, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        ttr.Trainer(cfg, params, ttr.TrainConfig(dp=2, tp=2, batch_size=2), rows,
                    device="cpu")
    with pytest.raises(ValueError, match="must divide by dp=2"):
        ttr.Trainer(cfg, params, ttr.TrainConfig(dp=2, batch_size=3), rows,
                    device="cpu")
