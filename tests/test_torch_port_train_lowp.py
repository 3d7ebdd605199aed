"""The low-precision optimizer, ``remat='dots'`` and optimizer-state resume
in the port against the JAX package, on the CPU.

JAX's optimizer runs under ``jax.jit``, as its train step runs it: XLA then
multiplies by the f32 reciprocal of 127 where ``quantize_int8`` divides, and
the port does the same, so int8 states compare bit for bit.  Tolerances:

- Quantization: bit-equal.
- ``PARAM_TOL``: updates with f32 moments decoded from the same bf16 or
  int8 states, in f32 arithmetic whose order XLA may fuse differently:
  2e-6.  Where the update is emitted in bf16 it rounds once more on each
  side: one bf16 ulp of the update, ``lr · 2**-8``, per step (the
  reference's own bf16-update bound).  int8 moments requantize every step,
  and an f32 difference in the last bit moves a value across a rounding
  boundary now and then: the stored q may differ by one, and the update by
  a few percent of the step (the reference's int8 bound, ``4 · lr ·
  0.06`` over four steps).
- The trainer runs hold the loss to ``tests/test_torch_port_train.py``'s
  ``LOSS_TOL``.  Where bf16 accumulation rounds a gradient that differs in
  the last f32 bit to another bf16 value, the loss and the gradient norm
  of the later steps hold to 2**-8 relative (one bf16 ulp) and the
  parameters to the int8 bound above; bf16 moments hold
  the parameters to ``BF16_STATE_ATOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ct_diffusionmodelbench_tpu.io.checkpoint import load_checkpoint as j_load_ckpt
from ct_diffusionmodelbench_tpu.train import optim as jopt
from ct_diffusionmodelbench_tpu.train import trainer as jtr
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import load_checkpoint
from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, transformer
from ct_diffusionmodelbench_tpu_torch.train import optim as topt
from ct_diffusionmodelbench_tpu_torch.train import trainer as ttr
from tests.test_torch_port_train import (
    LOSS_TOL, _bridge, _check_steps, _flat_np, _jax_flat, _run_steps, _step_configs,
    _step_draws, _t, tiny)  # noqa: F401  (tiny: the module fixture)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

PARAM_TOL = dict(rtol=2e-6, atol=2e-6)
LR = 1e-2
BF16_UPDATE_ATOL = 4 * LR * 2 ** -8 * 1.5
INT8_ATOL = 4 * LR * 0.06
# bf16 moments: an f32 moment one ulp apart rounds to a neighbouring bf16
# value now and then, which moves that element's update by about one bf16
# ulp of itself, lr · 2**-8, in a step; over the trainer's three steps at
# lr 1e-3, with both moments: 3 · 1e-3 · 2**-7.
BF16_STATE_ATOL = 3 * 1e-3 * 2 ** -7
QUANT_SHAPES = [(8, 512), (4, 6, 384), (70, 37), (13,)]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=str)
def test_int8_quantization_bit_equal_to_jax(shape):
    """Both layouts (rowwise at block 256 and 128, flat) of
    ``quantize_int8``, ``dequantize_int8`` and ``dequantize_err``, and the
    all-zero tensor's guard scale with zero error."""
    x = jax.random.normal(jax.random.key(0), shape) * (
        1 + 10 * jax.random.uniform(jax.random.key(1), shape))
    tj = jax.jit(jopt.quantize_int8)(x)
    tt = topt.quantize_int8(torch.from_numpy(np.array(x)))
    assert tt.rowwise == jopt._is_rowwise(tj)
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(tj.q))
    np.testing.assert_array_equal(tt.scale.numpy(), np.asarray(tj.scale))
    assert tt.shape == tuple(tj.meta.shape[1:])
    np.testing.assert_array_equal(topt.dequantize_int8(tt).numpy(),
                                  np.asarray(jax.jit(jopt.dequantize_int8)(tj)))
    np.testing.assert_array_equal(topt.dequantize_err(tt).numpy(),
                                  np.asarray(jax.jit(jopt.dequantize_err)(tj)))
    z = topt.zeros_int8(shape, "cpu")
    zj = jopt.quantize_int8(jnp.zeros(shape))
    np.testing.assert_array_equal(z.q.numpy(), np.asarray(zj.q))
    np.testing.assert_array_equal(z.scale.numpy(), np.asarray(zj.scale))
    assert not topt.dequantize_err(z).any()


def _lowp_params():
    return {"w": jax.random.normal(jax.random.key(0), (70, 37)),      # flat
            "b": jax.random.normal(jax.random.key(1), (13,)),         # flat, 1-D
            "e": jax.random.normal(jax.random.key(2), (3, 5, 384)),   # block 128
            "m": jax.random.normal(jax.random.key(3), (12, 512))}     # block 256


def _run_lowp(state_dtype, update_dtype, steps=4, grads=None):
    """(JAX params, port params, JAX state, port state) after ``steps``
    updates of the same gradients (``grads(p, i)``)."""
    grads = grads or (lambda p, i: jax.tree.map(lambda x: 0.1 * x + 0.01 * i, p))
    params = _lowp_params()
    opt = jopt.adamw_lowp(LR, weight_decay=0.01, state_dtype=state_dtype,
                          update_dtype=update_dtype)
    update = jax.jit(opt.update)
    state_j, p_j = opt.init(params), params
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    opt_t = topt.AdamWLowp(lambda c: LR, weight_decay=0.01, max_grad_norm=1e9,
                           state_dtype=state_dtype, update_dtype=update_dtype)
    state_t = opt_t.init(p_t)
    worst = 0.0
    for i in range(steps):
        g = grads(p_j, i)
        upd, state_j = update(g, state_j, p_j)
        worst = max(worst, max(float(jnp.abs(u).max()) for u in jax.tree.leaves(upd)))
        p_j = optax.apply_updates(p_j, upd)
        g_t = {k: torch.from_numpy(np.array(v)) for k, v in g.items()}
        state_t = opt_t.update(g_t, state_t, p_t, topt.global_norm(g_t.values()))
    return p_j, p_t, state_j, state_t


def _moments(state_j, state_t, part):
    """[(port moment, JAX moment)] of ``part`` ('mu' or 'nu') per leaf."""
    j = getattr(state_j[0], part)
    return [(getattr(state_t, part)[k], j[k]) for k in sorted(j)]


@pytest.mark.parametrize("update_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", ["bfloat16", "int8"])
def test_adamw_lowp_trajectory_matches_jax(state_dtype, update_dtype):
    """Four steps of ``adamw_lowp`` on the four layouts' leaves."""
    p_j, p_t, state_j, state_t = _run_lowp(state_dtype, update_dtype)
    int8 = state_dtype == "int8"
    atol = INT8_ATOL if int8 else (
        BF16_UPDATE_ATOL if update_dtype == "bfloat16" else PARAM_TOL["atol"])
    for k in p_j:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=PARAM_TOL["rtol"], atol=atol, err_msg=k)
    assert state_t.count == int(state_j[0].count) == 4
    for part in ("mu", "nu"):
        for mt, mj in _moments(state_j, state_t, part):
            if int8:
                assert mt.shape == tuple(mj.meta.shape[1:])
                flips = np.abs(mt.q.numpy().astype(np.int32)
                               - np.asarray(mj.q).astype(np.int32))
                assert flips.max() <= 1 and flips.mean() < 0.02, part
            else:
                np.testing.assert_allclose(_np(mt), np.asarray(mj, np.float32),
                                           rtol=2 ** -7, atol=1e-7)


@pytest.mark.parametrize("state_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("chunk", [256, 768, 1 << 24])
def test_adamw_lowp_result_independent_of_chunk(monkeypatch, state_dtype, chunk):
    """The chunked update (one block, three blocks, whole leaves a chunk)
    gives the same parameters and state bit for bit: blocks lie along the
    flattened leaf and every op is elementwise or within a block.  Both
    int8 layouts and a padded flat tail take the chunked path."""
    _, base_p, _, base_s = _run_lowp(state_dtype, "float32")
    monkeypatch.setattr(topt, "CHUNK_ELEMS", chunk)
    _, p_t, _, s_t = _run_lowp(state_dtype, "float32")
    for k in base_p:
        assert torch.equal(p_t[k], base_p[k]), k
    a, b = topt.state_tensors(base_s), topt.state_tensors(s_t)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_int8_adam_no_explosion_on_decaying_grads(state_dtype):
    """The reference's regression test: gradients decaying by 10x a step
    quantize a block's small ν elements to 0 while their μ survives; the ν
    floor keeps every update at the Adam scale, and the port's run stays
    at JAX's."""
    def run_port():
        opt = topt.AdamWLowp(lambda c: LR, weight_decay=0.01, max_grad_norm=1e9,
                             state_dtype=state_dtype)
        p = {"w": torch.from_numpy(np.asarray(
            jax.random.normal(jax.random.key(1), (64, 256)) * 0.02))}
        state, worst = opt.init(p), 0.0
        for i in range(6):
            g = {"w": torch.from_numpy(np.asarray(jax.random.normal(
                jax.random.fold_in(jax.random.key(0), i), (64, 256)) * (10.0 ** -i)))}
            before = p["w"].clone()
            state = opt.update(g, state, p, topt.global_norm(g.values()))
            worst = max(worst, float((p["w"] - before).abs().max()))
        return p["w"].numpy(), worst

    def run_jax():
        opt = jopt.adamw_lowp(LR, weight_decay=0.01, state_dtype=state_dtype)
        p = {"w": jax.random.normal(jax.random.key(1), (64, 256)) * 0.02}
        state = opt.init(p)
        for i in range(6):
            g = {"w": jax.random.normal(jax.random.fold_in(jax.random.key(0), i),
                                        (64, 256)) * (10.0 ** -i)}
            upd, state = jax.jit(opt.update)(g, state, p)
            p = optax.apply_updates(p, upd)
        return np.asarray(p["w"])

    got, worst = run_port()
    assert worst < 1.5e-2, f"update exploded: {worst}"
    np.testing.assert_allclose(got, run_jax(), atol=INT8_ATOL)


def test_adamw_lowp_tracks_f32_on_least_squares():
    """The reference's convex check: bf16 and int8 moments track f32 Adam's
    loss trajectory within 2 %, and the port's f32-state ``adamw_lowp``
    equals its optax-arithmetic AdamW."""
    a = torch.from_numpy(np.asarray(jax.random.normal(jax.random.key(0), (16, 8))))
    b = torch.from_numpy(np.asarray(jax.random.normal(jax.random.key(1), (16,))))

    def run(opt):
        w = {"w": torch.zeros(8)}
        state, traj = opt.init(w), []
        for _ in range(60):
            g = {"w": 2.0 / 16 * a.T @ (a @ w["w"] - b)}
            state = opt.update(g, state, w, topt.global_norm(g.values()))
            traj.append(float(torch.mean((a @ w["w"] - b) ** 2)))
        return np.array(traj)

    kw = dict(weight_decay=0.01, max_grad_norm=1e9)
    ref = run(topt.AdamW(lambda c: 1e-1, **kw))
    np.testing.assert_allclose(run(topt.AdamWLowp(lambda c: 1e-1, **kw)), ref, rtol=1e-5)
    for sd in ("bfloat16", "int8"):
        low = run(topt.AdamWLowp(lambda c: 1e-1, state_dtype=sd, **kw))
        assert low[-1] < ref[0]
        np.testing.assert_allclose(low, ref, rtol=0.02)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_scale", [0.5, 30.0])   # below and above max_norm
def test_clip_by_global_norm_f32_matches_jax(dtype, norm_scale):
    rng = np.random.default_rng(4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    grads = {"a": rng.standard_normal((40, 24)), "b": rng.standard_normal((7,))}
    grads = {k: jnp.asarray(v * norm_scale / 31.0, jdt) for k, v in grads.items()}
    clip = jopt.clip_by_global_norm_f32(1.0)
    want, _ = jax.jit(clip.update)(grads, clip.init(grads))
    g_t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(getattr(torch, dtype))
           for k, v in grads.items()}
    topt.clip_by_global_norm_f32(g_t, topt.global_norm(g_t.values()), 1.0)
    for k in grads:
        assert g_t[k].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g_t[k].float().numpy(), np.asarray(want[k], np.float32),
                                   rtol=2 ** -8 if dtype == "bfloat16" else 1e-6, atol=0)


def test_trainer_int8_bf16_accum_steps_match_jax(tiny):
    """Three steps with int8 moments and bf16 accumulation (the reference's
    f32 clip on the bf16 buffer) against JAX's jitted step."""
    cfg_j, params_j, cfg_t = tiny
    tj, tt = _step_configs(optimizer_state_dtype="int8", grad_accum_dtype="bfloat16")
    out = _run_steps(cfg_j, cfg_t, params_j, tj, tt, 3)
    for mj, mt, pj, pt in out:
        np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]), rtol=2 ** -8)
        np.testing.assert_allclose(mt["grad_norm"].item(), float(mj["grad_norm"]),
                                   rtol=2 ** -8)
        for k, v in pt.items():
            np.testing.assert_allclose(v, pj[k], rtol=0, atol=INT8_ATOL / 4 * 3, err_msg=k)
    moved = max(float(np.abs(out[-1][3][k] - np.asarray(v)).max())
                for k, v in _jax_flat(params_j).items())
    assert moved > 1e-4


@pytest.mark.parametrize("state_dtype", ["bfloat16", "float32"])
def test_trainer_bf16_state_and_bf16_accum_match_jax(tiny, state_dtype):
    """bf16 moments with f32 accumulation, and f32 moments with bf16
    accumulation, three steps each against JAX."""
    cfg_j, params_j, cfg_t = tiny
    accum = "float32" if state_dtype == "bfloat16" else "bfloat16"
    tj, tt = _step_configs(optimizer_state_dtype=state_dtype, grad_accum_dtype=accum)
    out = _run_steps(cfg_j, cfg_t, params_j, tj, tt, 3)
    for mj, mt, pj, pt in out:
        rtol = 2 ** -8 if accum == "bfloat16" else LOSS_TOL["rtol"]
        np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]), rtol=rtol)
        np.testing.assert_allclose(mt["grad_norm"].item(), float(mj["grad_norm"]),
                                   rtol=rtol)
        for k, v in pt.items():
            np.testing.assert_allclose(v, pj[k], rtol=0, atol=(
                INT8_ATOL / 4 * 3 if accum == "bfloat16" else BF16_STATE_ATOL), err_msg=k)


def test_remat_dots_matches_no_remat(tiny):
    """remat=True and remat='dots' are recompute schedules: the same loss,
    gradient norm and parameters as no remat, bit for bit on the CPU, and
    JAX's no-remat step within the module's tolerances."""
    cfg_j, params_j, cfg_t = tiny
    outs = {}
    for remat in (False, True, "dots"):
        tj, tt = _step_configs(remat=remat)
        outs[remat] = _run_steps(cfg_j, cfg_t, params_j, tj, tt, 2)
    _check_steps(outs["dots"])
    for remat in (True, "dots"):
        for (_, m0, _, p0), (_, m1, _, p1) in zip(outs[False], outs[remat]):
            assert m0["loss"].item() == m1["loss"].item()
            assert m0["grad_norm"].item() == m1["grad_norm"].item()
            for k in p0:
                np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)


def _dataset(n, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        plen = int(rng.integers(2, 5))
        rows.append({"input_ids": rng.integers(3, vocab - 2, plen + int(rng.integers(4, 10))
                                               ).tolist(), "prompt_lengths": plen})
    return rows


def _tc(out, epochs, **kw):
    return dict(output_dir=str(out), num_epochs=epochs, batch_size=2, grad_accum=2,
                learning_rate=1e-3, warmup_steps=1, logging_steps=1, eval_steps=0,
                max_length=32, bucket=32, seed=0, save_optimizer_state=True,
                variable_length=False, **kw)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_resume_matches_continuous(tmp_path, state_dtype):
    """``tests/test_resume.py``'s check in the port: one epoch, save, a
    fresh Trainer loads the checkpoint and the optimizer state and trains
    the second epoch; it ends close to the uninterrupted two-epoch run (the
    epoch shuffles differ between Trainer instances)."""
    cfg = get_config("llada-tiny", dtype="float32").replace(pad_token_id=0)
    ds = _dataset(8)
    kw = dict(optimizer_state_dtype=state_dtype)

    def fresh():
        return init_params(cfg, seed=0, device="cpu")

    t_cont = ttr.Trainer(cfg, fresh(), ttr.TrainConfig(**_tc(tmp_path / "c", 2, **kw)),
                         ds, device="cpu")
    t_cont.train()
    t_a = ttr.Trainer(cfg, fresh(), ttr.TrainConfig(**_tc(tmp_path / "a", 1, **kw)), ds,
                      device="cpu")
    t_a.train()
    _, params_r = load_checkpoint(tmp_path / "a", dtype="float32", device="cpu")
    t_b = ttr.Trainer(cfg, params_r, ttr.TrainConfig(**_tc(tmp_path / "b", 1, **kw)), ds,
                      device="cpu")
    t_b.total_steps = t_cont.total_steps
    t_b.load_training_state(tmp_path / "a")
    assert t_b.global_step == t_a.global_step == 2
    assert t_b.opt_state.count == 2
    t_b.train()
    for k, v in _flat_np(t_cont.params).items():
        np.testing.assert_allclose(_flat_np(t_b.params)[k], v, rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_optimizer_state_roundtrip_exact(tmp_path, state_dtype):
    """``tests/test_resume.py::test_optimizer_state_roundtrip_exact``: every
    state tensor reads back bit for bit, the step count with it."""
    cfg = get_config("llada-tiny", dtype="float32").replace(pad_token_id=0)
    ds = _dataset(4, seed=1)
    tc = ttr.TrainConfig(**_tc(tmp_path / "x", 1, optimizer_state_dtype=state_dtype,
                               grad_accum_dtype="bfloat16"))
    t1 = ttr.Trainer(cfg, init_params(cfg, seed=1, device="cpu"), tc, ds, device="cpu")
    t1.train()
    t1.save_training_state(str(tmp_path / "x"))
    t2 = ttr.Trainer(cfg, init_params(cfg, seed=1, device="cpu"), tc, ds, device="cpu")
    t2.load_training_state(str(tmp_path / "x"))
    assert t2.global_step == t1.global_step == 1
    a, b = topt.state_tensors(t1.opt_state), topt.state_tensors(t2.opt_state)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _jax_trainer(cfg_j, params_j, out, **kw):
    tc = jtr.TrainConfig(**_tc(out, 1, donate_state=False, **kw))
    return jtr.Trainer(cfg_j, params_j, tc, _dataset(4, seed=2), pad_token_id=0)


def _port_trainer(cfg_t, params_t, out, **kw):
    tc = ttr.TrainConfig(**_tc(out, 1, **kw))
    return ttr.Trainer(cfg_t, params_t, tc, _dataset(4, seed=2), pad_token_id=0,
                       device="cpu")


def _next_step_close(t_j, t_t, seed):
    """One more step on both sides from their current states, on one batch
    and JAX's draws: the parameters stay within the int8 bound."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 400, (2, 2, 32)).astype(np.int32)
    plens = rng.integers(0, 6, (2, 2)).astype(np.int32)
    key = jax.random.key(seed)
    p_j, _, _ = t_j.train_step(t_j.params, t_j.opt_state, jnp.asarray(ids),
                               jnp.asarray(plens), key)
    p_t, _, _ = t_t.train_step(t_t.params, t_t.opt_state, _t(ids).long(),
                               _t(plens).long(), _step_draws(key, 2, 2, 32))
    want = _jax_flat(p_j)
    for k, v in _flat_np(p_t).items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=INT8_ATOL / 4, err_msg=k)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_optimizer_state_written_by_jax_loads_into_port(tiny, tmp_path, state_dtype):
    """JAX trains and saves its optimizer state; the port loads it, holds
    the same tensors bit for bit, and its next step matches JAX's."""
    cfg_j, params_j, cfg_t = tiny
    t_j = _jax_trainer(cfg_j, params_j, tmp_path / "j", optimizer_state_dtype=state_dtype)
    t_j.train()
    _, params_t = load_checkpoint(tmp_path / "j", dtype="float32", device="cpu")
    t_t = _port_trainer(cfg_t, params_t, tmp_path / "t", optimizer_state_dtype=state_dtype)
    t_t.load_training_state(tmp_path / "j")
    assert t_t.global_step == t_j.global_step and t_t.opt_state.count == t_j.global_step
    got = topt.state_tensors(t_t.opt_state)
    for path, leaf in jax.tree_util.tree_flatten_with_path(t_j.opt_state)[0]:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)].numpy(),
                                      np.asarray(leaf))
    _next_step_close(t_j, t_t, 7)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_optimizer_state_written_by_port_loads_into_jax(tiny, tmp_path, state_dtype):
    """The reverse: the port trains and saves; JAX's ``load_training_state``
    reads every tensor back to the port's values, and JAX's next step
    matches the port's."""
    cfg_j, params_j, cfg_t = tiny
    t_t = _port_trainer(cfg_t, _bridge(params_j), tmp_path / "t",
                        optimizer_state_dtype=state_dtype)
    t_t.train()
    _, params_j2 = j_load_ckpt(tmp_path / "t", cfg=cfg_j)
    t_j = _jax_trainer(cfg_j, params_j2, tmp_path / "j", optimizer_state_dtype=state_dtype)
    t_j.load_training_state(str(tmp_path / "t"))
    assert t_j.global_step == t_t.global_step
    want = topt.state_tensors(t_t.opt_state)
    flat_j = {jax.tree_util.keystr(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(t_j.opt_state)[0]}
    assert set(flat_j) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat_j[k], v.numpy(), err_msg=k)
    _next_step_close(t_j, t_t, 8)


def test_make_optimizer_picks_clip_and_moments():
    """The clip follows ``grad_accum_dtype`` and the moments
    ``optimizer_state_dtype``, as the reference's ``make_optimizer``; an
    unknown accumulation dtype raises."""
    for sd, gd in (("float32", "float32"), ("int8", "bfloat16"), ("bfloat16", "float32")):
        opt, _ = ttr.make_optimizer(ttr.TrainConfig(optimizer_state_dtype=sd,
                                                    grad_accum_dtype=gd), 10)
        assert isinstance(opt, topt.AdamWLowp) == (sd != "float32")
        want = topt.clip_by_global_norm if gd == "float32" else topt.clip_by_global_norm_f32
        assert opt.clip is want
    with pytest.raises(ValueError, match="grad_accum_dtype"):
        ttr.make_optimizer(ttr.TrainConfig(grad_accum_dtype="float16"), 10)
    with pytest.raises(ValueError, match="state dtype"):
        ttr.make_optimizer(ttr.TrainConfig(optimizer_state_dtype="float16"), 10)
    params = transformer.init_params(get_config("llada-tiny", dtype="float32"), seed=0,
                                     device="cpu")
    state = ttr.make_optimizer(ttr.TrainConfig(optimizer_state_dtype="int8"), 10)[0].init(
        params)
    head, embed = state.mu["lm_head"], state.mu["embed"]     # [64, 512], [512, 64]
    assert head.rowwise and head.q.dtype == torch.int8 and head.block == 256
    assert not embed.rowwise and embed.q.shape == (128, 256)
