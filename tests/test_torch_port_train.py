"""Training slice of the port against the JAX package, on the CPU.

Weights come from the JAX ``init_params`` and are bridged to torch, data
and token rows from numpy seeds; the random noise of the diffusion loss is
drawn by JAX from its keys (``split(key)`` → ``t``, ``u``, one key per
micro-batch as ``make_train_step`` splits it) and handed to the port, which
takes explicit draws.  Everything is f32.  Tolerances, stated per check:

- ``LOSS_TOL``: one f32 forward of a 2-layer model and a sum over ≤ 64
  tokens, in different summation orders: 1e-5 relative.
- ``GRAD_TOL``: f32 gradients through the same two layers: 1e-4 relative
  and 1e-6 absolute (leaves near zero carry cancellation error).
- ``PARAM_TOL``: after AdamW a parameter moves by about lr per step
  whatever its gradient, since the update is m / (sqrt(v) + eps).  Where
  |g| >> eps (1e-8) a relative gradient error e moves the update by about
  e·lr, below 1e-6 at lr 1e-3.  Where |g| is within a few eps of zero the
  update is g / (|g| + eps), whose slope 1/eps turns f32 round-off of a
  near-cancelling gradient sum into a visible move: those rare elements
  (``OUTLIER_SHARE``, at most 0.1 %) may differ by up to lr / 100 over the
  multi-step runs.
- The one-step flash check compares the step's gradients themselves
  (``GRAD_TOL``) and then holds each parameter past ``PARAM_TOL`` to what
  the derivation allows: the first AdamW update is lr·g / (|g| + eps) (plus
  the same decay on both sides), so two gradients δ apart move it by at most
  lr·δ·eps / (|g| + eps)².  The clipped gradient elements near zero agree
  to about 1e-9 and are checked to δ = ``NEAR_ZERO_DG`` = 1e-8, which moves a parameter
  past PARAM_TOL's 1e-6 only where |g| + eps < sqrt(lr·δ·eps / 1e-6), that
  is |g| < 30.6 eps at lr 1e-3; there AdamW can move it by at most 2·lr
  (the update's sign flips).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ct_diffusionmodelbench_tpu.io.checkpoint import load_checkpoint as j_load
from ct_diffusionmodelbench_tpu.io.safetensors_io import load_safetensors as j_load_st
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_make_fwd
from ct_diffusionmodelbench_tpu.models.transformer import lm_head_logits as j_head
from ct_diffusionmodelbench_tpu.train import collator as jcol
from ct_diffusionmodelbench_tpu.train import diffusion_loss as jdl
from ct_diffusionmodelbench_tpu.train import trainer as jtr
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.io.safetensors_io import (
    load_safetensors, save_safetensors)
from ct_diffusionmodelbench_tpu_torch.models import get_config, transformer
from ct_diffusionmodelbench_tpu_torch.models.transformer import lm_head_logits
from ct_diffusionmodelbench_tpu_torch.train import collator as tcol
from ct_diffusionmodelbench_tpu_torch.train import diffusion_loss as tdl
from ct_diffusionmodelbench_tpu_torch.train import optim as topt
from ct_diffusionmodelbench_tpu_torch.train import trainer as ttr
from tests.torch_port_threads import one_torch_thread  # noqa: F401

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-6, atol=1e-6)
OUTLIER_ATOL, OUTLIER_SHARE = 1e-5, 1e-3
NEAR_ZERO_DG = 1e-8
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _bridge(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _flat_np(params):
    """A copy: the port updates parameters in place."""
    return {k: v.detach().float().numpy().copy()
            for k, v in topt.flatten_params(params).items()}


def _jax_flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _draws(key, b, l):
    """The noise ``forward_process`` draws from ``key``."""
    k_t, k_mask = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k_t, (b,), jnp.float32)),
            np.asarray(jax.random.uniform(k_mask, (b, l), jnp.float32)))


def _step_draws(key, a, b, l):
    """Per-micro-batch draws of one JAX train step's key, stacked."""
    ts, us = zip(*(_draws(k, b, l) for k in jax.random.split(key, a)))
    return _t(np.stack(ts)), _t(np.stack(us))


@pytest.fixture(scope="module")
def tiny():
    cfg_j = j_get_config("llada-tiny", dtype="float32")
    params_j = j_init(cfg_j, jax.random.key(0))
    return cfg_j, params_j, get_config("llada-tiny", dtype="float32")


# ---------------------------------------------------------------------------
# collator, schedule, optimizer
# ---------------------------------------------------------------------------

def test_collator_matches_jax():
    rng = np.random.default_rng(0)
    rows = [{"input_ids": rng.integers(3, 400, rng.integers(5, 90)).tolist(),
             "prompt_lengths": int(rng.integers(1, 6))} for _ in range(24)]
    kw = dict(pad_token_id=None, eos_token_id=2, max_length=80,
              variable_length=True, varlen_prob=0.5, varlen_min=8, bucket=16,
              seed=7)
    cj, ct = jcol.DiffusionCollator(**kw), tcol.DiffusionCollator(**kw)
    for i in range(0, 24, 3):
        for train in (True, False):
            bj, bt = cj(rows[i:i + 3], train=train), ct(rows[i:i + 3], train=train)
            for k in ("input_ids", "prompt_lengths"):
                np.testing.assert_array_equal(bt[k], bj[k])


@pytest.mark.parametrize("kind", ["cosine", "constant"])
def test_schedule_matches_optax(kind):
    cfg = jtr.TrainConfig(learning_rate=5e-5, warmup_steps=50, lr_schedule=kind)
    _, j_sched = jtr.make_optimizer(cfg, total_steps=60)
    _, t_sched = ttr.make_optimizer(ttr.TrainConfig(
        learning_rate=5e-5, warmup_steps=50, lr_schedule=kind), total_steps=60)
    got = np.array([t_sched(c) for c in range(61)])
    want = np.array([float(j_sched(c)) for c in range(61)])
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_and_clip_match_optax(dtype):
    """Three clip + AdamW steps on a decayed and a non-decayed leaf, one of
    them clipped; bf16 params round once per step (p + u), so they may
    differ by one bf16 ulp where the f32 update sits on a rounding edge."""
    rng = np.random.default_rng(1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = {"embed": rng.standard_normal((6, 4)),
              "blocks": {"attn_norm": rng.standard_normal((2, 4)),
                         "wq": rng.standard_normal((2, 4, 4))}}
    params_j = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    params_t = _bridge(params_j)
    cfg = jtr.TrainConfig(learning_rate=1e-2, warmup_steps=1, weight_decay=0.1,
                          max_grad_norm=3.0)
    opt_j, _ = jtr.make_optimizer(cfg, total_steps=10)
    state_j = opt_j.init(params_j)
    opt_t, _ = ttr.make_optimizer(ttr.TrainConfig(
        learning_rate=1e-2, warmup_steps=1, weight_decay=0.1, max_grad_norm=3.0), 10)
    state_t = opt_t.init(params_t)
    for scale in (0.5, 2.0, 0.3):   # global norms ≈ 2.7, 11, 1.6: one clipped
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32)
                             * scale, params)
        upd, state_j = opt_j.update(jax.tree.map(jnp.asarray, grads), state_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        g_t = {k: _t(v) for k, v in topt.flatten_params(
            jax.tree.map(np.asarray, grads)).items()}
        state_t = opt_t.update(g_t, state_t, topt.flatten_params(params_t),
                               topt.global_norm(g_t.values()))
        want = _jax_flat(params_j)
        for k, v in _flat_np(params_t).items():
            w = np.asarray(want[k], np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(v, w, **PARAM_TOL)
            else:
                np.testing.assert_allclose(v, w, rtol=2 ** -7, atol=0)
        mu_j = _jax_flat(state_j[1][0].mu)
        for k, m in state_t.mu.items():
            np.testing.assert_allclose(m.numpy(), np.asarray(mu_j[k], np.float32),
                                       rtol=1e-6, atol=1e-7)
    assert state_t.count == 3
    assert not topt.decays("blocks/attn_norm") and topt.decays("blocks/wq")


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_forward_process_matches_jax():
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 400, (3, 40)).astype(np.int32)
    key = jax.random.key(9)
    noisy_j, masked_j, p_j = jdl.forward_process(jnp.asarray(ids), 500, key)
    noisy_t, masked_t, p_t = tdl.forward_process(_t(ids).long(), 500,
                                                  tuple(map(_t, _draws(key, 3, 40))))
    np.testing.assert_array_equal(noisy_t.numpy(), np.asarray(noisy_j))
    np.testing.assert_array_equal(masked_t.numpy(), np.asarray(masked_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    g = torch.Generator().manual_seed(0)
    a = tdl.forward_process(_t(ids).long(), 500, g)[0]
    assert torch.equal(a, tdl.forward_process(
        _t(ids).long(), 500, torch.Generator().manual_seed(0))[0])


@pytest.mark.parametrize("variant", ["recompute", "pre_restore"])
@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("row_mask", [False, True])
def test_loss_and_grads_match_jax(tiny, variant, chunk, row_mask):
    cfg_j, params_j, cfg_t = tiny
    rng = np.random.default_rng(3)
    b, l = 3, 32
    ids = rng.integers(3, 400, (b, l)).astype(np.int32)
    ids[0, 7] = 500                             # a mask id in the data
    plens = np.array([4, 0, 9], np.int32)
    rm = np.array([1.0, 1.0, 0.0], np.float32) if row_mask else None
    key = jax.random.key(11)
    fwd_j = j_make_fwd(cfg_j)
    kw_j = dict(head_fn=j_head, ce_chunk=chunk) if chunk else {}
    f_j = (lambda p, x, m, *, return_hidden=False: fwd_j(
        p, x, m, return_hidden=return_hidden)) if chunk else fwd_j

    def loss_j(p):
        return jdl.diffusion_sft_loss(
            f_j, p, jnp.asarray(ids), jnp.asarray(plens), 500, key, aux_coef=0.0,
            mask_variant=variant, row_mask=None if rm is None else jnp.asarray(rm),
            **kw_j)

    (lj, mj), gj = jax.value_and_grad(loss_j, has_aux=True)(params_j)
    leaves = {k: v.requires_grad_(True) for k, v in
              topt.flatten_params(_bridge(params_j)).items()}

    def f_t(p, x, m=None, *, return_hidden=False):
        return transformer.forward(cfg_t, p, x, attn_mask=m,
                                   return_hidden=return_hidden)

    lt, mt = tdl.diffusion_sft_loss(
        f_t, topt.unflatten_params(leaves), _t(ids).long(), _t(plens).long(), 500,
        tuple(map(_t, _draws(key, b, l))), aux_coef=0.0, mask_variant=variant,
        row_mask=None if rm is None else _t(rm),
        **(dict(head_fn=lm_head_logits, ce_chunk=chunk) if chunk else {}))
    gt = torch.autograd.grad(lt, list(leaves.values()))
    np.testing.assert_allclose(lt.item(), float(lj), **LOSS_TOL)
    for k in ("masked_tokens", "masked_ce"):
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), **LOSS_TOL)
    want = _jax_flat(gj)
    for k, g in zip(leaves, gt):
        np.testing.assert_allclose(g.numpy(), want[k], **GRAD_TOL)


# ---------------------------------------------------------------------------
# train step and trainer
# ---------------------------------------------------------------------------

def _step_configs(**kw):
    common = dict(grad_accum=2, batch_size=2, learning_rate=1e-3, warmup_steps=1,
                  ce_chunk=16, max_grad_norm=1.0)
    common.update(kw)
    jkw = {k: v for k, v in common.items() if k != "remat"}
    return (jtr.TrainConfig(donate_state=False, remat=kw.get("remat", False) is True,
                            **jkw), ttr.TrainConfig(**common))


def _step_batch(rng, tcfg_t, i, l=32):
    """Step ``i``'s token ids [A, B, L], prompt lengths [A, B] and key."""
    a, b = tcfg_t.grad_accum, tcfg_t.batch_size
    ids = rng.integers(3, 400, (a, b, l)).astype(np.int32)
    plens = rng.integers(0, 6, (a, b)).astype(np.int32)
    return ids, plens, jax.random.key(100 + i)


def _run_steps(cfg_j, cfg_t, params_j, tcfg_j, tcfg_t, n, seed=4):
    rng = np.random.default_rng(seed)
    a, b, l = tcfg_t.grad_accum, tcfg_t.batch_size, 32
    opt_j, _ = jtr.make_optimizer(tcfg_j, 10)
    step_j, _ = jtr.make_train_step(cfg_j, tcfg_j, opt_j)
    opt_t, _ = ttr.make_optimizer(tcfg_t, 10)
    params_t = _bridge(params_j)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    step_t, _ = ttr.make_train_step(cfg_t, tcfg_t, opt_t, device="cpu")
    out = []
    for i in range(n):
        ids, plens, key = _step_batch(rng, tcfg_t, i, l)
        params_j, state_j, mj = step_j(params_j, state_j, jnp.asarray(ids),
                                       jnp.asarray(plens), key)
        params_t, state_t, mt = step_t(params_t, state_t, _t(ids).long(),
                                       _t(plens).long(), _step_draws(key, a, b, l))
        out.append((mj, mt, _jax_flat(params_j), _flat_np(params_t)))
    return out


def _check_steps(out):
    for mj, mt, pj, pt in out:
        np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(mt["grad_norm"].item(), float(mj["grad_norm"]),
                                   **LOSS_TOL)
        for k, v in pt.items():
            np.testing.assert_allclose(v, pj[k], rtol=PARAM_TOL["rtol"],
                                       atol=OUTLIER_ATOL)
            far = np.abs(v - pj[k]) > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(pj[k])
            assert far.mean() <= OUTLIER_SHARE, (k, int(far.sum()))


def test_train_step_matches_jax(tiny):
    """Three steps (the first at lr 0), A 2, B 2, L 32, chunked CE."""
    cfg_j, params_j, cfg_t = tiny
    tj, tt = _step_configs()
    out = _run_steps(cfg_j, cfg_t, params_j, tj, tt, 3)
    _check_steps(out)
    moved = max(float(np.abs(out[-1][3][k] - np.asarray(v)).max())
                for k, v in _jax_flat(params_j).items())
    assert moved > 1e-4   # the comparison is not of unchanged weights


def _step_grads(cfg_j, cfg_t, params_j, tcfg_t, ids, plens, key):
    """The step's gradient (mean over its micro-batches, as both train
    steps accumulate it) from JAX and from the port, flat and in numpy."""
    a, b, l = ids.shape
    fwd_j = j_make_fwd(cfg_j)

    def loss_j(p, i, k):
        return jdl.diffusion_sft_loss(
            lambda p_, x, m, *, return_hidden=False: fwd_j(
                p_, x, m, return_hidden=return_hidden),
            p, jnp.asarray(ids[i]), jnp.asarray(plens[i]), 500, k, aux_coef=0.0,
            head_fn=j_head, ce_chunk=tcfg_t.ce_chunk)[0]

    per_micro = [_jax_flat(jax.grad(loss_j)(params_j, i, k))
                 for i, k in enumerate(jax.random.split(key, a))]
    want = {k: sum(g[k] for g in per_micro) / a for k in per_micro[0]}

    leaves = {k: v.requires_grad_(True)
              for k, v in topt.flatten_params(_bridge(params_j)).items()}
    t_draws, u_draws = _step_draws(key, a, b, l)

    def f_t(p, x, m=None, *, return_hidden=False):
        return transformer.forward(cfg_t, p, x, attn_mask=m,
                                   return_hidden=return_hidden)

    acc = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for i in range(a):
        loss, _ = tdl.diffusion_sft_loss(
            f_t, topt.unflatten_params(leaves), _t(ids[i]).long(),
            _t(plens[i]).long(), 500, (t_draws[i], u_draws[i]), aux_coef=0.0,
            head_fn=lm_head_logits, ce_chunk=tcfg_t.ce_chunk)
        for buf, g in zip(acc.values(), torch.autograd.grad(loss, list(leaves.values()))):
            buf.add_(g)
    return {k: (v / a).numpy() for k, v in acc.items()}, want


def test_train_step_flash_matches_jax_pallas(tiny):
    """One step through the port's flash autograd wrapper (plain versions
    on the CPU) against JAX's Pallas flash forward and backward kernels in
    interpret mode: the step's gradients at ``GRAD_TOL``, then the updated
    parameters at ``PARAM_TOL`` except near-zero gradients (module
    docstring).  Such elements occur: one run on one CPU left
    ``blocks/w_up[1, 50, 118]`` (clipped gradient 1.56e-8, 1.6 eps) 1.08e-5
    apart, another element of ``blocks/wo`` at 7.6 eps 1.5e-6 apart."""
    cfg_j, params_j, cfg_t = tiny
    cfg_j, cfg_t = cfg_j.replace(attn_impl="pallas"), cfg_t.replace(attn_impl="flash")
    tj, tt = _step_configs(warmup_steps=0)   # lr at count 0 is the peak
    (mj, mt, pj, pt), = _run_steps(cfg_j, cfg_t, params_j, tj, tt, 1)
    np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(mt["grad_norm"].item(), float(mj["grad_norm"]),
                               **LOSS_TOL)
    ids, plens, key = _step_batch(np.random.default_rng(4), tt, 0)
    g_t, g_j = _step_grads(cfg_j, cfg_t, params_j, tt, ids, plens, key)
    clip = min(1.0, tt.max_grad_norm / float(mj["grad_norm"]))
    lr, eps = tt.learning_rate, tt.adam_eps
    near_zero_g = math.sqrt(lr * NEAR_ZERO_DG * eps / PARAM_TOL["atol"]) - eps
    for k, v in pt.items():
        np.testing.assert_allclose(g_t[k], g_j[k], **GRAD_TOL, err_msg=k)
        diff = np.abs(v - pj[k])
        far = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(pj[k])
        assert far.mean() <= OUTLIER_SHARE, (k, int(far.sum()))
        near_zero = np.abs(g_j[k] * clip) <= near_zero_g
        assert (near_zero | ~far).all(), (k, np.argwhere(far & ~near_zero))
        assert (np.abs(g_t[k] - g_j[k])[near_zero] * clip <= NEAR_ZERO_DG).all(), k
        assert (diff <= 2 * lr).all(), k


def test_remat_matches_no_remat(tiny):
    """Recomputing each block in the backward gives the same step, and so
    does ``remat='dots'`` (the matrix products' outputs saved, the rest
    recomputed): the same loss and gradients as no remat."""
    cfg_j, params_j, cfg_t = tiny
    tj, tt = _step_configs(remat=True)
    _check_steps(_run_steps(cfg_j, cfg_t, params_j, tj, tt, 1))
    ids = torch.randint(3, 400, (2, 16), generator=torch.Generator().manual_seed(0))
    results = []
    for remat in (False, "dots"):
        leaves = {k: v.requires_grad_(True) for k, v in
                  topt.flatten_params(_bridge(params_j)).items()}
        logits, _ = transformer.forward(cfg_t, topt.unflatten_params(leaves), ids,
                                        remat=remat)
        loss = logits.square().mean()
        results.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    (l0, g0), (l1, g1) = results
    assert l1.item() == l0.item()
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_trainer_end_to_end(tiny, tmp_path):
    """Loss falls on a small repeated set; logs, metrics, config and an
    HF-layout checkpoint are written, and the reference's loader reads the
    checkpoint back to the trained weights."""
    cfg_j, params_j, cfg_t = tiny
    rng = np.random.default_rng(5)
    rows = [{"input_ids": rng.integers(3, 60, 32).tolist(), "prompt_lengths": 2}
            for _ in range(8)]
    out_dir = tmp_path / "run"
    tcfg = ttr.TrainConfig(output_dir=str(out_dir), num_epochs=8, grad_accum=2,
                           batch_size=2, learning_rate=1e-2, warmup_steps=2,
                           lr_schedule="constant", logging_steps=1, eval_steps=8,
                           max_length=32, ce_chunk=16, seed=1)
    trainer = ttr.Trainer(cfg_t, _bridge(params_j), tcfg, rows, eval_dataset=rows[:3],
                          device="cpu")
    # Evaluation draws the same noise every time (generator seed + 10000),
    # so its loss is comparable across the run; the per-step train loss is
    # weighted by 1 / p_mask and too noisy to compare step by step.
    before = trainer.evaluate()
    final = trainer.train()
    assert final["status"] == "completed" and final["step"] == 16
    losses = [e["loss"] for e in trainer.training_logs if "grad_norm" in e]
    assert len(losses) == 16 and np.isfinite(losses).all()
    evals = [e["eval_loss"] for e in trainer.training_logs if "eval_loss" in e]
    assert evals[0] == before and len(evals) == 3
    assert evals[-1] < 0.8 * before
    logged = [json.loads(x) for x in (out_dir / "training_logs.jsonl").read_text().splitlines()]
    assert logged == trainer.training_logs
    assert json.loads((out_dir / "training_metrics.json").read_text()) == logged
    conf = json.loads((out_dir / "training_config.json").read_text())
    assert conf["train_config"]["grad_accum"] == 2 and conf["total_flos"] > 0
    _, loaded = j_load(out_dir, cfg=cfg_j)
    got = _jax_flat(loaded)
    for k, v in _flat_np(trainer.params).items():
        np.testing.assert_array_equal(got[k], v)
    assert not np.array_equal(got["embed"], np.asarray(params_j["embed"]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int32])
def test_safetensors_round_trip_and_jax_reader(tmp_path, dtype):
    t = (torch.randn(3, 5) * 100).to(dtype)
    path = tmp_path / "x.safetensors"
    save_safetensors(path, {"a": t, "s": torch.tensor(2.5)}, metadata={"format": "pt"})
    back = load_safetensors(path)
    assert back["a"].dtype == dtype and torch.equal(back["a"], t)
    assert back["s"].shape == () and back["s"].item() == 2.5
    j = j_load_st(path)["a"]
    np.testing.assert_array_equal(np.asarray(j, np.float64), t.double().numpy())


def test_trainer_refuses_what_is_not_ported(tiny, monkeypatch):
    """Pipeline with sequence parallelism raises the reference's error;
    dp / tp / sp / pp outside a torchrun launch say how to launch; MoE
    configs, bf16 / int8 moments, bf16 accumulation and saving the
    optimizer state construct."""
    _, params_j, cfg_t = tiny
    params = _bridge(params_j)
    rows = [{"input_ids": [5] * 8, "prompt_lengths": 1}] * 4
    with pytest.raises(ValueError, match="pp composes with dp and tp, not sp"):
        ttr.Trainer(cfg_t, params, ttr.TrainConfig(sp=2, pp=2), rows, device="cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for bad in (dict(dp=2, batch_size=2), dict(tp=2), dict(sp=2),
                dict(pp=2, batch_size=2)):
        with pytest.raises(RuntimeError, match="torchrun"):
            ttr.Trainer(cfg_t, params, ttr.TrainConfig(**bad), rows, device="cpu")
    moe = get_config("llada-moe-tiny", dtype="float32")
    moe_params = transformer.init_params(moe, seed=0, device="cpu")
    assert ttr.Trainer(moe, moe_params, ttr.TrainConfig(), rows, device="cpu").model_cfg.is_moe
    for ok in (dict(save_optimizer_state=True), dict(optimizer_state_dtype="int8"),
               dict(optimizer_state_dtype="bfloat16"), dict(grad_accum_dtype="bfloat16"),
               dict(remat="dots")):
        trainer = ttr.Trainer(cfg_t, params, ttr.TrainConfig(**ok), rows, device="cpu")
        assert trainer.opt_state.count == 0
