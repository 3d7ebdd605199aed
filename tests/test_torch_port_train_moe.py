"""MoE training in the port against the JAX package, on the CPU.

The grouped expert FFN's autograd wrapper (``ops/grouped_gemm.py``) against
``jax.vjp`` of the reference's ragged formulation ``_ffn_ragged``, and MoE
train steps against the JAX ``make_train_step`` on bridged weights and
JAX's own noise draws (the JAX side routes the experts densely on the
CPU, ``impl="auto"``, the same function).  Everything is f32.  Tolerances:

- ``FFN_TOL``: one expert FFN in f32, products and sums in other orders:
  1e-5 relative, 1e-6 absolute.
- The train steps hold to ``tests/test_torch_port_train.py``'s tolerances
  (its module docstring derives them); the aux term adds one f32 scalar
  per layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu.ops.grouped_gemm import _ffn_ragged
from ct_diffusionmodelbench_tpu_torch.models import get_config, moe, transformer
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm as ggm
from ct_diffusionmodelbench_tpu_torch.train import optim as topt
from ct_diffusionmodelbench_tpu_torch.train import trainer as ttr
from tests.test_torch_port_train import (
    _bridge, _check_steps, _flat_np, _jax_flat, _run_steps, _step_configs)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

FFN_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_moe():
    cfg_j = j_get_config("llada-moe-tiny", dtype="float32")
    params_j = j_init(cfg_j, jax.random.key(3))
    return cfg_j, params_j, get_config("llada-moe-tiny", dtype="float32")


def _ffn_inputs(stacked: bool, seed=0, n=40, d=16, e=5, f=8, k=2):
    rng = np.random.default_rng(seed)
    lead = (3,) if stacked else ()
    x = rng.standard_normal((n, d)).astype(np.float32)
    wg, wu = (rng.standard_normal(lead + (e, d, f)).astype(np.float32) * 0.3
              for _ in range(2))
    wd = rng.standard_normal(lead + (e, f, d)).astype(np.float32) * 0.3
    logits = rng.standard_normal((n, e)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    topk = np.take_along_axis(probs, idx, -1)
    g = rng.standard_normal((n, d)).astype(np.float32)
    return x, topk, idx, wg, wu, wd, g


@pytest.mark.parametrize("stacked", [False, True], ids=["3d", "stacked"])
def test_grouped_ffn_grads_match_jax_vjp(stacked):
    """dx, dprobs, dWg, dWu, dWd of the port's differentiable grouped FFN
    against ``jax.vjp`` of ``_ffn_ragged``; with stacked [L, E, ...] weights
    and ``layer_index``, the stack's gradient is this layer's in its slice
    and zero elsewhere."""
    x, topk, idx, wg, wu, wd, g = _ffn_inputs(stacked)
    li = 1 if stacked else None
    sl = (lambda w: w[li]) if stacked else (lambda w: w)
    out_j, vjp = jax.vjp(lambda *a: _ffn_ragged(a[0], a[1], jnp.asarray(idx), *a[2:]),
                         x, topk, sl(wg), sl(wu), sl(wd))
    want = vjp(jnp.asarray(g))

    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, topk, wg, wu, wd)]
    out = ggm.grouped_expert_ffn(ins[0], ins[1], torch.from_numpy(idx), *ins[2:],
                                 layer_index=li)
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FFN_TOL)
    for name, gt, gj in zip(("dx", "dprobs", "dWg", "dWu", "dWd"), got, want):
        gt = gt.numpy()
        if stacked and name.startswith("dW"):
            others = np.delete(gt, li, axis=0)
            assert not others.any(), name
            gt = gt[li]
        np.testing.assert_allclose(gt, np.asarray(gj), **FFN_TOL, err_msg=name)


def test_grouped_ffn_backward_plain_products_by_expert():
    """``grouped_mm_plain``'s two forms against a product per group, with
    an empty group; the CPU runs them for every backward product."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((12, 6)).astype(np.float32))
    b3 = torch.from_numpy(rng.standard_normal((3, 6, 4)).astype(np.float32))
    b2 = torch.from_numpy(rng.standard_normal((12, 4)).astype(np.float32))
    offs = torch.tensor([5, 5, 12], dtype=torch.int32)
    got = ggm.grouped_mm(a, b3, offs)
    want = torch.cat([a[:5] @ b3[0], a[5:12] @ b3[2]])
    torch.testing.assert_close(got, want)
    got_w = ggm.grouped_mm(a.t(), b2, offs)
    assert got_w.shape == (3, 6, 4) and not got_w[1].any()
    torch.testing.assert_close(got_w[0], a[:5].t() @ b2[:5])
    torch.testing.assert_close(got_w[2], a[5:].t() @ b2[5:])


def test_moe_block_router_gradient_through_probs_and_aux():
    """The router's gradient flows through the top-k probabilities and the
    aux loss: each alone is nonzero, and together they add up."""
    cfg = get_config("llada-moe-tiny", dtype="float32")
    params = transformer.init_params(cfg, seed=2, device="cpu")
    lp = {k: v[0].clone() for k, v in params["blocks"].items()}
    x = torch.randn((16, cfg.hidden_size), generator=torch.Generator().manual_seed(0))
    router = lp["router"].requires_grad_(True)
    kw = dict(top_k=cfg.num_experts_per_tok, norm_topk=cfg.norm_topk_prob)
    out, aux = moe.moe_block(x, lp, **kw)
    g_out, = torch.autograd.grad(out.sum(), router, retain_graph=True)
    g_aux, = torch.autograd.grad(aux, router, retain_graph=True)
    g_both, = torch.autograd.grad(out.sum() + aux, router)
    assert g_out.abs().max() > 0 and g_aux.abs().max() > 0
    torch.testing.assert_close(g_both, g_out + g_aux)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_train_steps_match_jax(tiny_moe, remat):
    """Three MoE steps (the first at lr 0), A 2, B 2, L 32, aux loss 0.01,
    chunked CE, against JAX's step on the same weights and draws."""
    cfg_j, params_j, cfg_t = tiny_moe
    tj, tt = _step_configs(remat=remat)
    out = _run_steps(cfg_j, cfg_t, params_j, tj, tt, 3)
    _check_steps(out)
    for mj, mt, _, _ in out:
        np.testing.assert_allclose(mt["aux_loss"].item(), float(mj["aux_loss"]),
                                   rtol=1e-5)
    moved = max(float(np.abs(out[-1][3][k] - np.asarray(v)).max())
                for k, v in _jax_flat(params_j).items())
    assert moved > 1e-4


def test_moe_train_step_frees_layer_expert_grads(tiny_moe):
    """The train step hands the model one gradient leaf per layer's
    experts and adds each layer's gradient to its slice of the buffer:
    the step's accumulated gradient equals the sum of the micro-batches'
    full-stack gradients (computed here with the stacks as leaves)."""
    _, params_j, cfg_t = tiny_moe
    params = _bridge(params_j)
    flat = topt.flatten_params(params)
    acc = {k: torch.zeros_like(v) for k, v in flat.items()}
    leaves, tree = ttr._grad_leaves(flat, acc)
    assert isinstance(tree["blocks"]["we_gate"], list)
    assert len(tree["blocks"]["we_gate"]) == cfg_t.num_layers
    ids = torch.randint(3, 400, (2, 16), generator=torch.Generator().manual_seed(1))
    for _ in range(2):
        logits, aux = transformer.forward(cfg_t, tree, ids)
        (logits.square().mean() + aux).backward()
    assert all(t.grad is None for t in leaves)
    stacks = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    logits, aux = transformer.forward(cfg_t, topt.unflatten_params(stacks), ids)
    want = torch.autograd.grad(logits.square().mean() + aux, list(stacks.values()))
    for (k, got), w in zip(acc.items(), want):
        torch.testing.assert_close(got, 2 * w, rtol=1e-5, atol=1e-7, msg=k)


def test_trainer_moe_aux_loss_in_training(tmp_path):
    """The reference's ``test_trainer_moe_aux_loss_in_training``: an MoE
    Trainer runs to completion with finite losses, its aux loss in every
    step's metrics, and the router trains."""
    cfg = get_config("llada-moe-tiny", dtype="float32").replace(pad_token_id=0)
    params = transformer.init_params(cfg, seed=1, device="cpu")
    router0 = params["blocks"]["router"].clone()
    rng = np.random.default_rng(1)
    ds = [{"input_ids": rng.integers(3, cfg.vocab_size - 2,
                                     int(rng.integers(6, 14))).tolist(),
           "prompt_lengths": int(rng.integers(2, 5))} for _ in range(8)]
    tc = ttr.TrainConfig(output_dir=str(tmp_path / "moe"), num_epochs=1,
                         batch_size=2, grad_accum=2, logging_steps=1,
                         eval_steps=0, max_length=32, bucket=32, warmup_steps=1)
    trainer = ttr.Trainer(cfg, params, tc, ds, device="cpu")
    final = trainer.train()
    assert final["status"] == "completed"
    assert all(np.isfinite(e["loss"]) for e in trainer.training_logs if "loss" in e)
    assert not torch.equal(trainer.params["blocks"]["router"], router0)
    assert (tmp_path / "moe" / "model.safetensors").exists()
    _, _, mt = trainer.train_step(
        trainer.params, trainer.opt_state,
        torch.randint(3, 400, (2, 2, 32)), torch.full((2, 2), 3),
        torch.Generator().manual_seed(0))
    assert mt["aux_loss"].item() > 0
    assert _flat_np(trainer.params)["blocks/router"].shape == (2, 64, 8)
