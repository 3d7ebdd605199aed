"""Flash-attention lse, backward and autograd wrapper: the port against the
JAX package on the CPU.

Inputs are made with numpy from a seed.  The JAX side runs its Pallas
kernels in interpret mode, as the JAX package's own tests do; the port's
CUDA kernels take their plain PyTorch versions on CPU tensors.  Everything
is f32, so the two sides differ only in summation order: ``TOL`` covers
f32 sums over at most 128 keys of terms up to ~10 (a few 1e-6 relative).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.models import layers as jl
from ct_diffusionmodelbench_tpu.ops.flash_attention_bwd import (
    flash_attention_bwd as j_bwd)
from ct_diffusionmodelbench_tpu_torch.models import layers as tl
from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab
from ct_diffusionmodelbench_tpu_torch.ops.attention import attention_reference

jfa = importlib.import_module("ct_diffusionmodelbench_tpu.ops.flash_attention")

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, s, h, kv, dh, all_masked=True):
    """q, k, v, dO and a [B, S] mask: row 1 left-padded by 5, and (with
    ``all_masked``) row 0 with every key masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    do = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, :5] = 0
    if all_masked:
        mask[0] = 0
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    return q, k, v, do, mask, pos


def _jax_flat_forward(q, k, v, mask, cos, sin):
    """JAX's padded flat operands and ``_run_forward(..., with_lse=True)``,
    as ``flash_attention`` builds them."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    tq, tk, sq_pad, sk_pad = jfa._tiles(s, jfa.DEFAULT_TQ, jfa.DEFAULT_TK)
    pad_q = ((0, 0), (0, sq_pad - s), (0, 0))
    pad_k = ((0, 0), (0, sk_pad - s), (0, 0))
    qf = jnp.pad(jnp.asarray(q).reshape(b, s, h * dh), pad_q)
    kf = jnp.pad(jnp.asarray(k).reshape(b, s, kv * dh), pad_k)
    vf = jnp.pad(jnp.asarray(v).reshape(b, s, kv * dh), pad_k)
    valid = jnp.pad(jnp.asarray(mask, jnp.float32), ((0, 0), (0, sk_pad - s)))
    bias = jnp.where(valid > 0, 0.0, jfa.NEG_INF).astype(jnp.float32)[:, None, :]
    rope = (jnp.pad(cos, pad_q), jnp.pad(sin, pad_q),
            jnp.pad(cos, pad_k), jnp.pad(sin, pad_k))
    of, lse = jfa._run_forward(h, kv, dh, tq, tk, qf, kf, vf, bias,
                               with_lse=True, rope_flat=rope)
    return dict(qf=qf, kf=kf, vf=vf, bias=bias, of=of, lse=lse, rope=rope,
                tq=tq, tk=tk, sq_pad=sq_pad)


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])   # GQA rep 1 and 4
@pytest.mark.parametrize("s", [37, 70])
def test_lse_matches_jax_run_forward(h, kv, s):
    q, k, v, _, mask, pos = _inputs(s + h, 2, s, h, kv, 16)
    cos_j, sin_j = jl.rope_angles(jnp.asarray(pos), 16, 10000.0)
    j = _jax_flat_forward(q, k, v, mask, cos_j, sin_j)
    cos_t, sin_t = tl.rope_angles(_t(pos), 16, 10000.0)
    out, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), mask=_t(mask),
                                        rope=(cos_t, sin_t), with_lse=True)
    lse_j = np.asarray(j["lse"]).reshape(2, h, j["sq_pad"])[:, :, :s]
    np.testing.assert_allclose(lse.numpy(), lse_j, **TOL)
    assert (lse[0] == -1e30).all()  # the all-masked row, exactly as JAX
    np.testing.assert_allclose(
        out.numpy(), np.asarray(j["of"])[:, :s].reshape(2, s, h, 16), **TOL)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2)])   # rep 1, 2, 4
@pytest.mark.parametrize("s", [37, 70])
def test_bwd_plain_matches_jax_kernels(h, kv, s):
    """The plain backward on the reference's own forward outputs against
    ``flash_attention_bwd`` (the dq and dkv Pallas kernels, interpret)."""
    b, dh = 2, 16
    q, k, v, do, mask, pos = _inputs(2 * s + h, b, s, h, kv, dh)
    cos_j, sin_j = jl.rope_angles(jnp.asarray(pos), dh, 10000.0)
    j = _jax_flat_forward(q, k, v, mask, cos_j, sin_j)
    # JAX's backward takes rotated q/k, as its custom_vjp passes them.
    q_rot = jfa._rope_flat(j["qf"], j["rope"][0], j["rope"][1], h)
    k_rot = jfa._rope_flat(j["kf"], j["rope"][2], j["rope"][3], kv)
    dof = jnp.pad(jnp.asarray(do).reshape(b, s, h * dh),
                  ((0, 0), (0, j["sq_pad"] - s), (0, 0)))
    dq_j, dk_j, dv_j = j_bwd(q_rot, k_rot, j["vf"], j["bias"], j["of"], dof,
                             j["lse"], h=h, kv=kv, dh=dh, scale=dh ** -0.5,
                             tq=j["tq"], tk=j["tk"])
    dq, dk, dv = fab.flash_attention_bwd(
        _t(np.asarray(q_rot)[:, :s].reshape(b, s, h, dh)),
        _t(np.asarray(k_rot)[:, :s].reshape(b, s, kv, dh)), _t(v),
        fa.mask_bias(_t(mask), b, s, torch.device("cpu")),
        _t(np.asarray(j["of"])[:, :s].reshape(b, s, h, dh)), _t(do),
        _t(np.asarray(j["lse"]).reshape(b, h, j["sq_pad"])[:, :, :s]))
    np.testing.assert_allclose(dq.numpy().reshape(b, s, h * dh),
                               np.asarray(dq_j)[:, :s], **TOL)
    np.testing.assert_allclose(dk.numpy().reshape(b, s, kv * dh),
                               np.asarray(dk_j)[:, :s], **TOL)
    np.testing.assert_allclose(dv.numpy().reshape(b, s, kv * dh),
                               np.asarray(dv_j)[:, :s], **TOL)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2)])   # rep 1, 2, 4
@pytest.mark.parametrize("s", [37, 70])
def test_function_grads_match_jax_vjp(h, kv, s):
    """Autograd through the port's FlashAttention against ``jax.vjp`` of
    the reference's ``flash_attention`` (RoPE, padding, an all-masked row)."""
    b, dh = 2, 16
    q, k, v, do, mask, pos = _inputs(3 * s + h, b, s, h, kv, dh)
    cos_j, sin_j = jl.rope_angles(jnp.asarray(pos), dh, 10000.0)
    out_j, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, mask=jnp.asarray(mask),
                                               rope=(cos_j, sin_j)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    cos_t, sin_t = tl.rope_angles(_t(pos), dh, 10000.0)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, mask=_t(mask), rope=(cos_t, sin_t))
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction)
    got = torch.autograd.grad(out, leaves, _t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
def test_function_grads_match_reference_autograd(h, kv):
    """Without an all-masked row the reference's backward is the true
    gradient: it equals autograd through ``attention_reference``, and keys
    that are masked get exactly zero gradient."""
    b, s, dh = 2, 37, 16
    q, k, v, do, mask, pos = _inputs(h, b, s, h, kv, dh, all_masked=False)
    cos, sin = tl.rope_angles(_t(pos), dh, 10000.0)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(
        fa.flash_attention(*leaves, mask=_t(mask), rope=(cos, sin)), leaves, _t(do))
    ref_out = attention_reference(tl.apply_rope(leaves[0], cos, sin),
                                  tl.apply_rope(leaves[1], cos, sin), leaves[2],
                                  mask=_t(mask))
    want = torch.autograd.grad(ref_out, leaves, _t(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    masked = _t(mask) == 0
    assert masked.any()
    assert not got[1][masked].any() and not got[2][masked].any()


def test_no_grad_call_skips_the_function():
    q, k, v, _, mask, _ = _inputs(1, 2, 21, 4, 2, 16)
    out = fa.flash_attention(_t(q), _t(k), _t(v), mask=_t(mask))
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_plain(_t(q), _t(k), _t(v),
                                                     mask=_t(mask)))
