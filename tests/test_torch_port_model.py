"""PyTorch port against the JAX package: full forward and greedy decoding.

Both frameworks run the same f32 weights (JAX ``init_params`` → numpy →
``params_from_numpy``) on the CPU.  Logits agree within rtol = atol = 2e-4
(two layers of f32 ops summed in different orders; MoE through the port's
grouped path against the JAX dense path, or against its Pallas grouped path
in interpret mode).  Greedy decoding must give equal tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init_params
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_make_forward_fn
from ct_diffusionmodelbench_tpu.sampling import llada_generate as j_generate
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import make_cached_fns
from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn as t_make_forward_fn
from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate as t_generate
from tests.torch_port_threads import one_torch_thread  # noqa: F401

LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)


def _pair(name, seed, **overrides):
    jcfg = j_get_config(name, dtype="float32", **overrides)
    tcfg = t_get_config(name, dtype="float32", **overrides)
    jparams = j_init_params(jcfg, jax.random.key(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jcfg, jparams, j_make_forward_fn(jcfg),
            tcfg, tparams, t_make_forward_fn(tcfg, device="cpu"))


def _ids(seed, b, s, vocab, mask_id, n_mask=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab - 20, (b, s)).astype(np.int32)
    ids[:, s - n_mask:] = mask_id
    mask = np.ones((b, s), np.int32)
    mask[-1, :3] = 0
    return ids, mask


@pytest.mark.parametrize("name", ["llada-moe-tiny", "llada-tiny"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_forward_logits_match_jax(name, with_mask):
    jcfg, jp, jf, tcfg, tp, tf = _pair(name, 3)
    ids, mask = _ids(4, 2, 24, jcfg.vocab_size, jcfg.mask_token_id, n_mask=8)
    jm = jnp.asarray(mask) if with_mask else None
    tm = torch.from_numpy(mask) if with_mask else None
    want, aux_j = jf(jp, jnp.asarray(ids), jm)
    got, aux_t = tf(tp, torch.from_numpy(ids), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **LOGITS_TOL)
    # block-sliced LM head, as the sampler calls it
    want_s, _ = jf(jp, jnp.asarray(ids), jm, jnp.int32(16), 8)
    got_s, _ = tf(tp, torch.from_numpy(ids), tm, logit_start=16, logit_length=8)
    assert got_s.shape == (2, 8, jcfg.vocab_size)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **LOGITS_TOL)
    hid_j, _ = jf(jp, jnp.asarray(ids), jm, return_hidden=True)
    hid_t, _ = tf(tp, torch.from_numpy(ids), tm, return_hidden=True)
    np.testing.assert_allclose(hid_t.numpy(), np.asarray(hid_j), **LOGITS_TOL)


def test_forward_matches_jax_stacked_pallas(monkeypatch):
    """128-aligned llada-moe-tiny: the JAX side keeps the [L, E, D, Fm]
    stacks out of its layer scan and indexes them by layer id, as the port
    always does."""
    monkeypatch.setenv("CTDB_MOE_STACKED", "1")
    monkeypatch.setenv("CTDB_GROUPED_GEMM", "pallas")
    over = dict(hidden_size=128, moe_intermediate_size=128, head_dim=32)
    jcfg, jp, jf, tcfg, tp, tf = _pair("llada-moe-tiny", 7, **over)
    ids, mask = _ids(8, 2, 24, jcfg.vocab_size, jcfg.mask_token_id, n_mask=8)
    want, aux_j = jf(jp, jnp.asarray(ids), jnp.asarray(mask), jnp.int32(16), 8)
    got, aux_t = tf(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                    logit_start=16, logit_length=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **LOGITS_TOL)


def test_forward_clamps_out_of_range_ids():
    _, _, _, tcfg, tp, tf = _pair("llada-tiny", 5)
    ids = torch.tensor([[1, 2, tcfg.vocab_size + 7]])
    clamped = torch.tensor([[1, 2, tcfg.vocab_size - 1]])
    assert torch.equal(tf(tp, ids)[0], tf(tp, clamped)[0])


@pytest.mark.parametrize("name", ["llada-moe-tiny", "llada-tiny"])
def test_greedy_generate_tokens_equal_jax(name):
    """The slice: greedy block decoding, batch 2, left-padded prompt."""
    jcfg, jp, jf, tcfg, tp, tf = _pair(name, 11)
    prompt, mask = _ids(12, 2, 8, jcfg.vocab_size, jcfg.mask_token_id)
    kw = dict(steps=16, gen_length=32, block_length=16,
              mask_id=jcfg.mask_token_id)
    want = j_generate(jf, jp, jnp.asarray(prompt), attn_mask=jnp.asarray(mask), **kw)
    got = t_generate(tf, tp, torch.from_numpy(prompt),
                     attn_mask=torch.from_numpy(mask), device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got[:, 8:] == jcfg.mask_token_id).any()


def test_generate_options_match_jax():
    """CFG, avoid-EOS and bf16-rounded confidence on the exact path."""
    jcfg, jp, jf, tcfg, tp, tf = _pair("llada-tiny", 13)
    prompt, _ = _ids(14, 2, 8, jcfg.vocab_size, jcfg.mask_token_id)
    kw = dict(steps=8, gen_length=16, block_length=8, mask_id=jcfg.mask_token_id,
              cfg_scale=1.5, avoid_eos=True, eos_token_id=jcfg.eos_token_id,
              confidence_dtype="bfloat16")
    want = j_generate(jf, jp, jnp.asarray(prompt), **kw)
    got = t_generate(tf, tp, torch.from_numpy(prompt), device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got == jcfg.eos_token_id)[:, 8:].any()


def test_unported_sampler_modes_raise():
    """The reference's remaining refusals: the block cache with CFG, and the
    block cache without its functions."""
    _, _, _, tcfg, tp, tf = _pair("llada-tiny", 1)
    prompt = torch.zeros((1, 4), dtype=torch.long)
    kw = dict(steps=4, gen_length=8, block_length=8, mask_id=500, device="cpu")
    with pytest.raises(NotImplementedError, match="CFG"):
        t_generate(tf, tp, prompt, block_cache=True, cached_fns=make_cached_fns(tcfg),
                   cfg_scale=1.0, **kw)
    with pytest.raises(ValueError, match="cached_fns"):
        t_generate(tf, tp, prompt, block_cache=True, **kw)
