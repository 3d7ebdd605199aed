"""The port's Dream/DiffuCoder sampler, its runner families and the simple
samplers against the JAX package, on the CPU.

Both frameworks run the same f32 weights (JAX ``init_params`` bridged to
torch).  Where a sampler draws random numbers, the test draws them with JAX
from the reference's own key chain and feeds them to the port, so sampled
runs are compared token for token too.  Tolerances:
- tokens: equal;
- confidences from ``_filter_and_sample``: rtol 1e-5, atol 1e-6 (f32
  softmax / logsumexp / entropy over at most 512 logits, summed in another
  order);
- logits: rtol = atol = 2e-4, as ``tests/test_torch_port_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.eval.runner import ModelRunner as JRunner
from ct_diffusionmodelbench_tpu.io import tokenizer as jtok
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init_params
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_make_forward_fn
from ct_diffusionmodelbench_tpu.sampling import dream as jdream
from ct_diffusionmodelbench_tpu.sampling import simple as jsimple
from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.io import tokenizer as ttok
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn as t_make_forward_fn
from ct_diffusionmodelbench_tpu_torch.sampling import dream as tdream
from ct_diffusionmodelbench_tpu_torch.sampling import simple as tsimple

CONF_TOL = dict(rtol=1e-5, atol=1e-6)
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
MASK = 500   # the tiny presets' mask id


def _pair(name, seed, **overrides):
    jcfg = j_get_config(name, dtype="float32", **overrides)
    tcfg = t_get_config(name, dtype="float32", **overrides)
    jparams = j_init_params(jcfg, jax.random.key(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jcfg, jparams, j_make_forward_fn(jcfg),
            tcfg, tparams, t_make_forward_fn(tcfg, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _prompt(seed, b, p, vocab=480):
    return np.random.default_rng(seed).integers(3, vocab, (b, p)).astype(np.int32)


# ---------------------------------------------------------------------------
# _filter_and_sample
# ---------------------------------------------------------------------------

FILTERS = [dict(top_p=None), dict(top_p=0.9), dict(top_p=None, top_k=5),
           dict(top_p=0.8, top_k=7)]


@pytest.mark.parametrize("alg", tdream.ALGS)
@pytest.mark.parametrize("filt", range(len(FILTERS)))
@pytest.mark.parametrize("temperature,exact", [(0.0, False), (0.7, False), (0.7, True)])
def test_filter_and_sample_matches_jax(alg, filt, temperature, exact):
    """Every alg, with and without top-p / top-k, greedy and sampled, with
    the prefilter and ``exact``; the sampled runs fed JAX's draws."""
    kw = dict(FILTERS[filt], alg=alg, temperature=temperature, exact=exact, steps=4)
    sc_j, sc_t = jdream.DreamSamplerConfig(**kw), tdream.DreamSamplerConfig(**kw)
    logits = np.asarray(jax.random.normal(jax.random.key(filt + 3), (2, 6, 512))) * 3
    key = jax.random.key(7)
    x0_j, conf_j = jdream._filter_and_sample(jnp.asarray(logits), sc_j, key)
    k = 512 if exact else tdream.TOP_P_PREFILTER
    u = jax.random.uniform(key, (2, 6, k), jnp.float32, minval=1e-20, maxval=1.0)
    x0_t, conf_t = tdream._filter_and_sample(_t(logits), sc_t, u_tok=_t(u))
    np.testing.assert_array_equal(x0_t.numpy(), np.asarray(x0_j))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), **CONF_TOL)


def test_timesteps_equal_jax_linspace():
    for n in (1, 4, 6, 8, 37, 100, 128, 256, 351):
        np.testing.assert_array_equal(tdream._timesteps(n, 1e-3).numpy(),
                                      np.asarray(jnp.linspace(1.0, 1e-3, n + 1)))


@pytest.mark.parametrize("steps", [256, 512])
def test_unmask_counts_match_jitted_sampler(steps):
    """The number of tokens unmasked at each step equals the reference's
    sampler under ``jax.jit``, where XLA evaluates ``jnp.linspace`` itself
    (an ulp off the eager values at some step counts): one fixed fake
    forward, greedy, ``maskgit_plus``, B 1, gen = steps."""
    p, vocab, mask_id = 8, 96, 1000
    logits = np.random.default_rng(steps).standard_normal((1, p + steps, vocab))
    logits = logits.astype(np.float32)
    kw = dict(steps=steps, max_new_tokens=steps, temperature=0.0, alg="maskgit_plus",
              mask_id=mask_id)
    prompt = _prompt(steps, 1, p)
    fake = lambda params, ids, m=None: (params, None)   # noqa: E731  the logits
    _, hist_j = jdream.make_dream_sampler(fake, jdream.DreamSamplerConfig(**kw),
                                          output_history=True)(
        jnp.asarray(logits), jnp.asarray(prompt))
    _, hist_t = tdream.make_dream_sampler(fake, tdream.DreamSamplerConfig(**kw),
                                          output_history=True)(_t(logits), _t(prompt))

    def per_step(hist):
        filled = (np.asarray(hist)[:, 0, p:] != mask_id).sum(axis=1)
        return np.diff(filled, prepend=0)

    want = per_step(hist_j)
    assert want.sum() == steps
    np.testing.assert_array_equal(per_step(hist_t.numpy()), want)


def test_invalid_alg_raises():
    with pytest.raises(NotImplementedError):
        tdream.DreamSamplerConfig(alg="not-an-alg")


# ---------------------------------------------------------------------------
# dream_generate on dream-tiny
# ---------------------------------------------------------------------------

def _jax_draws(key, steps, tok_shape, pos_shape, pos_min):
    """The reference loop's per-step draws from its key chain: (u_tok,
    u_pos) for each step."""
    out = []
    for _ in range(steps):
        key, k_tok, k_pos = jax.random.split(key, 3)
        u_tok = jax.random.uniform(k_tok, tok_shape, jnp.float32, minval=1e-20,
                                   maxval=1.0)
        if pos_min:
            u_pos = jax.random.uniform(k_pos, pos_shape, jnp.float32,
                                       minval=1e-20, maxval=1.0)
        else:
            u_pos = jax.random.uniform(k_pos, pos_shape)
        out.append((_t(u_tok), _t(u_pos)))
    return out


@pytest.mark.parametrize("sliced", [True, False])
@pytest.mark.parametrize("alg,top_p,temperature,alg_temp", [
    ("entropy", None, 0.0, 0.0),
    ("entropy", 0.9, 0.0, 0.0),
    ("maskgit_plus", 0.95, 0.0, 0.0),
    ("topk_margin", None, 0.0, 0.0),
    ("origin", None, 0.0, 0.0),          # position draws
    ("entropy", 0.95, 0.5, 0.0),         # token draws
    ("maskgit_plus", None, 0.0, 2.0),    # Gumbel-top-k position draws
])
def test_dream_generate_matches_jax(sliced, alg, top_p, temperature, alg_temp):
    """Token for token on dream-tiny (QKV bias, shifted logits), with the
    LM head sliced to the generated region and at full width."""
    jcfg, jp, jf, tcfg, tp, tf = _pair("dream-tiny", 2)
    if not sliced:   # hide logit_start: the sampler then scores every position
        jf_, tf_ = jf, tf
        jf = lambda p, ids, m=None: jf_(p, ids, m)           # noqa: E731
        tf = lambda p, ids, m=None: tf_(p, ids, m)           # noqa: E731
    prompt = _prompt(30, 2, 7)
    mask = np.ones((2, 7), np.int32)
    mask[1, :2] = 0
    steps, gen = 6, 12
    kw = dict(steps=steps, max_new_tokens=gen, temperature=temperature, top_p=top_p,
              alg=alg, alg_temp=alg_temp, mask_id=MASK)
    key = jax.random.key(11)
    want, hist_j = jdream.dream_generate(jf, jp, jnp.asarray(prompt),
                                         attn_mask=jnp.asarray(mask), key=key,
                                         output_history=True, **kw)
    width = gen if sliced else 7 + gen
    k = 64 if top_p is not None else 512
    draws = _jax_draws(key, steps, (2, width, k), (2, width), pos_min=alg_temp > 0)
    got, hist_t = tdream.dream_generate(tf, tp, _t(prompt), attn_mask=_t(mask),
                                        uniforms=draws, output_history=True,
                                        device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
    assert not (got[:, 7:] == MASK).any()


def test_dream_generate_exact_and_batch_mean_match_jax():
    """``exact`` unmasks a prompt's literal mask ids in place;
    ``batch_mean_counts`` takes the batch-averaged count."""
    jcfg, jp, jf, tcfg, tp, tf = _pair("dream-tiny", 3)
    prompt = _prompt(31, 2, 6)
    prompt[0, 2] = MASK
    for extra in (dict(exact=True), dict(batch_mean_counts=True)):
        kw = dict(steps=5, max_new_tokens=10, temperature=0.0, top_p=0.9,
                  alg="entropy", mask_id=MASK, **extra)
        want, _ = jdream.dream_generate(jf, jp, jnp.asarray(prompt), **kw)
        got, _ = tdream.dream_generate(tf, tp, _t(prompt), device="cpu", **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dream_generate_generator_fills_every_mask():
    _, _, _, tcfg, tp, tf = _pair("dream-tiny", 4)
    gen = torch.Generator().manual_seed(0)
    for alg in tdream.ALGS:
        out, _ = tdream.dream_generate(tf, tp, _t(_prompt(32, 1, 6)), steps=4,
                                       max_new_tokens=8, temperature=0.4, alg=alg,
                                       mask_id=MASK, generator=gen, device="cpu")
        assert not (out == MASK).any(), alg


# ---------------------------------------------------------------------------
# the runner's Dream / DiffuCoder families
# ---------------------------------------------------------------------------

def _runners(family, seed):
    jcfg = j_get_config("dream-tiny", dtype="float32", family=family)
    tcfg = t_get_config("dream-tiny", dtype="float32", family=family)
    jparams = j_init_params(jcfg, jax.random.key(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tok_j = jtok.Tokenizer.byte_fallback(vocab_size=512, eos_token_id=2)
    tok_t = ttok.Tokenizer.byte_fallback(vocab_size=512, eos_token_id=2)
    return (JRunner(jcfg, jparams, tok_j, prompt_bucket=16),
            ModelRunner(tcfg, tparams, tok_t, prompt_bucket=16, device="cpu"))


GEN = dict(gen_length=12, steps=6, temperature=0.0)


@pytest.mark.parametrize("family", ["dream", "diffucoder"])
def test_runner_generate_matches_jax(family):
    jr, tr = _runners(family, 5)
    assert tr.family == family
    for text in ("theorem foo : 1 + 1 = 2 :=", "hello"):
        kw = dict(truncate_at_eos=True, alg="entropy", **GEN)
        want, got = jr.generate(text, **kw), tr.generate(text, **kw)
        np.testing.assert_array_equal(got.token_ids, want.token_ids)
        assert got.text == want.text
    for kw in (dict(top_p=None, alg="topk_margin"), dict(exact=True, alg="maskgit_plus"),
               dict(batch_mean_counts=True)):
        texts = ["short", "a longer prompt for the batch", "mid"]
        for g, w in zip(tr.generate_batch(texts, **kw, **GEN),
                        jr.generate_batch(texts, **kw, **GEN)):
            np.testing.assert_array_equal(g.token_ids, w.token_ids)
            assert g.text == w.text


@pytest.mark.parametrize("family,marker", [("dream", "</s>"), ("diffucoder", "<|dlm_pad|>")])
def test_runner_splits_text_like_jax(monkeypatch, family, marker):
    """Dream cuts the decoded text at ``eos_token``, DiffuCoder at
    ``<|dlm_pad|>``; LLaDA would keep both."""
    jr, tr = _runners(family, 6)
    body = [b + 16 for b in f"abc{marker}def".encode()]
    fake = np.array([[20] * 16 + body])      # the prompt, bucketed to 16
    for r in (jr, tr):
        monkeypatch.setattr(r, "generate_ids", lambda ids, **kw: fake)
    got, want = tr.generate("ab"), jr.generate("ab")
    assert got.text == want.text == "abc"
    assert tr.generate_batch(["ab"])[0].text == "abc"


def test_dream_bridge_and_forward_match_jax():
    """The bridge carries the Dream tree (QKV bias, no qk-norm); the shifted
    logits agree, full width and sliced."""
    jcfg, jp, jf, tcfg, tp, tf = _pair("dream-tiny", 8)
    for k in ("bq", "bk", "bv"):
        assert k in tp["blocks"] and tp["blocks"][k].shape == jp["blocks"][k].shape
    assert "q_norm" not in tp["blocks"]
    tp["blocks"]["bq"].add_(0.1)              # make the bias matter
    jp["blocks"]["bq"] = jp["blocks"]["bq"] + 0.1
    ids = _prompt(33, 2, 20)
    want, _ = jf(jp, jnp.asarray(ids))
    got, _ = tf(tp, _t(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    want_s, _ = jf(jp, jnp.asarray(ids), None, jnp.int32(12), 8)
    got_s, _ = tf(tp, _t(ids), logit_start=12, logit_length=8)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **LOGITS_TOL)


# ---------------------------------------------------------------------------
# simple samplers
# ---------------------------------------------------------------------------

def test_simple_generate_matches_jax():
    jcfg, jp, jf, tcfg, tp, tf = _pair("llada-tiny", 9)
    prompt = _prompt(34, 2, 6)
    x0 = np.concatenate([prompt, np.full((2, 8), MASK, np.int32)], axis=1)
    first = np.array(jf(jp, jnp.asarray(x0))[0])[0, 6]
    first[MASK] = -np.inf
    for eos in (None, int(first.argmax())):     # row 0 stops at its first token
        want = jsimple.simple_generate(jf, jp, jnp.asarray(prompt), mask_id=MASK,
                                       max_tokens=8, eos_token_id=eos)
        got = tsimple.simple_generate(tf, tp, _t(prompt), mask_id=MASK,
                                      max_tokens=8, eos_token_id=eos)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = tsimple.simple_generate(tf, tp, _t(prompt[0]), mask_id=MASK, max_tokens=4)
    assert one.shape == (1, 10)


def _ar_draws(key, steps, shape):
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, shape, minval=1e-20, maxval=1.0)
        out.append(_t(-jnp.log(-jnp.log(u))))
    return out


@pytest.mark.parametrize("temperature,top_p", [(0.0, None), (0.8, None), (0.8, 0.9)])
def test_ar_generate_matches_jax(temperature, top_p):
    """Greedy, plain sampling and top-p sampling on a causal llada-tiny, the
    sampled runs fed JAX's Gumbel draws; EOS stops a row."""
    jcfg, jp, _, tcfg, tp, _ = _pair("llada-tiny", 10)
    jcfg, tcfg = jcfg.replace(causal=True), tcfg.replace(causal=True)
    jf, tf = j_make_forward_fn(jcfg), t_make_forward_fn(tcfg, device="cpu")
    prompt = _prompt(35, 2, 5)
    kw = dict(max_new_tokens=6, temperature=temperature, top_p=top_p,
              eos_token_id=40, pad_token_id=0)
    key = jax.random.key(12)
    want = jsimple.ar_generate(jf, jp, jnp.asarray(prompt), key=key, **kw)
    draws = _ar_draws(key, 6, (2, 512)) if temperature > 0 else None
    got = tsimple.ar_generate(tf, tp, _t(prompt), gumbel=draws, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
