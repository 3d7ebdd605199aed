"""The port's ``ModelRunner`` and tokenizer against the JAX package, on the CPU.

Both runners hold the same weights (JAX ``init_params`` bridged to torch,
quantized by each package's own ``quantize_params`` or loaded from one
checkpoint directory).  Greedy decoding must give equal tokens and equal
text; the tokenizer is the reference's byte fallback, output for output.
"""

import jax
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.eval.runner import ModelRunner as JRunner
from ct_diffusionmodelbench_tpu.io import checkpoint as jck
from ct_diffusionmodelbench_tpu.io import tokenizer as jtok
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu.ops import quant as jq
from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.io import checkpoint as tck
from ct_diffusionmodelbench_tpu_torch.io import tokenizer as ttok
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.ops import quant as tq

ALIGNED = dict(hidden_size=128, moe_intermediate_size=128, head_dim=32)
GEN = dict(gen_length=16, steps=8, block_length=8)


def _runners(name, seed, quant="int8", **over):
    cfg_j = j_get_config(name, dtype="float32", **over)
    cfg_t = t_get_config(name, dtype="float32", **over)
    params_j = j_init(cfg_j, jax.random.key(seed))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    tok_j = jtok.Tokenizer.byte_fallback(vocab_size=cfg_j.vocab_size, eos_token_id=2)
    tok_t = ttok.Tokenizer.byte_fallback(vocab_size=cfg_t.vocab_size, eos_token_id=2)
    return (JRunner(cfg_j, params_j, tok_j, quant=quant, prompt_bucket=16),
            ModelRunner(cfg_t, params_t, tok_t, quant=quant, prompt_bucket=16,
                        device="cpu"))


@pytest.mark.parametrize("name,over", [("llada-tiny", {}), ("llada-moe-tiny", {}),
                                       ("llada-moe-tiny", ALIGNED)])
def test_generate_ids_int8_matches_jax_runner(name, over):
    """Greedy int8 decoding, token for token.  The aligned MoE variant runs
    the port's int8 grouped pair (plain versions here); the others
    dequantize their experts in ``moe_block``, as the reference does."""
    jr, tr = _runners(name, 12, **over)
    assert tq.is_quantized(tr.params["blocks"]["wq"])
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, 480, (2, 12)).astype(np.int32)
    want = jr.generate_ids(prompt, **GEN)
    got = tr.generate_ids(prompt, **GEN)
    assert got.shape == (2, 28) and not (got[:, 12:] == tr.mask_id).any()
    np.testing.assert_array_equal(got, want)
    one = tr.generate_ids(prompt[0], **GEN)                 # a 1-D prompt
    np.testing.assert_array_equal(one, jr.generate_ids(prompt[0], **GEN))


def test_generate_and_batch_match_jax_runner():
    """Prompt buckets with left padding, EOS truncation and decoding."""
    jr, tr = _runners("llada-tiny", 13)
    kw = dict(truncate_at_eos=True, **GEN)
    for text in ("hello there", "a prompt of exactly 32 bytes ..."):
        want, got = jr.generate(text, **kw), tr.generate(text, **kw)
        np.testing.assert_array_equal(got.token_ids, want.token_ids)
        np.testing.assert_array_equal(got.continuation_ids, want.continuation_ids)
        assert got.text == want.text
    texts = ["short", "a rather longer prompt than the first one", "mid length"]
    for g, w in zip(tr.generate_batch(texts, **GEN), jr.generate_batch(texts, **GEN)):
        np.testing.assert_array_equal(g.token_ids, w.token_ids)
        assert g.text == w.text


def test_eos_truncation_and_plain_weights(monkeypatch):
    """Without quant the runner keeps plain weights; a continuation is cut
    at the first EOS exactly as the reference cuts it."""
    jr, tr = _runners("llada-tiny", 14, quant=None)
    assert not tq.is_quantized(tr.params["blocks"]["wq"])
    fake = np.array([[20, 21, 22, 23, 2, 24, 2, 25]])
    monkeypatch.setattr(tr, "generate_ids", lambda ids, **kw: fake)
    monkeypatch.setattr(jr, "generate_ids", lambda ids, **kw: fake)
    got = tr.generate("abcd", truncate_at_eos=True)
    want = jr.generate("abcd", truncate_at_eos=True)
    np.testing.assert_array_equal(got.continuation_ids, want.continuation_ids)
    assert got.text == want.text


def test_from_dir_detects_int8(tmp_path):
    cfg_j = j_get_config("llada-moe-tiny", dtype="float32")
    params_j = j_init(cfg_j, jax.random.key(15))
    qparams = jq.quantize_params(params_j)
    jck.save_quantized_checkpoint(tmp_path / "int8", cfg_j, qparams)
    jck.save_checkpoint(tmp_path / "f32", cfg_j, params_j)
    prompt = np.arange(3, 11, dtype=np.int32)
    want = JRunner.from_dir(tmp_path / "int8").generate_ids(prompt, **GEN)
    r = ModelRunner.from_dir(tmp_path / "int8", device="cpu")
    assert r.quant == "int8" and tq.is_quantized(r.params["blocks"]["we_gate"])
    assert r.tokenizer.kind == "byte"         # no tokenizer files: the fallback
    np.testing.assert_array_equal(r.generate_ids(prompt, **GEN), want)
    # an HF directory quantized on load gives the same tree as the int8 one
    r2 = ModelRunner.from_dir(tmp_path / "f32", quant="int8", dtype="float32",
                              device="cpu")
    for k in ("wq", "we_down"):
        assert torch.equal(r2.params["blocks"][k]["q"], r.params["blocks"][k]["q"])
        assert torch.equal(r2.params["blocks"][k]["s"], r.params["blocks"][k]["s"])
    assert ModelRunner.from_dir(tmp_path / "f32", dtype="float32",
                                device="cpu").quant is None


def test_random_init_int8_structure():
    r = ModelRunner.random_init("llada-moe-tiny", seed=1, quant="int8", device="cpu")
    assert r.cfg.dtype == "float32"           # off the card, as off the TPU
    blocks = r.params["blocks"]
    for k in tq.DENSE_QUANT_KEYS + tq.EXPERT_QUANT_KEYS:
        if k in blocks:
            assert tq.is_quantized(blocks[k]) and blocks[k]["q"].dtype == torch.int8, k
    assert not tq.is_quantized(blocks["router"]) and tq.is_quantized(r.params["lm_head"])
    out = r.generate_ids(np.array([3, 4, 5]), **GEN)
    assert out.shape == (1, 19) and not (out[:, 3:] == r.mask_id).any()


def test_runner_refuses_what_is_not_ported():
    cfg = t_get_config("dream-tiny", dtype="float32")
    tok = ttok.Tokenizer.byte_fallback(512)
    r = ModelRunner.random_init("llada-tiny", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 #3"):
        ModelRunner(cfg, r.params, tok, device="cpu")
    with pytest.raises(NotImplementedError, match="block-cache"):
        ModelRunner(r.cfg, r.params, tok, accel="block-cache", device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        ModelRunner(r.cfg, r.params, tok, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="quant"):
        ModelRunner(r.cfg, r.params, tok, quant="int4", device="cpu")
    with pytest.raises(NotImplementedError, match="parallel_threshold"):
        r.generate_ids(np.array([3, 4]), parallel_threshold=0.9, **GEN)


def test_runner_entry_points_raise_without_card(monkeypatch, tmp_path):
    from ct_diffusionmodelbench_tpu_torch import quantize_ckpt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRunner.random_init("llada-tiny")
    r = ModelRunner.random_init("llada-tiny", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRunner(r.cfg, r.params, r.tokenizer)
    tck.save_checkpoint(tmp_path / "ck", r.cfg, r.params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRunner.from_dir(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.load_checkpoint(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_ckpt.main(["--in", str(tmp_path / "ck"), "--out", str(tmp_path / "q")])


def test_tokenizer_matches_jax():
    tj = jtok.Tokenizer.byte_fallback(vocab_size=512, eos_token_id=2)
    tt = ttok.Tokenizer.byte_fallback(vocab_size=512, eos_token_id=2)
    text = "Prove that 1 + 1 = 2. ∀ x, x ≤ x"
    assert tt.encode(text) == tj.encode(text)
    assert tt.encode(text, max_length=7) == tj.encode(text, max_length=7)
    ids = tj.encode(text) + [2, 0, 300]
    assert tt.decode(ids) == tj.decode(ids)
    msgs = [{"role": "user", "content": "hi"}]
    assert tt.apply_chat_template(msgs) == tj.apply_chat_template(msgs)
    assert (tt.apply_chat_template(msgs, add_generation_prompt=False)
            == tj.apply_chat_template(msgs, add_generation_prompt=False))
    for kw in (dict(), dict(config_mask_id=7), dict(override=9, config_mask_id=7),
               dict(tokenizer=tt, vocab_size=512)):
        kj = dict(kw, tokenizer=tj) if "tokenizer" in kw else kw
        assert ttok.resolve_mask_id(**kw) == jtok.resolve_mask_id(**kj)
    assert (tt.pad_token_id, tt.eos_token, tt.kind) == (tj.pad_token_id, tj.eos_token, tj.kind)
