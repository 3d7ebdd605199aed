"""Block-cache (dual KV cache) and confidence-threshold decoding of the
port against the JAX package, on the CPU.

Both sides run the same f32 weights (JAX ``init_params`` bridged to torch)
on the same prompts, made from a seed with numpy.  Mirrors
``tests/test_block_cache.py``:
- greedy tokens: equal to JAX's, and to the port's own exact sampler where
  the cache is exact (one layer, one step a block);
- ``forward_refresh``'s block logits and K/V caches and
  ``forward_cached_step``'s logits: rtol = atol = 2e-4 of JAX's (f32 ops
  summed in other orders, as ``tests/test_torch_port_model.py``);
- the cached step at one layer against the full forward on the same
  tokens: rtol = atol = 2e-4 (the reference's own tolerance).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.cli import bench as j_bench_cli
from ct_diffusionmodelbench_tpu.cli import chat as j_chat
from ct_diffusionmodelbench_tpu.cli import infer_split as j_infer
from ct_diffusionmodelbench_tpu.cli import minif2f as j_minif2f_cli
from ct_diffusionmodelbench_tpu.eval.runner import ModelRunner as JRunner
from ct_diffusionmodelbench_tpu.io import tokenizer as j_tok
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init_params
from ct_diffusionmodelbench_tpu.models import make_cached_fns as j_cached_fns
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_forward_fn
from ct_diffusionmodelbench_tpu.models.block_cache import (
    forward_cached_step as j_cached_step)
from ct_diffusionmodelbench_tpu.models.block_cache import forward_refresh as j_refresh
from ct_diffusionmodelbench_tpu.sampling import llada_generate as j_generate
from ct_diffusionmodelbench_tpu_torch.cli import bench as t_bench_cli
from ct_diffusionmodelbench_tpu_torch.cli import chat as t_chat
from ct_diffusionmodelbench_tpu_torch.cli import common as t_common
from ct_diffusionmodelbench_tpu_torch.cli import infer_split as t_infer
from ct_diffusionmodelbench_tpu_torch.cli import minif2f as t_minif2f_cli
from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.io import tokenizer as t_tok
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import make_cached_fns as t_cached_fns
from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn as t_forward_fn
from ct_diffusionmodelbench_tpu_torch.models.block_cache import (
    forward_cached_step as t_cached_step)
from ct_diffusionmodelbench_tpu_torch.models.block_cache import forward_refresh as t_refresh
from ct_diffusionmodelbench_tpu_torch.ops import quant as tq
from ct_diffusionmodelbench_tpu_torch.sampling import llada as t_llada
from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate as t_generate
from ct_diffusionmodelbench_tpu_torch.sampling.llada import LLaDASamplerConfig
from tests.torch_port_threads import one_torch_thread  # noqa: F401

LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
ALIGNED = dict(hidden_size=128, moe_intermediate_size=128, head_dim=32)
GEN = dict(steps=8, gen_length=32, block_length=8)
P = 16


class Pair:
    """One JAX ``init_params`` tree and its torch bridge, with each side's
    forward and cached functions."""

    def __init__(self, name, seed=0, **over):
        self.jcfg = j_get_config(name, dtype="float32", **over)
        self.tcfg = t_get_config(name, dtype="float32", **over)
        self.jp = j_init_params(self.jcfg, jax.random.key(seed))
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.jp), device="cpu")
        self.jf = j_forward_fn(self.jcfg)
        self.tf = t_forward_fn(self.tcfg, device="cpu")
        self.mask_id = self.jcfg.mask_token_id

    def prompt(self, b=2, pad=False, seed=7):
        ids = np.random.default_rng(seed).integers(3, self.jcfg.vocab_size - 20,
                                                   (b, P)).astype(np.int32)
        mask = np.ones((b, P), np.int32)
        if pad:
            mask[0, :5] = 0           # row 0 left-padded
        return ids, (mask if pad else None)

    def jax(self, ids, mask=None, block_cache=False, **kw):
        cached = j_cached_fns(self.jcfg) if block_cache else None
        return np.asarray(j_generate(
            self.jf, self.jp, jnp.asarray(ids), mask_id=self.mask_id,
            block_cache=block_cache, cached_fns=cached, key=jax.random.key(3),
            attn_mask=None if mask is None else jnp.asarray(mask), **kw))

    def port(self, ids, mask=None, block_cache=False, generator=None, **kw):
        cached = t_cached_fns(self.tcfg) if block_cache else None
        return t_generate(
            self.tf, self.tp, torch.from_numpy(ids), mask_id=self.mask_id,
            block_cache=block_cache, cached_fns=cached, generator=generator,
            attn_mask=None if mask is None else torch.from_numpy(mask),
            device="cpu", **kw).numpy()


# ---------------------------------------------------------------------------
# the dual cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [False, True])
def test_one_layer_cache_is_exact(pad):
    """One layer: the cache is exact, so the cached decode equals the exact
    sampler's, with and without left padding."""
    pair = Pair("llada-tiny", num_layers=1)
    ids, mask = pair.prompt(pad=pad)
    cached = pair.port(ids, mask, block_cache=True, **GEN)
    np.testing.assert_array_equal(cached, pair.port(ids, mask, **GEN))
    np.testing.assert_array_equal(cached, pair.jax(ids, mask, block_cache=True, **GEN))


def test_one_step_per_block_is_exact():
    """steps == num_blocks: every step refreshes, so a 3-layer cached decode
    equals the exact sampler's."""
    pair = Pair("llada-tiny", num_layers=3)
    ids, _ = pair.prompt()
    kw = dict(steps=4, gen_length=32, block_length=8)
    cached = pair.port(ids, block_cache=True, **kw)
    np.testing.assert_array_equal(cached, pair.port(ids, **kw))
    np.testing.assert_array_equal(cached, pair.jax(ids, block_cache=True, **kw))


@pytest.mark.parametrize("name", ["llada-tiny", "llada-moe-tiny"])
def test_refresh_and_cached_step_match_jax(name):
    """Two layers, a left-padded row: the refresh's block logits and its
    rotated K / V caches, then a cached step on changed block tokens."""
    pair = Pair(name, seed=1, num_layers=2)
    rng = np.random.default_rng(2)
    B, S, bs, bl = 2, 24, 12, 8
    ids = rng.integers(0, pair.jcfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, :3] = 0
    want, kc_j, vc_j = j_refresh(pair.jcfg, pair.jp, jnp.asarray(ids), jnp.asarray(mask),
                                 bs, bl)
    got, kc_t, vc_t = t_refresh(pair.tcfg, pair.tp, torch.from_numpy(ids),
                                torch.from_numpy(mask), bs, bl)
    assert kc_t.shape == (2, B, S, pair.tcfg.num_kv_heads, pair.tcfg.head_dim)
    for g, w in ((got, want), (kc_t, kc_j), (vc_t, vc_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGITS_TOL)
    blk = rng.integers(0, pair.jcfg.vocab_size, (B, bl)).astype(np.int32)
    want = j_cached_step(pair.jcfg, pair.jp, jnp.asarray(blk), bs, kc_j, vc_j,
                         jnp.asarray(mask))
    got = t_cached_step(pair.tcfg, pair.tp, torch.from_numpy(blk), bs, kc_t, vc_t,
                        torch.from_numpy(mask))
    assert got.shape == (B, bl, pair.tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)


def test_cached_step_logits_match_forward_one_layer():
    """One layer: the cached step on new block tokens equals the full
    forward on the sequence holding them (the cache is exact), and JAX's."""
    pair = Pair("llada-tiny", num_layers=1)
    rng = np.random.default_rng(1)
    B, S, bl, bs = 2, 24, 8, 12
    ids = torch.from_numpy(rng.integers(0, pair.tcfg.vocab_size, (B, S)))
    _, kc, vc = t_refresh(pair.tcfg, pair.tp, ids, None, bs, bl)
    blk = torch.from_numpy(rng.integers(0, pair.tcfg.vocab_size, (B, bl)))
    ids2 = ids.clone()
    ids2[:, bs:bs + bl] = blk
    full, _ = pair.tf(pair.tp, ids2)
    got = t_cached_step(pair.tcfg, pair.tp, blk, bs, kc, vc, None)
    np.testing.assert_allclose(got.numpy(), full[:, bs:bs + bl].numpy(), **LOGITS_TOL)
    _, kc_j, vc_j = j_refresh(pair.jcfg, pair.jp, jnp.asarray(ids.numpy()), None, bs, bl)
    want = j_cached_step(pair.jcfg, pair.jp, jnp.asarray(blk.numpy()), bs, kc_j, vc_j, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)


@pytest.mark.parametrize("name", ["llada-tiny", "llada-moe-tiny"])
def test_cached_decode_tokens_equal_jax(name):
    """Deep models (3 layers), where the cache is an approximation: greedy
    tokens equal to JAX's with ``block_cache=True``; the init function gives
    the cache's shape."""
    pair = Pair(name, seed=2, num_layers=3)
    ids, mask = pair.prompt(pad=True)
    got = pair.port(ids, mask, block_cache=True, **GEN)
    np.testing.assert_array_equal(got, pair.jax(ids, mask, block_cache=True, **GEN))
    assert got.shape == (2, P + 32)
    kc, vc = t_cached_fns(pair.tcfg)[2](pair.tp, 2, P + 32)
    assert kc.shape == vc.shape == (3, 2, P + 32, pair.tcfg.num_kv_heads,
                                    pair.tcfg.head_dim)
    assert not kc.any() and t_cached_fns(pair.tcfg) is t_cached_fns(pair.tcfg)


def test_temperature_path_runs():
    pair = Pair("llada-tiny", num_layers=2)
    ids, _ = pair.prompt()
    gen = torch.Generator().manual_seed(0)
    out = pair.port(ids, block_cache=True, temperature=0.7, generator=gen, **GEN)
    assert out.shape == (2, P + 32) and not (out[:, P:] == pair.mask_id).any()


def test_unsupported_configs_raise():
    with pytest.raises(NotImplementedError, match="shifted-logit"):
        t_cached_fns(t_get_config("dream-tiny"))
    with pytest.raises(NotImplementedError, match="bidirectional"):
        t_cached_fns(t_get_config("llada-tiny").replace(causal=True))
    with pytest.raises(NotImplementedError, match="CFG"):
        LLaDASamplerConfig(block_cache=True, cfg_scale=1.0)
    pair = Pair("llada-tiny", num_layers=1)
    with pytest.raises(ValueError, match="cached_fns"):
        t_llada.make_llada_sampler(pair.tf, LLaDASamplerConfig(block_cache=True), P)
    # threshold decoding does not read ``steps``: no divisibility check
    assert LLaDASamplerConfig(steps=7, parallel_threshold=0.9).num_blocks == 4
    with pytest.raises(ValueError, match="steps"):
        LLaDASamplerConfig(steps=7)


# ---------------------------------------------------------------------------
# confidence-threshold parallel decoding
# ---------------------------------------------------------------------------

def _forwards(monkeypatch):
    """Count the threshold loop's forwards (its host reads of the flag)."""
    calls = []
    real = t_llada.block_has_mask

    def counted(x_blk, mask_id):
        has = real(x_blk, mask_id)
        calls.append(has)
        return has

    monkeypatch.setattr(t_llada, "block_has_mask", counted)
    return calls


@pytest.mark.parametrize("block_cache", [False, True])
def test_threshold_above_one_is_one_unmask_per_step(monkeypatch, block_cache):
    """No confidence clears 1.5: exactly the most confident position
    unmasks each forward, as the exact sampler with steps == gen_length;
    tokens equal JAX's, with the cache too."""
    pair = Pair("llada-tiny", num_layers=2)
    ids, _ = pair.prompt()
    kw = dict(steps=8, gen_length=32, block_length=8, parallel_threshold=1.5,
              block_cache=block_cache)
    calls = _forwards(monkeypatch)
    got = pair.port(ids, **kw)
    assert calls.count(True) == 32              # 4 blocks of 8 forwards
    np.testing.assert_array_equal(got, pair.jax(ids, **kw))
    if not block_cache:
        np.testing.assert_array_equal(got, pair.port(ids, steps=32, gen_length=32,
                                                     block_length=8))


def test_threshold_zero_unmasks_block_per_step(monkeypatch):
    """Every masked position clears 0: one forward a block, the exact
    sampler at one step a block.  These random models sometimes predict the
    mask id itself, which leaves a position masked for another forward, so
    the mask id is barred from the predictions (``avoid_eos`` on it)."""
    pair = Pair("llada-tiny", num_layers=2)
    ids, _ = pair.prompt()
    kw = dict(gen_length=32, block_length=8, avoid_eos=True, eos_token_id=pair.mask_id)
    calls = _forwards(monkeypatch)
    got = pair.port(ids, steps=8, parallel_threshold=0.0, **kw)
    assert calls == [True, False] * 4
    assert not (got[:, P:] == pair.mask_id).any()
    np.testing.assert_array_equal(got, pair.port(ids, steps=4, **kw))
    np.testing.assert_array_equal(got, pair.jax(ids, steps=8, parallel_threshold=0.0, **kw))


@pytest.mark.parametrize("block_cache", [False, True])
@pytest.mark.parametrize("thr", [0.02, 0.9])
@pytest.mark.parametrize("name", ["llada-tiny", "llada-moe-tiny"])
def test_threshold_tokens_equal_jax(monkeypatch, capsys, name, thr, block_cache):
    """Greedy threshold decoding at 2 layers, a left-padded row, with and
    without the cache: tokens equal JAX's.  0.9 is the reference's setting
    (no confidence of these random models clears it: one unmask a forward,
    8 a block); 0.02 lies inside their confidences (about 0.01-0.10), so a
    forward unmasks several positions and blocks end early.  The mask id is
    barred from the predictions (``avoid_eos`` on it), else a predicted mask
    id keeps a block open to its last forward.  The smallest distance of a
    confidence from the threshold is printed: one within f32 rounding of
    it could decide differently in the two frameworks."""
    pair = Pair(name, seed=3, num_layers=2)
    ids, mask = pair.prompt(pad=True)
    seen = []
    real = t_llada.token_confidence

    def recording(logits, x0):
        c = real(logits, x0)
        seen.append(c)
        return c

    monkeypatch.setattr(t_llada, "token_confidence", recording)
    calls = _forwards(monkeypatch)
    kw = dict(GEN, parallel_threshold=thr, block_cache=block_cache, avoid_eos=True,
              eos_token_id=pair.mask_id)
    got = pair.port(ids, mask, **kw)
    margin = min(float((c - thr).abs().min()) for c in seen)
    with capsys.disabled():
        print(f"\n{name} thr {thr} cache {block_cache}: {calls.count(True)} forwards, "
              f"smallest |confidence - thr| {margin:.3e}")
    np.testing.assert_array_equal(got, pair.jax(ids, mask, **kw))
    assert not (got[:, P:] == pair.mask_id).any()
    assert calls.count(True) == 32 if thr == 0.9 else calls.count(True) < 32


def test_threshold_with_cfg_equals_jax():
    """CFG composes with the uncached threshold path, as in the reference."""
    pair = Pair("llada-tiny", num_layers=2)
    ids, _ = pair.prompt()
    kw = dict(GEN, parallel_threshold=0.04, cfg_scale=1.5, avoid_eos=True,
              eos_token_id=pair.jcfg.eos_token_id)
    np.testing.assert_array_equal(pair.port(ids, **kw), pair.jax(ids, **kw))


# ---------------------------------------------------------------------------
# the runner and the CLIs
# ---------------------------------------------------------------------------

def _runners(name, accel=None, quant=None, seed=5, **over):
    pair = Pair(name, seed=seed, **over)
    tok_j = j_tok.Tokenizer.byte_fallback(vocab_size=pair.jcfg.vocab_size, eos_token_id=2)
    tok_t = t_tok.Tokenizer.byte_fallback(vocab_size=pair.tcfg.vocab_size, eos_token_id=2)
    return (JRunner(pair.jcfg, pair.jp, tok_j, accel=accel, quant=quant, prompt_bucket=16),
            ModelRunner(pair.tcfg, pair.tp, tok_t, accel=accel, quant=quant,
                        prompt_bucket=16, device="cpu"))


def test_runner_accel_flag():
    jr, tr = _runners("llada-tiny", accel="block-cache", num_layers=2)
    assert tr.cached_fns is t_cached_fns(tr.cfg) and tr.accel == "block-cache"
    kw = dict(gen_length=16, steps=4, block_length=8)
    want, got = jr.generate("hello world", **kw), tr.generate("hello world", **kw)
    assert len(got.continuation_ids) == 16
    np.testing.assert_array_equal(got.token_ids, want.token_ids)
    assert got.text == want.text
    with pytest.raises(NotImplementedError, match="LLaDA"):
        ModelRunner.random_init("dream-tiny", accel="block-cache", device="cpu")
    with pytest.raises(ValueError, match="accel"):
        ModelRunner.random_init("llada-tiny", accel="nope", device="cpu")


def test_parallel_threshold_runner_flag():
    """The runner's default threshold, and a per-call one over it, in
    ``generate`` and ``generate_batch``."""
    jr, tr = _runners("llada-tiny", num_layers=2)
    jr.parallel_threshold = tr.parallel_threshold = 0.04
    kw = dict(gen_length=16, steps=4, block_length=8)
    want, got = jr.generate("theorem", **kw), tr.generate("theorem", **kw)
    np.testing.assert_array_equal(got.token_ids, want.token_ids)
    texts = ["short", "a rather longer prompt than the first one"]
    for g, w in zip(tr.generate_batch(texts, **kw), jr.generate_batch(texts, **kw)):
        np.testing.assert_array_equal(g.token_ids, w.token_ids)
    ids = np.arange(3, 11)
    np.testing.assert_array_equal(tr.generate_ids(ids, parallel_threshold=0.0, **kw),
                                  jr.generate_ids(ids, parallel_threshold=0.0, **kw))


@pytest.mark.parametrize("name,over", [("llada-tiny", {}), ("llada-moe-tiny", ALIGNED)])
def test_runner_quant_composes_with_block_cache(name, over):
    """int8 weights with the cache (and a threshold): the cached passes take
    the quantized leaves; the aligned MoE runs the int8 grouped pair's plain
    versions.  Tokens equal JAX's."""
    jr, tr = _runners(name, accel="block-cache", quant="int8", num_layers=2, **over)
    assert tq.is_quantized(tr.params["blocks"]["wq"])
    ids = np.random.default_rng(0).integers(3, 480, (2, 12)).astype(np.int32)
    kw = dict(gen_length=16, steps=8, block_length=8)
    np.testing.assert_array_equal(tr.generate_ids(ids, **kw), jr.generate_ids(ids, **kw))
    np.testing.assert_array_equal(tr.generate_ids(ids, parallel_threshold=0.04, **kw),
                                  jr.generate_ids(ids, parallel_threshold=0.04, **kw))


FLAGS = ["--preset", "llada-tiny", "--accel", "block-cache", "--parallel-threshold", "0.04"]
TINY_GEN = ["--gen-length", "16", "--steps", "8", "--block-length", "8"]


def _cli_files(tmp_path):
    data = tmp_path / "data.jsonl"
    data.write_text("".join(json.dumps(r) + "\n" for r in [
        {"problem_id": f"p{i}", "name": f"p{i}", "category": "algebra",
         "informal_prefix": f"/-- Show {i} + 0 = {i}. -/\n",
         "formal_statement": f"theorem t{i} : {i} + 0 = {i} := by",
         "problem": f"Compute {i}.", "formal_proof": "trivial", "answer": str(i)}
        for i in range(3)]))
    m = tmp_path / "m.json"
    m.write_text(json.dumps([{"name": f"m{i}", "split": "test", "header": "",
                              "informal_statement": f"Show {i} = {i}.",
                              "formal_statement": f"theorem m{i} : {i} = {i} := by"}
                             for i in range(2)]))
    return data, m


@pytest.mark.parametrize("cli", ["chat", "bench", "minif2f", "infer_split"])
def test_cli_flags_reach_runner(tmp_path, monkeypatch, capsys, cli):
    """``--accel block-cache --parallel-threshold`` through each serving
    CLI's ``runner_from_args`` build a cached runner with the threshold; the
    CLI's main, each side on a runner with those settings over the same
    bridged weights, writes the same tokens as JAX's."""
    j_mod, t_mod = {"chat": (j_chat, t_chat), "bench": (j_bench_cli, t_bench_cli),
                    "minif2f": (j_minif2f_cli, t_minif2f_cli),
                    "infer_split": (j_infer, t_infer)}[cli]
    args = t_mod.build_parser().parse_args(
        FLAGS + ["--device", "cpu"] + {"chat": ["--prompt", "x"], "bench": [],
                                       "minif2f": ["--json-path", "m.json"],
                                       "infer_split": ["--dataset", "d"]}[cli])
    built = t_common.runner_from_args(args)
    assert built.cached_fns is not None and built.parallel_threshold == 0.04
    if cli in ("bench", "infer_split"):
        pytest.importorskip("datasets")     # their dataset loading

    jr, tr = _runners("llada-tiny", accel="block-cache", num_layers=2)
    jr.parallel_threshold = tr.parallel_threshold = 0.04
    ids = {"j": [], "t": []}
    for side, r in (("j", jr), ("t", tr)):
        one, batch = r.generate, r.generate_batch

        def rec_one(*a, _one=one, _side=side, **kw):
            res = _one(*a, **kw)
            ids[_side].append(np.asarray(res.token_ids)[None])
            return res

        def rec_batch(*a, _batch=batch, _side=side, **kw):
            res = _batch(*a, **kw)
            ids[_side].append(np.stack([np.asarray(x.token_ids) for x in res]))
            return res

        monkeypatch.setattr(r, "generate", rec_one)
        monkeypatch.setattr(r, "generate_batch", rec_batch)
    load = "_load_runner" if cli == "chat" else "runner_from_args"
    monkeypatch.setattr(j_mod, load, lambda a: jr)
    monkeypatch.setattr(t_mod, load, lambda a: tr)
    data, m = _cli_files(tmp_path)
    extra = {"chat": ["--prompt", "Prove that 1 + 1 = 2."],
             "bench": ["--style", "llada", "--dataset-path", str(data), "--max-samples",
                       "2", "--fake-lean", "--quiet", "--batch-size", "2"],
             "minif2f": ["--json-path", str(m), "--fake-lean", "--batch-size", "2"],
             "infer_split": ["--dataset", str(data), "--split", "test", "--num-samples",
                             "2"]}[cli]
    out_flag = {"chat": [], "bench": ["--results-dir"], "minif2f": ["--output-dir"],
                "infer_split": ["--save-dir"]}[cli]
    for side, mod, dev in (("j", j_mod, []), ("t", t_mod, ["--device", "cpu"])):
        where = [str(tmp_path / side)] if out_flag else []
        mod.main(FLAGS + TINY_GEN + extra + out_flag + where + dev)
    capsys.readouterr()
    assert len(ids["t"]) == len(ids["j"]) > 0
    for got, want in zip(ids["t"], ids["j"]):
        np.testing.assert_array_equal(got, want)
