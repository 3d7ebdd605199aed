"""The SDAR family of the port against the benchmark's plain reference
(``portbench/reference/sdar.py``), on the CPU, on ``sdar-tiny`` with seeded
random weights (norm gains drawn too, so the qk-norm is not the identity).

Tolerances: the port runs in float32 here (bf16 presets run in f32 off the
card) and so does the reference; they differ only in the order of sums
(the grouped experts' per-tile products, the attention's masked sums), in
the rotation's angle (the port's f32, the reference's f64 rounded to f32)
and in the reference's f32 weights being the port's own.  Each product's
rounding is ~1e-7 relative; through two layers and the head the logits
(magnitude ~1) agree to 2e-4, the port's parity tests' tolerance
(``tests/test_torch_port_model.py``).  The attention functions alone, one
product and one softmax, agree to 1e-5.
"""

import json

import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer
from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn
from ct_diffusionmodelbench_tpu_torch.models.config import config_from_hf
from ct_diffusionmodelbench_tpu_torch.models.sdar_cache import make_sdar_fns
from ct_diffusionmodelbench_tpu_torch.ops import attention as attn_ops
from ct_diffusionmodelbench_tpu_torch.ops.cache_attention import cache_attention_plain
from ct_diffusionmodelbench_tpu_torch.ops.flash_attention import flash_attention_plain
from ct_diffusionmodelbench_tpu_torch.sampling.schedule import get_num_transfer_tokens
from ct_diffusionmodelbench_tpu_torch.sampling.sdar import pad_to_blocks, sdar_generate
from ct_diffusionmodelbench_tpu_torch.utils.profiling import tracing
from portbench.reference import sdar as ref
from tests.torch_port_threads import one_torch_thread  # noqa: F401

LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
# The catalog row of JetLM/SDAR-30B-A3B-Chat: its config.json's keys.
SDAR_ROW = {"attention_bias": False, "decoder_sparse_step": 1, "head_dim": 128,
            "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 6144,
            "max_position_embeddings": 32768, "max_window_layers": 48,
            "mlp_only_layers": [], "model_type": "sdar_moe", "moe_intermediate_size": 768,
            "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
            "num_experts_per_tok": 8, "num_hidden_layers": 48, "num_key_value_heads": 4,
            "rms_norm_eps": 1e-06, "rope_scaling": None, "rope_theta": 1000000,
            "sliding_window": None, "tie_word_embeddings": False,
            "use_sliding_window": False, "vocab_size": 151936}
GAINS = ("attn_norm", "ffn_norm", "q_norm", "k_norm")


def tiny(seed=0, **over):
    """(cfg, params): sdar-tiny in f32 with every norm gain 1 + 0.2·normal."""
    cfg = get_config("sdar-tiny", dtype="float32", **over)
    params = init_params(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for name in GAINS:
        t = params["blocks"][name]
        t.add_(0.2 * torch.randn(t.shape, generator=g))
    params["final_norm"].add_(0.2 * torch.randn(params["final_norm"].shape, generator=g))
    return cfg, params


def sizes(cfg):
    """The reference's sizes dict of a port config."""
    return dict(vocab_size=cfg.vocab_size, num_layers=cfg.num_layers,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
                num_experts=cfg.num_experts, num_experts_per_tok=cfg.num_experts_per_tok,
                norm_topk_prob=cfg.norm_topk_prob,
                num_shared_experts=cfg.num_shared_experts, block_length=cfg.block_length)


def prompts(b=3, p=16, pads=(5, 2, 0), seed=7, vocab=400):
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(10, vocab, (b, p)))
    mask = torch.ones((b, p), dtype=torch.int32)
    for r, n in enumerate(pads[:b]):
        ids[r, :n] = 0
        mask[r, :n] = 0
    return ids, mask


def test_config_from_hf_reads_the_sdar_row():
    cfg = config_from_hf(SDAR_ROW, name="sdar")
    assert cfg.family == "sdar" and cfg.qk_norm and cfg.num_shared_experts == 0
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim) == (48, 2048, 32, 4, 128)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size,
            cfg.norm_topk_prob) == (128, 8, 768, True)
    assert (cfg.vocab_size, cfg.norm_eps, cfg.rope_theta, cfg.tie_embeddings,
            cfg.attention_bias, cfg.logit_shift) == (151936, 1e-6, 1000000, False, False,
                                                     False)
    assert cfg.block_length == 4 and config_from_hf(dict(SDAR_ROW, block_length=8)).block_length == 8
    preset = get_config("sdar-30b-a3b")
    for f in ("num_layers", "hidden_size", "num_heads", "num_kv_heads", "head_dim",
              "num_experts", "num_experts_per_tok", "moe_intermediate_size", "vocab_size",
              "qk_norm", "num_shared_experts", "norm_eps", "block_length"):
        assert getattr(cfg, f) == getattr(preset, f), f
    assert abs(preset.param_count() - 30.53e9) < 0.01e9
    # Every other family keeps block_length 0.
    assert config_from_hf({"model_type": "llada", "hidden_size": 64}).block_length == 0


def test_portbench_config_file_holds_the_row_unchanged():
    from pathlib import Path

    conf = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                       / "sdar-30b-a3b.json").read_text())
    assert {k: conf[k] for k in SDAR_ROW} == SDAR_ROW and conf["reduced"] == []
    cfg = config_from_hf(conf)
    assert (cfg.mask_token_id, cfg.block_length, cfg.family) == (151669, 4, "sdar")


@pytest.mark.parametrize("pads,bl", [((5, 2, 0), 4), ((0, 0, 0), 4), ((3, 7, 1), 2)],
                         ids=["left-padded", "unpadded", "blocks-of-2"])
def test_block_causal_forward_matches_reference(pads, bl):
    cfg, params = tiny(block_length=bl)
    ids, mask = prompts(pads=pads)
    logits, _ = make_forward_fn(cfg, device="cpu")(params, ids, mask)
    want = ref.block_logits(params, sizes(cfg), ids, mask, 0, ids.shape[1])
    keep = mask.bool()
    torch.testing.assert_close(logits[keep], want[keep], **LOGITS_TOL)


def test_block_causal_forward_sees_no_later_block():
    """Changing a later block leaves an earlier block's logits as they were;
    changing the same block moves them (both ways inside a block)."""
    cfg, params = tiny()
    ids, mask = prompts(pads=(0, 0, 0))
    fwd = make_forward_fn(cfg, device="cpu")
    base, _ = fwd(params, ids, mask)
    later = ids.clone()
    later[:, 12:] = 77
    got, _ = fwd(params, later, mask)
    torch.testing.assert_close(got[:, :12], base[:, :12], rtol=0, atol=0)
    inside = ids.clone()
    inside[:, 11] = 77
    got, _ = fwd(params, inside, mask)
    assert not torch.allclose(got[:, 8], base[:, 8])


def _committed_run(cfg, params, ids, mask, n_blocks, steps_per_block, seed=3):
    """Prefill, then per block steps on random states (a few masks each) and
    a commit of random final tokens: yields (state, block start, step
    logits) at every step."""
    prefill, step, commit = make_sdar_fns(cfg)
    bl = cfg.block_length
    ids, mask, _ = pad_to_blocks(ids, mask, bl)
    B, P = ids.shape
    cache = prefill(params, ids, mask, P + n_blocks * bl, int(mask.sum()))
    rng = np.random.default_rng(seed)
    seq = ids
    for k in range(n_blocks):
        start = P + k * bl
        for _ in range(steps_per_block):
            blk = torch.as_tensor(rng.integers(10, 400, (B, bl)))
            blk[torch.as_tensor(rng.random((B, bl)) < 0.5)] = cfg.mask_token_id
            yield torch.cat([seq, blk], dim=1), mask, start, step(params, cache, blk, start)
        final = torch.as_tensor(rng.integers(10, 400, (B, bl)))
        commit(params, cache, final, start)
        seq = torch.cat([seq, final], dim=1)


@pytest.mark.parametrize("pads", [(5, 2, 0), (1, 9, 4)])
def test_cached_steps_match_reference_full_forward(pads):
    """Prefill → cached steps → commits: each step's block logits equal the
    reference's full block-causal forward of the state (prompt, committed
    blocks, current block)."""
    cfg, params = tiny(seed=2)
    ids, mask = prompts(pads=pads, p=14)     # padded to 16 inside
    s = sizes(cfg)
    n = 0
    for state, pmask, start, logits in _committed_run(cfg, params, ids, mask, 3, 2):
        full = torch.cat([pmask, torch.ones((3, state.shape[1] - pmask.shape[1]),
                                            dtype=pmask.dtype)], dim=1)
        want = ref.block_logits(params, s, state, full, start, cfg.block_length)
        torch.testing.assert_close(logits, want, **LOGITS_TOL)
        n += 1
    assert n == 6


@pytest.mark.parametrize("pads", [(5, 2, 0), (0, 3, 1)])
def test_reference_packed_row_gives_each_state_its_own_forward(pads):
    """``ref.pack``: one row holding a prefix (prompt and committed blocks)
    and several states' blocks beside it gives each block the logits of its
    state's own full forward (the benchmark's check judges packed rows).
    Both sides are the f32 reference over different key sets; they differ
    in the order of sums only (LOGITS_TOL, as above)."""
    cfg, params = tiny(seed=6)
    s, bl, m = sizes(cfg), cfg.block_length, cfg.mask_token_id
    ids, mask = prompts(pads=pads)
    g = torch.Generator().manual_seed(9)
    committed = torch.randint(10, 400, (3, 3 * bl), generator=g)
    for r in range(3):
        prefix = torch.cat([ids[r], committed[r]])
        pmask = torch.cat([mask[r], torch.ones(3 * bl, dtype=mask.dtype)])
        blocks = []
        for k in (0, 2, 3, 3):           # the last start is the prefix's end
            blk = torch.randint(10, 400, (bl,), generator=g)
            blk[torch.rand(bl, generator=g) < 0.5] = m
            blocks.append((16 + k * bl, blk))
        row, pos, seen, offsets = ref.pack(prefix, pmask, blocks, bl)
        hidden = ref.final_hidden(params, s, row[None], None, seen=seen[None], pos=pos[None])
        for (start, blk), lo in zip(blocks, offsets):
            state = torch.cat([prefix[:start], blk])[None]
            smask = torch.cat([pmask[:start], torch.ones(bl, dtype=mask.dtype)])[None]
            want = ref.block_logits(params, s, state, smask, start, bl)[0]
            got = ref.linear(hidden[0, lo:lo + bl], params["lm_head"].float())
            torch.testing.assert_close(got, want, **LOGITS_TOL)


def test_runner_decodes_sdar_in_the_models_own_blocks():
    """The runner hands the sampler ``cfg.block_length``: left out, the
    decode is the one at the model's block length; another is refused
    (the model's attention is block-causal at its own)."""
    cfg, params = tiny(seed=4)
    ids, mask = prompts(pads=(5, 2, 0), p=14)
    runner = ModelRunner(cfg, params, Tokenizer.byte_fallback(cfg.vocab_size, 2),
                         device="cpu")
    kw = dict(attn_mask=mask.numpy(), gen_length=8, steps=4)
    np.testing.assert_array_equal(runner.generate_ids(ids.numpy(), **kw),
                                  runner.generate_ids(ids.numpy(), block_length=4, **kw))
    with pytest.raises(ValueError, match="blocks of 4"):
        runner.generate_ids(ids.numpy(), block_length=32, **kw)


def _reference_decode(cfg, params, ids, mask, gen_length, steps):
    """A plain loop over the reference's logits: each step the greedy token
    and its probability at the masked positions, the schedule's count of the
    most confident unmasked (ties to the lower index)."""
    s = sizes(cfg)
    bl, mask_id = cfg.block_length, cfg.mask_token_id
    spb = steps // (gen_length // bl)
    ids, mask, pad = pad_to_blocks(ids, mask, bl)
    B, P = ids.shape
    seq = ids
    per_step = get_num_transfer_tokens(torch.ones((B, bl), dtype=torch.bool), spb)
    for k in range(gen_length // bl):
        blk = torch.full((B, bl), mask_id, dtype=ids.dtype)
        for i in range(spb):
            state = torch.cat([seq, blk], dim=1)
            full = torch.cat([mask, torch.ones((B, state.shape[1] - P), dtype=mask.dtype)], 1)
            logits = ref.block_logits(params, s, state, full, state.shape[1] - bl, bl)
            probs = torch.softmax(logits, dim=-1)
            conf, tok = probs.max(dim=-1)
            conf = torch.where(blk == mask_id, conf, torch.full_like(conf, -1.0))
            for r in range(B):
                order = sorted(range(bl), key=lambda j: (-float(conf[r, j]), j))
                for j in order[:int(per_step[r, i])]:
                    blk[r, j] = tok[r, j]
        seq = torch.cat([seq, blk], dim=1)
    return seq[:, pad:]


def test_sampler_greedy_matches_a_loop_over_reference_logits():
    cfg, params = tiny(seed=4)
    ids, mask = prompts(pads=(5, 2, 0), p=14)
    tok = Tokenizer.byte_fallback(vocab_size=cfg.vocab_size, eos_token_id=2)
    runner = ModelRunner(cfg, params, tok, device="cpu")
    got = runner.generate_ids(ids.numpy(), attn_mask=mask.numpy(), gen_length=12,
                              steps=6, block_length=4)
    want = _reference_decode(cfg, params, ids, mask, 12, 6)
    np.testing.assert_array_equal(got, want.numpy())
    assert not (got[:, 14:] == cfg.mask_token_id).any()


def test_sampler_calls_the_model_only_through_block_fns():
    """The runner's ``block_fns`` is the sampler's only way to the model:
    wrapped, it sees the prefill, every step and every commit."""
    cfg, params = tiny()
    runner = ModelRunner(cfg, params, Tokenizer.byte_fallback(cfg.vocab_size, 2),
                         device="cpu")
    calls = []
    inner = runner.block_fns

    def wrap(name, fn):
        def call(*a):
            calls.append(name)
            return fn(*a)
        return call

    runner.block_fns = tuple(wrap(n, f) for n, f in zip(("prefill", "step", "commit"), inner))
    runner.forward_fn = None          # a sampler that used it would fail
    ids, mask = prompts()
    runner.generate_ids(ids.numpy(), attn_mask=mask.numpy(), gen_length=8, steps=8,
                        block_length=4)
    assert calls == ["prefill"] + (["step"] * 4 + ["commit"]) * 2


def test_decode_spans_and_counters():
    cfg, params = tiny()
    runner = ModelRunner(cfg, params, Tokenizer.byte_fallback(cfg.vocab_size, 2),
                         device="cpu")
    ids, mask = prompts(p=16, pads=(5, 2, 0))
    with tracing() as rec:
        runner.generate_ids(ids.numpy(), attn_mask=mask.numpy(), gen_length=12,
                            steps=6, block_length=4)
    c = rec.counters
    assert (c["sdar.steps"], c["sdar.commits"], c["model.forward"]) == (6, 3, 10)
    real = int(mask.sum())
    # Every step and commit of block k reads each row's real prompt, the k
    # committed blocks and its own block.
    keys = sum(3 * (16 + 4 * (k + 1)) - (3 * 16 - real) for k in range(3)) * 3
    assert c["cache.keys"] == keys
    assert c["cache.queries"] == 9 * 3 * 4 and c["cache.pairs"] == 4 * keys
    by_name = {}
    for sp in rec.spans:
        by_name.setdefault(sp.name, []).append(sp)
    assert [len(by_name[n]) for n in ("sdar.prefill", "sdar.step", "sdar.commit")] == [1, 6, 3]
    for sp in by_name["model.forward"]:
        assert rec.spans[sp.parent].name in ("sdar.prefill", "sdar.step", "sdar.commit")


def test_k12_plain_matches_reference_attention():
    """K12's plain twin, with left padding and a partial cache (garbage past
    n_keys and in the padding), against the reference's attention of the
    block's queries over exactly the row's real keys."""
    g = torch.Generator().manual_seed(5)
    B, S, bl, H, KV, Dh = 3, 40, 4, 8, 2, 16
    q = torch.randn((B, bl, H, Dh), generator=g)
    k = torch.randn((B, S, KV, Dh), generator=g)
    v = torch.randn((B, S, KV, Dh), generator=g)
    start = torch.tensor([3, 0, 11], dtype=torch.int32)
    n_keys = 28
    got = cache_attention_plain(q, k, v, start, torch.tensor([n_keys], dtype=torch.int32))
    for b in range(B):
        kb, vb = k[b:b + 1, :n_keys], v[b:b + 1, :n_keys]
        seen = torch.zeros((1, bl, n_keys), dtype=torch.bool)
        seen[:, :, int(start[b]):] = True
        qs = torch.zeros((1, n_keys, H, Dh))
        qs[:, n_keys - bl:] = q[b:b + 1]
        full_seen = torch.zeros((1, n_keys, n_keys), dtype=torch.bool)
        full_seen[:, n_keys - bl:] = seen
        full_seen[:, :n_keys - bl, 0] = True       # rows not compared
        want = ref.attention(qs, kb, vb, full_seen)[:, n_keys - bl:]
        torch.testing.assert_close(got[b:b + 1], want, **ATTN_TOL)


@pytest.mark.parametrize("bl,pads", [(4, (5, 0)), (2, (9, 3)), (64, (70, 0))])
def test_block_causal_prefill_twin_matches_reference_attention(bl, pads):
    """The flash kernel's plain twin in its block-causal mode, and the
    port's reference attention in that mode, against the benchmark
    reference's, at the real query rows of left-padded rows."""
    g = torch.Generator().manual_seed(bl)
    B, S, H, KV, Dh = 2, 130, 4, 2, 16
    q = torch.randn((B, S, H, Dh), generator=g)
    k = torch.randn((B, S, KV, Dh), generator=g)
    v = torch.randn((B, S, KV, Dh), generator=g)
    mask = torch.ones((B, S), dtype=torch.int32)
    for r, n in enumerate(pads):
        mask[r, :n] = 0
    want = ref.attention(q, k, v, ref.visible(mask, bl))
    keep = mask.bool()
    for got in (flash_attention_plain(q, k, v, mask=mask, block_len=bl),
                attn_ops.attention_reference(q, k, v, mask=mask, block_len=bl)):
        torch.testing.assert_close(got[keep], want[keep], **ATTN_TOL)
        assert torch.isfinite(got).all()


def test_sampler_refuses_what_sdar_does_not_do():
    cfg, params = tiny()
    fns = make_sdar_fns(cfg)
    ids, mask = prompts()
    with pytest.raises(ValueError):
        sdar_generate(fns, params, ids, gen_length=10, block_length=4, steps=5,
                      mask_id=cfg.mask_token_id, device="cpu")
    with pytest.raises(NotImplementedError):
        sdar_generate(fns, params, ids, gen_length=8, block_length=4, steps=4,
                      mask_id=cfg.mask_token_id, remasking="random", device="cpu")
    with pytest.raises(NotImplementedError):
        ModelRunner(cfg, params, Tokenizer.byte_fallback(cfg.vocab_size, 2),
                    accel="block-cache", device="cpu")
