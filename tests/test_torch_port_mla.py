"""Latent attention (DeepSeek-V3's layers, kanana-2-30B-A3B) in the port
against the benchmark's plain reference (``portbench/reference/kanana.py``),
on the CPU, at a tiny size: D 64, 4 heads, latent 32, rope 16, nope 32, v
32, 8 experts top-2 with one shared, layer 0 dense, seeded random weights
drawn by the harness (``portbench/harness/mla_check.py``: norm gains drawn
too, the routers' selection bias large enough to change selections, the
rope columns in the published interleaved order, which the program moves
to its own halves when it loads them).

Tolerances: the port runs in float32 here (bf16 configs run in f32 off the
card) and so does the reference; they differ in the order of sums (the
grouped experts' tiles, the attention's masked sums, the absorbed form's
products taken in another order than the up-projected one), in the
rotation's angle (the port's f32, the reference's f64 rounded to f32) and
in the rotation's form (the port's halves on permuted weights, the
reference's interleaved pairs).  Each is ~1e-7 relative; through three
layers and the head the logits (magnitude ~4) agree to 2e-4, the port's
parity tests' tolerance (``tests/test_torch_port_sdar.py``); one attention
call agrees to 1e-5.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer
from ct_diffusionmodelbench_tpu_torch.models import mla
from ct_diffusionmodelbench_tpu_torch.models.config import config_from_hf, get_config
from ct_diffusionmodelbench_tpu_torch.models.sdar_cache import (
    forward_block, forward_prefill, make_sdar_fns, new_cache)
from ct_diffusionmodelbench_tpu_torch.models.transformer import forward
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
from ct_diffusionmodelbench_tpu_torch.ops import mla_attention as ma
from ct_diffusionmodelbench_tpu_torch.utils.profiling import tracing
from portbench.harness import cells, mla_check, peaks
from portbench.harness.runtime import run_cell
from portbench.reference import kanana as ref
from portbench.tests.tiny import base
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
# The catalog row of kakaocorp/kanana-2-30b-a3b-instruct-2601: its
# config.json's keys.
KANANA_ROW = {
    "attention_bias": False, "first_k_dense_replace": 1, "head_dim": 64, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 6144, "kv_lora_rank": 512,
    "max_position_embeddings": 32768, "model_type": "deepseek_v3",
    "moe_intermediate_size": 768, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 128,
    "n_shared_experts": 2, "norm_topk_prob": True, "num_attention_heads": 32,
    "num_experts_per_tok": 6, "num_hidden_layers": 48, "num_key_value_heads": 32,
    "q_lora_rank": None, "qk_head_dim": 192, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06, "rope_interleave": True, "rope_scaling": None,
    "rope_theta": 1000000, "routed_scaling_factor": 2.448, "scoring_func": "sigmoid",
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "noaux_tc",
    "v_head_dim": 128, "vocab_size": 128256}
TINY = dict(KANANA_ROW, name="mla-tiny", vocab_size=512, hidden_size=64, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, head_dim=16, kv_lora_rank=32,
            qk_nope_head_dim=32, qk_rope_head_dim=16, qk_head_dim=48, v_head_dim=32,
            intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=1, rope_theta=10000.0,
            max_position_embeddings=512, mask_token_id=500, eos_token_id=2,
            torch_dtype="bfloat16", block_length=4, e_score_correction_bias_scale=0.1,
            reduced=[], assumed=[])
TINY_MIX = {"kind": "mla_decode", "why": "tiny", "batch": 3,
            "prompt_strata": [[10, 20], [21, 40], [41, 46]],
            "id_range": [10, 400], "bucket": 48, "runner": {},
            "generate": {"gen_length": 16, "steps": 16, "block_length": 4,
                         "temperature": 0.0, "remasking": "low_confidence"},
            "check": {"requests": 2, "steps_per_request": 5}}
# The program and the reference are both float32 on the CPU: a sound run
# agrees to rounding, far inside these.
TINY_LIMITS = {"limits": {"token_gap_mean": 1e-3, "order_gap_mean": 1e-3,
                          "route_flip_share": 1e-3}}
NEW = ("mla_cache_attn_roofline.decode", "mla_prefill_roofline.decode")


def tiny(seed=3):
    """(cfg, sizes, published weights, the program's weights)."""
    s = mla_check.sizes(TINY)
    cfg = config_from_hf(TINY, name="mla-tiny").replace(dtype="float32")
    w = mla_check.draw_weights(s, seed, torch.device("cpu"))
    return cfg, s, w, mla.interleaved_to_halves(cfg, w)


def prompts(b=2, p=16, pads=(5, 0), seed=0):
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(10, 400, (b, p)))
    mask = torch.ones((b, p), dtype=torch.int32)
    for r, n in enumerate(pads[:b]):
        ids[r, :n] = 0
        mask[r, :n] = 0
    return ids, mask


def ones(b, n):
    return torch.ones((b, n), dtype=torch.int32)


def test_config_from_hf_reads_catalog_row():
    cfg = config_from_hf(dict(KANANA_ROW, block_length=4), name="kanana")
    assert cfg.family == "sdar" and cfg.is_mla and not cfg.qk_norm
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == (
        512, 128, 64, 128)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.num_shared_experts) == (128, 6, 2)
    assert (cfg.scoring_func, cfg.routed_scaling_factor) == ("sigmoid", 2.448)
    assert cfg.dense_layers == 1 and cfg.rope_interleave and cfg.rope_dim == 64
    assert cfg.qk_head_dim == KANANA_ROW["qk_head_dim"]
    assert cfg.param_count() == 30_670_815_104
    assert cfg == get_config("kanana-2-30b-a3b").replace(name="kanana", mask_token_id=None,
                                                         eos_token_id=None)


@pytest.mark.parametrize("change,match", [
    ({"block_length": None}, "block_length"),
    ({"q_lora_rank": 1536}, "q_lora_rank"),
    ({"n_group": 8}, "n_group"),
], ids=["no-block-length", "q-lora", "groups"])
def test_config_from_hf_refuses_what_the_port_does_not_run(change, match):
    conf = dict(KANANA_ROW, block_length=4)
    conf.update(change)
    with pytest.raises(NotImplementedError, match=match):
        config_from_hf(conf)


def test_config_file_holds_catalog_row():
    conf = json.loads((REPO / "portbench" / "configs" / "kanana-2-30b-a3b.json").read_text())
    assert {k: conf[k] for k in KANANA_ROW} == KANANA_ROW
    assert conf["reduced"] == [] and conf["source"].startswith(
        "https://huggingface.co/kakaocorp/kanana-2-30b-a3b-instruct-2601")
    assert any("block diffusion" in a for a in conf["assumed"])
    bench = cells.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "kanana-2-30b-a3b")
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/kanana-2-30b-a3b.json"


@pytest.mark.parametrize("pads", [(0, 0), (5, 2)], ids=["unpadded", "left-padded"])
def test_cached_decode_matches_reference(pads):
    """A prefill, then a step, a commit and a step of the next block, each
    step's logits against the reference's full forward of its state."""
    cfg, s, w, params = tiny()
    ids, mask = prompts(pads=pads)
    B, P = ids.shape
    prefill, step, commit = make_sdar_fns(cfg)
    cache = prefill(params, ids, mask, P + 8, int(mask.sum()))
    blk = torch.full((B, 4), 500)
    blk[:, 1] = 77
    got = step(params, cache, blk, P)
    want = ref.logits(w, s, torch.cat([ids, blk], 1), torch.cat([mask, ones(B, 4)], 1))
    torch.testing.assert_close(got, want[:, P:], **LOGITS_TOL)
    done = torch.randint(10, 400, (B, 4), generator=torch.Generator().manual_seed(1))
    commit(params, cache, done, P)
    got = step(params, cache, blk, P + 4)
    want = ref.logits(w, s, torch.cat([ids, done, blk], 1), torch.cat([mask, ones(B, 8)], 1))
    torch.testing.assert_close(got, want[:, P + 4:], **LOGITS_TOL)


def test_absorbed_matches_up_projected():
    """The cached step's absorbed form against the full forward's
    up-projected one, on the same state."""
    cfg, _, _, params = tiny(seed=4)
    ids, mask = prompts(pads=(3, 0))
    B, P = ids.shape
    cache = new_cache(cfg, B, P + 4, torch.float32, "cpu")
    forward_prefill(cfg, params, ids, mask, cache, int(mask.sum()))
    blk = torch.full((B, 4), 500)
    blk[:, 2] = 123
    cache.start.fill_(P)
    got = forward_block(cfg, params, blk, cache, absorbed=mla.Absorbed(cfg)(params))
    want = forward(cfg, params, torch.cat([ids, blk], 1), torch.cat([mask, ones(B, 4)], 1),
                   logit_start=P, logit_length=4)[0]
    torch.testing.assert_close(got, want, **LOGITS_TOL)


def test_row_by_row_prefill_equals_whole_batch(monkeypatch):
    from ct_diffusionmodelbench_tpu_torch.models import sdar_cache

    cfg, _, _, params = tiny(seed=5)
    ids, mask = prompts(b=3, p=20, pads=(7, 0, 2))
    B, P = ids.shape
    caches = []
    for tokens, rows in ((P, 1), (10 * B * P, B)):     # a row a group, then the whole batch
        monkeypatch.setattr(sdar_cache, "PREFILL_TOKENS", tokens)
        assert sdar_cache.prefill_rows(cfg, B, P) == rows
        cache = new_cache(cfg, B, P, torch.float32, "cpu")
        forward_prefill(cfg, params, ids, mask, cache, int(mask.sum()))
        caches.append(cache)
    assert torch.equal(caches[0].key_start, caches[1].key_start)
    torch.testing.assert_close(caches[0].lat, caches[1].lat, rtol=1e-6, atol=1e-6)
    assert torch.equal(caches[0].routes, caches[1].routes)


def test_cache_keeps_the_routes_the_reference_chooses():
    """The prefill's and a step's chosen experts, as the cache keeps them,
    are the reference's own choices on the same state (both f32 here)."""
    cfg, s, w, params = tiny(seed=6)
    ids, mask = prompts(pads=(5, 0))
    B, P = ids.shape
    prefill, step, _ = make_sdar_fns(cfg)
    cache = prefill(params, ids, mask, P + 4, int(mask.sum()))
    assert cache.routes.shape == (2, B, P + 4, 2) and cache.routes.dtype == torch.uint8
    blk = torch.full((B, 4), 500)
    blk[:, 3] = 9
    step(params, cache, blk, P)
    full = torch.cat([mask, ones(B, 4)], 1).bool()
    for r in range(B):
        chosen = cache.routes[:, r].long()
        route = ref.Route(chosen)
        ref.final_hidden(w, s, torch.cat([ids, blk], 1)[r:r + 1], full[r:r + 1].int(),
                         route=route)
        own = torch.stack(route.own)
        assert mla_check.route_misses(chosen, own, full[r]) == 0
        assert torch.equal(chosen[:, full[r]], own[:, full[r]])


def test_pinned_routes_steer_the_reference():
    """Pinned to its own choices the reference is unchanged; pinned to
    others its output moves, and it still reports its own choices."""
    cfg, s, w, _ = tiny(seed=7)
    ids, mask = prompts(b=1, pads=(0,))
    free = ref.Route()
    want = ref.final_hidden(w, s, ids, mask, route=free)      # its own choices
    own = torch.stack(free.own)
    torch.testing.assert_close(ref.final_hidden(w, s, ids, mask), want, rtol=0, atol=0)
    same = ref.Route(own)
    torch.testing.assert_close(ref.final_hidden(w, s, ids, mask, route=same), want,
                               rtol=0, atol=0)
    other = ref.Route((own + 1) % 8)
    moved = ref.final_hidden(w, s, ids, mask, route=other)
    assert (moved - want).abs().max() > 1e-2
    assert torch.equal(other.own[0], own[0])                  # layer 1: same input, same choice
    real = torch.ones(ids.shape[1], dtype=torch.bool)
    assert mla_check.route_misses(own, (own + 1) % 8, real) > 0


def test_route_misses_count_by_hand():
    chosen = torch.tensor([[[0, 1], [2, 3], [4, 5]]])           # [L 1, S 3, K 2]
    judge = torch.tensor([[[1, 0], [2, 7], [6, 7]]])
    real = torch.tensor([True, True, False])
    assert mla_check.route_misses(chosen, judge, real) == 1    # expert 3 at position 1


def test_prefill_rows_follow_the_token_budget():
    cfg = get_config("kanana-2-30b-a3b")
    from ct_diffusionmodelbench_tpu_torch.models.sdar_cache import prefill_rows
    assert prefill_rows(cfg, 4, 32512) == 1          # kanana30b-ctx32k: a row at a time
    assert prefill_rows(cfg, 32, 576) == 32
    sdar = get_config("sdar-30b-a3b")                 # one budget for every family
    assert prefill_rows(sdar, 32, 576) == 32          # sdar30b-eval: the whole batch
    assert prefill_rows(sdar, 4, 32512) == 1


def _chain(logits, k, bias, scale):
    """DeepSeek-V3's router written from its description, for the test."""
    scores = torch.sigmoid(logits)
    order = sorted(range(logits.shape[1]), key=lambda e: (-float(scores[0, e] + bias[e]), e))
    idx = torch.tensor([order[:k]])
    w = scores.gather(-1, idx)
    return (w / (w.sum() + 1e-20)) * scale, idx


def test_sigmoid_router_bias_changes_selections_and_matches_the_chain():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((256, 8), generator=g)
    bias = 0.3 * torch.randn((8,), generator=g)
    w, idx, scores = gg.router_topk_plain(logits, 2, True, sigmoid=True, bias=bias, scale=2.448)
    _, idx0, _ = gg.router_topk_plain(logits, 2, True, sigmoid=True, scale=2.448)
    assert (idx != idx0).any(dim=-1).sum() > 10          # the bias changes selections
    assert (w.sum(-1) - 2.448).abs().max() < 1e-5
    torch.testing.assert_close(scores, torch.sigmoid(logits))
    for n in range(0, 256, 37):
        want_w, want_i = _chain(logits[n:n + 1], 2, bias, 2.448)
        assert torch.equal(idx[n:n + 1], want_i)
        torch.testing.assert_close(w[n:n + 1], want_w)


def test_sigmoid_router_ties_go_to_the_lowest_expert():
    logits = torch.tensor([[0.5, 1.0, 1.0, 0.5, 1.0, -1.0]])
    w, idx, _ = gg.router_topk_plain(logits, 3, True, sigmoid=True, scale=1.0)
    assert idx.tolist() == [[1, 2, 4]]
    bias = torch.tensor([0.0, 0.0, 0.0, 0.0, -0.2, 0.0])
    _, idx, _ = gg.router_topk_plain(logits, 3, True, sigmoid=True, bias=bias, scale=1.0)
    assert idx.tolist() == [[1, 2, 0]]                   # 0 and 3 tie: 0 first
    torch.testing.assert_close(w, torch.full((1, 3), 1 / 3))


def test_spans_and_counters_appear():
    cfg, _, w, _ = tiny()
    runner = ModelRunner(cfg, w, Tokenizer.byte_fallback(vocab_size=512, eos_token_id=2),
                         prompt_bucket=4, device="cpu")
    ids, mask = prompts(p=16, pads=(6, 0))
    with tracing() as rec:
        runner.generate_ids(ids, attn_mask=mask, gen_length=8, steps=8, block_length=4)
    names = {sp.name for sp in rec.spans}
    assert {"sdar.prefill", "sdar.step", "sdar.commit", "model.forward", "model.attn",
            "model.ffn"} <= names
    c = rec.counters
    assert c["sdar.steps"] == 8 and c["sdar.commits"] == 2
    lengths = mask.sum(-1).tolist()
    assert c["mla.prefill_pairs"] == mla.prefill_pairs(lengths, 16, 4)
    assert c["mla.prefill_queries"] == sum(lengths)
    # Steps and commits of two blocks, the keys read from each row's first real one.
    keys = [sum(16 + 4 * (k + 1) - (16 - n) for n in lengths) for k in range(2)]
    assert c["mla.keys"] == 5 * keys[0] + 5 * keys[1]
    assert c["mla.queries"] == 10 * 2 * 4 and c["mla.pairs"] == 4 * c["mla.keys"]
    assert "cache.keys" not in c                         # K12's counters keep meaning K12


def test_prefill_pairs_count_the_real_block_causal_pairs():
    mask = torch.tensor([[0] * 7 + [1] * 13, [1] * 20])
    ranges = ref.prefix_ranges(mask, 4)
    keys = torch.arange(20)
    seen = (keys >= ranges[..., :1]) & (keys < ranges[..., 1:2])         # real keys only
    real_q = mask.bool()[..., None]
    assert mla.prefill_pairs([13, 20], 20, 4) == int((seen & real_q).sum())


def test_plain_prefill_attention_matches_reference():
    g = torch.Generator().manual_seed(2)
    B, S, H = 2, 22, 3
    q, k = torch.randn((2, B, S, H, 12), generator=g)
    v = torch.randn((B, S, H, 8), generator=g)
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[0, :9] = 0
    start = mla.key_starts(mask, B, S, "cpu")
    got = ma.mla_prefill_attention_plain(q, k, v, start, 4, 12 ** -0.5)
    want = ref.attention(q, k, v, ref.prefix_ranges(mask, 4), 12 ** -0.5)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], **ATTN_TOL)
    # A padded query in a block before the row's first real key sees nothing.
    assert torch.equal(got[0, :8], torch.zeros_like(got[0, :8]))


def test_plain_cache_attention_matches_up_projected_reference():
    """K13's plain twin on the absorbed inputs against the reference's
    attention over up-projected keys and values."""
    cfg, _, _, params = tiny(seed=6)
    g = torch.Generator().manual_seed(3)
    B, S, bl, H = 2, 14, 4, cfg.num_heads
    n, p, r, v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank, cfg.v_head_dim
    q = torch.randn((B, bl, H, n + p), generator=g)
    cache = torch.randn((B, S, r + p), generator=g)
    start = torch.tensor([3, 0], dtype=torch.int32)
    end = torch.tensor([S], dtype=torch.int32)
    uk, uv = (t[0] for t in mla.absorbed_weights(cfg, params["blocks"]["wkv_b"]))
    got = mla.absorbed_attention(cfg, q, q[..., n:], cache, start, end, uk, uv)
    kv = (cache[..., :r] @ params["blocks"]["wkv_b"][0]).view(B, S, H, n + v)
    keys = torch.cat([kv[..., :n], cache[:, :, None, r:].expand(B, S, H, p)], dim=-1)
    qs = torch.zeros((B, S, H, n + p))
    qs[:, S - bl:] = q
    ranges = torch.zeros((B, S, 4), dtype=torch.long)
    ranges[..., 0] = start.long()[:, None]
    ranges[..., 1] = S
    want = ref.attention(qs, keys, kv[..., n:], ranges, (n + p) ** -0.5)[:, S - bl:]
    torch.testing.assert_close(got, want, **ATTN_TOL)


def test_interleave_moves_only_the_rope_columns():
    cfg, _, w, params = tiny()
    n, p, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    wq, wq2 = (t["blocks"]["wq"].view(3, 64, 4, n + p) for t in (w, params))
    assert torch.equal(wq[..., :n], wq2[..., :n])
    assert torch.equal(wq2[..., n:n + p // 2], wq[..., n::2])
    assert torch.equal(wq2[..., n + p // 2:], wq[..., n + 1::2])
    wkv_a, wkv_a2 = w["blocks"]["wkv_a"], params["blocks"]["wkv_a"]
    assert torch.equal(wkv_a2[..., r + p // 2:], wkv_a[..., r + 1::2])
    assert params["blocks"]["wkv_b"] is w["blocks"]["wkv_b"]          # shared, not copied
    assert not torch.equal(params["blocks"]["wq"], w["blocks"]["wq"])  # the input is left


def mla_base(tmp_path):
    """The harness's copy with the tiny latent-attention cell
    ``tiny-mla-eval`` listed wherever ``kanana30b-ctx32k`` is."""
    pb = base(tmp_path)
    (pb / "configs" / "mla-tiny.json").write_text(json.dumps(TINY))
    (pb / "traffic" / "tiny-mla-eval.json").write_text(json.dumps(TINY_MIX))
    (pb / "workloads" / "tiny-mla-eval.json").write_text(json.dumps(TINY_LIMITS))
    bench = json.loads((pb.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mla-tiny", "source": "tests",
                             "file": "portbench/configs/mla-tiny.json", "reduced": [],
                             "why": "tiny"})
    bench["workloads"].append({"name": "tiny-mla-eval", "config": "mla-tiny",
                               "traffic": "tiny-mla-eval", "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "kanana30b-ctx32k" in m.get("workloads", []):
            m["workloads"].append("tiny-mla-eval")
    (pb.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    return pb


def test_the_kanana_cell_lists_its_metrics():
    cell = cells.cell("kanana30b-ctx32k")
    assert cell.chips == 1 and cell.traffic["kind"] == "mla_decode"
    assert [m["name"] for m in cell.end_to_end] == ["decode_tokens_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == set(NEW) | {
        "idle_share.decode", "denoise_step_ms.decode", "commit_share.decode",
        "grouped_ffn_roofline.dsv3.decode", "dense_gemm_roofline.dsv3.decode"}
    mix = cell.traffic
    assert mix["batch"] == len(mix["prompt_strata"]) == 4
    assert mix["bucket"] + mix["generate"]["gen_length"] == 32768


@pytest.mark.parametrize("trace", [0, 1], ids=["window", "traced"])
def test_tiny_mla_cell_end_to_end(tmp_path, trace):
    pb = mla_base(tmp_path)
    cell = cells.cell("tiny-mla-eval", base=pb)
    out = run_cell(cell, seed=2**31 + 11, seconds=0.5, trace=bool(trace),
                   device=torch.device("cpu"), t0=0.0, base=pb)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert set(out["checks"]) == {"structure", "token_gap_mean", "order_gap_mean",
                                  "route_flip_share"}
    if not trace:
        assert set(out["metrics"]) == {"decode_tokens_per_s", "setup_s"}


def test_the_check_catches_a_router_that_drops_the_bias(tmp_path, monkeypatch):
    """The reference follows the program's experts, so the gaps cannot see
    a wrong choice; ``route_flip_share`` does."""
    from ct_diffusionmodelbench_tpu_torch.models import moe

    chain = moe.router_topk
    monkeypatch.setattr(moe, "router_topk",
                        lambda logits, k, norm, sigmoid=False, bias=None, scale=1.0:
                        chain(logits, k, norm, sigmoid=sigmoid, bias=None, scale=scale))
    pb = mla_base(tmp_path)
    out = run_cell(cells.cell("tiny-mla-eval", base=pb), seed=2**31 + 11, seconds=0.2,
                   trace=False, device=torch.device("cpu"), t0=0.0, base=pb)
    assert not out["correct"]
    assert out["checks"]["route_flip_share"]["value"] > 0.02


def test_balanced_draws_keep_each_stratum_uniform_and_the_windows_even():
    """Each prompt stays in its stratum and uniform over it; every batch
    holds the same tokens, and three in a row nearly the same squares, from
    seed to seed, as independent draws do not."""
    from portbench.drivers import mla_decode
    from portbench.harness import traffic

    mix = cells.cell("kanana30b-ctx32k").traffic
    strata = mix["prompt_strata"]
    fractions = [[] for _ in strata]
    windows = {"balanced": [], "independent": []}
    for seed in range(200):
        for name, draw in (("balanced", mla_decode.prompt_batches),
                           ("independent", traffic.prompt_batches)):
            gen = draw(mix, 2**31 + seed, 128255)
            batches = [next(gen) for _ in range(3)]
            windows[name].append(sum(sum(b.lengths) for b in batches))
            if name == "balanced":
                for b in batches:
                    assert b.ids.shape == (4, 32512) and (b.ids != 128255).all()
                    for n in b.lengths:
                        s = next(i for i, (lo, hi) in enumerate(strata) if lo <= n <= hi)
                        lo, hi = strata[s]
                        fractions[s].append((n - lo) / (hi - lo + 1))
    assert sorted(len(f) for f in fractions) == [600] * 4       # one a stratum a batch
    for f in fractions:                                          # uniform: every tenth filled
        counts = np.histogram(f, bins=10, range=(0, 1))[0]
        assert counts.min() > 35 and counts.max() < 85
    assert np.std(windows["balanced"]) < 0.1 * np.std(windows["independent"])
    gen = mla_decode.prompt_batches(mix, 2**31 + 9, 128255)
    assert len({sum(next(gen).lengths) for _ in range(7)}) <= 2      # one total, ±1 token
    again = next(mla_decode.prompt_batches(mix, 2**31 + 5, 128255))
    assert again.lengths == next(mla_decode.prompt_batches(mix, 2**31 + 5, 128255)).lengths


def test_driver_stops_at_once_without_latent_attention(tmp_path, monkeypatch):
    """A program whose config reads no latent attention (as before it had
    any) stops the run before a weight is drawn."""
    from ct_diffusionmodelbench_tpu_torch.models import config as cfg_mod

    pb = mla_base(tmp_path)
    cell = cells.cell("tiny-mla-eval", base=pb)
    monkeypatch.setattr(cfg_mod, "config_from_hf",
                        lambda conf, name="": get_config("sdar-tiny"))
    monkeypatch.setattr(mla_check, "draw_weights",
                        lambda *a, **k: pytest.fail("weights drawn"))
    with pytest.raises(SystemExit, match="latent attention"):
        run_cell(cell, seed=1, seconds=0.1, trace=False, device=torch.device("cpu"), t0=0.0,
                 base=pb)


class _Slice:
    def __init__(self, kernels):
        self.kernels = kernels

    def seconds(self, *names):
        return sum(s for k, s in self.kernels.items() if any(n in k for n in names))


class _Spans:
    def __init__(self, counters):
        self.counters = counters


class _Run:
    def __init__(self, counters, kernels):
        self.slice = _Slice(kernels)
        self.span_slice = _Spans(counters)
        self.peaks = peaks.peaks("NVIDIA H100 80GB HBM3")
        self.cell = cells.cell("kanana30b-ctx32k")


def test_mla_readers_count_by_hand():
    conf = cells.cell("kanana30b-ctx32k").config
    h100 = peaks.peaks("NVIDIA H100 80GB HBM3")
    k13 = cells.reader("mla_cache_attn_roofline.decode")
    counters = {"mla.keys": 100_000, "mla.queries": 16, "mla.pairs": 400_000}
    flops = 2 * 400_000 * 32 * (576 + 512)
    moved = 2 * (100_000 * 576 + 16 * 32 * (576 + 512))
    least = 48 * max(flops / h100["bf16"], moved / h100["bytes"])
    assert k13.least_seconds(conf, counters, h100) == pytest.approx(least)
    run = _Run(counters, {"void mla_latent_attn_kernel(...)": 2 * least,
                          "void mla_latent_merge_kernel(...)": 0.0,
                          "void cache_attn_kernel<128>(...)": 5.0})
    assert k13.read(run) == pytest.approx(50.0)
    pre = cells.reader("mla_prefill_roofline.decode")
    counters = {"mla.prefill_pairs": 10**9, "mla.prefill_queries": 50_000}
    flops = 2 * 10**9 * 32 * (192 + 128)
    least = 48 * max(flops / h100["bf16"], 2 * 50_000 * 32 * 2 * 320 / h100["bytes"])
    assert pre.least_seconds(conf, counters, h100) == pytest.approx(least)
    run = _Run(counters, {"void mla_prefill_kernel<192, 128>(...)": 4 * least})
    assert pre.read(run) == pytest.approx(25.0)
    # A program without the counters (the parent's) reads nothing.
    assert k13.read(_Run({}, {})) is None and pre.read(_Run({}, {})) is None


def test_dsv3_readers_count_by_hand():
    """The DeepSeek-V3 readers of the expert kernels and the library
    products, from the file's own keys."""
    from portbench.harness.runtime import Call

    conf = cells.cell("kanana30b-ctx32k").config
    h100 = peaks.peaks("NVIDIA H100 80GB HBM3")
    calls = [Call((20000, 30000), 0), Call((4, 4), 4), Call((4, 4), 0)]
    ffn = cells.reader("grouped_ffn_roofline.dsv3.decode")
    want = 0.0
    for n in (50000, 8, 8):
        flops = 6.0 * n * 6 * 2048 * 768
        moved = 2 * (2.0 * n * 2048 + 128 * (1 - (1 - 6 / 128) ** n) * 3.0 * 2048 * 768)
        want += max(flops / h100["bf16"], moved / h100["bytes"])
    assert ffn.least_seconds(conf, calls, h100) == pytest.approx(47 * want)
    dense = cells.reader("dense_gemm_roofline.dsv3.decode")

    def prod(m, k, n, peak, i=2, o=2):
        return max(2.0 * m * k * n / peak, (i * (m * k + k * n) + o * m * n) / h100["bytes"])

    bf, f32 = h100["bf16"], h100["f32"]
    want = 0.0
    for n, rows, head, up in ((50000, 2, 0, True), (8, 2, 4, False), (8, 2, 0, False)):
        layer = prod(n, 2048, 32 * 192, bf) + prod(n, 2048, 576, bf) + prod(n, 4096, 2048, bf)
        layer += (prod(n, 512, 32 * 256, bf) if up
                  else 32 * (prod(n, 128, 512, bf) + prod(n, 512, 128, bf)))
        moe = prod(n, 2048, 128, f32, 4, 4) + prod(n, 2048, 3072, bf) + prod(n, 1536, 2048, bf)
        ffn1 = prod(n, 2048, 12288, bf) + prod(n, 6144, 2048, bf)
        want += 48 * layer + ffn1 + 47 * moe + prod(rows * head, 2048, 128256, bf, 2, 4)
    assert dense.least_seconds(conf, calls, h100) == pytest.approx(want)

    class Run:
        slice = _Slice({"nvjet_tss_64x8": 2 * want, "void mla_latent_attn_kernel(...)": 9.0,
                        "void grouped_gemm_kernel<1>(...)": 3.0})
        slice_calls = calls
        peaks = h100
        cell = cells.cell("kanana30b-ctx32k")

    Run.slice.seconds = lambda *names, exclude=(): sum(
        s for k, s in Run.slice.kernels.items()
        if any(n in k for n in names) and not any(e in k for e in exclude))
    assert dense.read(Run) == pytest.approx(50.0)
    assert ffn.read(Run) == pytest.approx(100.0 * ffn.least_seconds(conf, calls, h100) / 3.0)
    Run.cell = cells.cell("sdar30b-eval")                  # another family's file: nothing
    assert dense.read(Run) is None and ffn.read(Run) is None


def test_forward_flops_count_latent_attention():
    """The analytic FLOPs: linear in the positions but for the up-projected
    attention's S² term, and the leading dense layer's FFN apart."""
    cfg = get_config("kanana-2-30b-a3b")
    f = lambda n: cfg.forward_flops(n, lm_head_width=0)          # noqa: E731
    quad = 2 * cfg.num_heads * (cfg.qk_head_dim + cfg.v_head_dim) * cfg.num_layers
    assert f(2048) - 2 * f(1024) == pytest.approx(quad * (2048 ** 2 - 2 * 1024 ** 2))
    moe = cfg.replace(first_k_dense_replace=0)
    per_token = 2 * 3 * 2048 * (768 * 8 - 6144)                   # MoE minus dense FFN
    assert moe.forward_flops(1, 0) - cfg.forward_flops(1, 0) == pytest.approx(
        per_token + 2 * 2048 * 128)
