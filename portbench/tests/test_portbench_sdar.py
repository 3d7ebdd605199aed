"""The SDAR driver, check and readers on the CPU: a tiny SDAR cell dropped
into a copy of the harness (``tiny.py``'s way), end to end; the three new
readers against counts made by hand; the seam's error when the sampler
stops going through ``ModelRunner.block_fns``."""

import json

import pytest
import torch

from portbench.harness import cells, peaks, sdar_check, spans
from portbench.harness.runtime import Call, run_cell
from portbench.harness.trace import Slice
from portbench.tests.tiny import base

TINY_SDAR = {"name": "tiny-sdar", "model_type": "sdar_moe", "hidden_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
             "head_dim": 16, "num_experts": 8, "num_experts_per_tok": 2,
             "moe_intermediate_size": 32, "norm_topk_prob": True, "vocab_size": 512,
             "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "mask_token_id": 500,
             "eos_token_id": 2, "torch_dtype": "bfloat16", "block_length": 4,
             "reduced": [], "assumed": []}
TINY_SDAR_MIX = {"kind": "sdar_decode", "why": "tiny", "batch": 4,
                 "prompt_strata": [[10, 20], [21, 40], [41, 60], [61, 62]],
                 "id_range": [10, 400], "bucket": 16, "runner": {},
                 "generate": {"gen_length": 16, "steps": 8, "block_length": 4,
                              "temperature": 0.0, "remasking": "low_confidence"},
                 "check": {"requests": 3, "steps_per_request": 5, "rows_per_forward": 2}}
# The program and the reference are both float32 on the CPU: a sound run
# agrees to rounding, far inside these.
TINY_LIMITS = {"limits": {"token_gap": 1e-3, "order_gap": 1e-3}}
NEW = ("cache_attn_roofline.decode", "denoise_step_ms.decode", "commit_share.decode")
H100 = peaks.peaks("NVIDIA H100 80GB HBM3")


def sdar_base(tmp_path):
    """The harness's copy with the tiny SDAR cell ``tiny-sdar-eval`` listed
    wherever ``sdar30b-eval`` is."""
    pb = base(tmp_path)
    (pb / "configs" / "tiny-sdar.json").write_text(json.dumps(TINY_SDAR))
    (pb / "traffic" / "tiny-sdar-eval.json").write_text(json.dumps(TINY_SDAR_MIX))
    (pb / "workloads" / "tiny-sdar-eval.json").write_text(json.dumps(TINY_LIMITS))
    bench = json.loads((pb.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-sdar", "source": "tests",
                             "file": "portbench/configs/tiny-sdar.json", "reduced": [],
                             "why": "tiny"})
    bench["workloads"].append({"name": "tiny-sdar-eval", "config": "tiny-sdar",
                               "traffic": "tiny-sdar-eval", "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sdar30b-eval" in m.get("workloads", []):
            m["workloads"].append("tiny-sdar-eval")
    (pb.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    return pb


def test_the_sdar_cell_lists_its_metrics():
    cell = cells.cell("sdar30b-eval")
    assert cell.chips == 1 and cell.traffic["kind"] == "sdar_decode"
    assert [m["name"] for m in cell.end_to_end] == ["decode_tokens_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == set(NEW) | {"grouped_ffn_roofline.decode"}
    s = sdar_check.sizes(cell.config)
    assert (s["qk_norm"], s["block_length"], s["num_shared_experts"]) == (True, 4, 0)


def test_the_sdar_cell_runs_end_to_end(tmp_path):
    pb = sdar_base(tmp_path)
    out = run_cell(cells.cell("tiny-sdar-eval", base=pb), 2**31 + 11, 0.2, False,
                   torch.device("cpu"), 0.0, base=pb)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4, out["checks"]
    assert out["checks"]["structure"]["value"] == 0
    assert set(out["metrics"]) == {"decode_tokens_per_s", "setup_s"}


def test_the_sdar_driver_traces_one_batch(tmp_path):
    """With --trace 1 ``drivers/sdar_decode.py`` fills the slice, the span
    slice and the traced batch's passes; off the card only the span
    count's reader reads (0 ms: no device time)."""
    from portbench.harness.runtime import Run

    pb = sdar_base(tmp_path)
    cell = cells.cell("tiny-sdar-eval", base=pb)
    run = Run(cell=cell, seed=2**33 + 5, seconds=0.2, trace=True,
              device=torch.device("cpu"), t0=0.0)
    cells.driver("sdar_decode", pb).run(run)
    assert all(c.ok for c in run.checks.values()) and run.failed == 0, run.checks
    per_batch = 1 + 4 * 2 + 4                 # prefill, 4 blocks of 2 steps, 4 commits
    assert len(run.calls) == per_batch * run.units and len(run.slice_calls) == per_batch
    c = run.span_slice.counters
    assert (c["sdar.steps"], c["sdar.commits"], c["model.forward"]) == (8, 4, 13)
    assert c["cache.queries"] == 12 * 4 * 4 and c["cache.pairs"] == 4 * c["cache.keys"]
    assert {"sdar.prefill", "sdar.step", "sdar.commit"} <= set(run.span_slice.spans)
    got = cells.read_metrics(cell.per_layer, run, pb)
    assert got == {"denoise_step_ms.decode": {"value": 0.0, "unit": "ms"}}


def test_structure_catches_a_departure(tmp_path):
    """A step that unmasks one token too many, a commit that differs from
    the output, and a step at the wrong start are each a fault."""
    mix = TINY_SDAR_MIX
    m = 500
    prompt = torch.tensor([0, 0, 7, 8])
    blocks = [torch.tensor([m, m, m, m]), torch.tensor([m, 5, m, 6])]
    final_blk = torch.tensor([3, 5, 4, 6])
    t = sdar_check.Trajectory(prompt=prompt, mask=torch.tensor([0, 0, 1, 1]),
                              steps=[(4, b) for b in blocks], commits=[(4, final_blk)],
                              final=torch.cat([prompt, final_blk]))
    one_block = dict(mix, generate=dict(mix["generate"], gen_length=4, steps=2))
    assert sdar_check.structure_faults(t, one_block, m) == 0
    bad = sdar_check.Trajectory(**{**t.__dict__, "steps": [(4, blocks[0]),
                                                           (4, torch.tensor([m, 5, 1, 6]))]})
    assert sdar_check.structure_faults(bad, one_block, m) == 2
    moved = sdar_check.Trajectory(**{**t.__dict__, "steps": [(8, blocks[0]), (4, blocks[1])]})
    assert sdar_check.structure_faults(moved, one_block, m) == 1
    other = sdar_check.Trajectory(**{**t.__dict__, "final": torch.cat([prompt, blocks[1]])})
    assert sdar_check.structure_faults(other, one_block, m) == 2   # the commit and a mask


def test_the_check_judges_each_state_as_its_own_forward():
    """``sdar_check.judge`` (the sampled states of a request packed into one
    row, two requests a forward) gives the gaps that the reference's full
    forward of each state gives, one state at a time."""
    from portbench.harness import decode_check, model
    from portbench.reference import sdar as ref

    s = sdar_check.sizes(TINY_SDAR)
    w = model.draw_weights(s, 7, torch.device("cpu"))
    ref.strict_f32()
    m, bl, spb, P = 500, 4, 2, 16
    g = torch.Generator().manual_seed(3)
    trajs = []
    for pad in (0, 3, 6):
        prompt = torch.randint(10, 400, (P,), generator=g)
        prompt[:pad] = 0
        steps, commits = [], []
        for k in range(4):
            blk = torch.full((bl,), m)
            for j in range(spb):
                steps.append((P + k * bl, blk))
                blk = blk.clone()
                blk[2 * j:2 * j + 2] = torch.randint(10, 400, (2,), generator=g)
            commits.append((P + k * bl, blk))
        trajs.append(sdar_check.Trajectory(
            prompt=prompt, mask=(torch.arange(P) >= pad).to(torch.int32), steps=steps,
            commits=commits, final=torch.cat([prompt[pad:]] + [c for _, c in commits])))
    pairs = [(0, 1), (0, 6), (1, 0), (1, 3), (1, 7), (2, 4)]
    got, _ = sdar_check.judge(trajs, pairs, w, s, TINY_SDAR_MIX)
    acc = decode_check._zero()
    for r, i in pairs:
        t, k = trajs[r], i // spb
        state = torch.cat([t.prompt] + [c for _, c in t.commits[:k]] + [t.steps[i][1]])
        smask = torch.cat([t.mask, torch.ones((k + 1) * bl, dtype=t.mask.dtype)])
        logits = ref.block_logits(w, s, state[None], smask[None], P + k * bl, bl)[0]
        decode_check._fold(acc, decode_check.gaps(logits, t.steps[i][1],
                                                  sdar_check.after(t, i, spb), m))
    assert got == pytest.approx(decode_check.stats(acc), rel=1e-4, abs=1e-5)
    assert got["token_gap"] > 0 and got["order_gap"] >= 0


def test_the_seam_raises_when_the_sampler_bypasses_it(tmp_path, monkeypatch):
    from ct_diffusionmodelbench_tpu_torch.eval import runner as runner_mod
    from ct_diffusionmodelbench_tpu_torch.models.sdar_cache import make_sdar_fns
    from portbench.harness import traffic
    from portbench.harness.runtime import Run

    pb = sdar_base(tmp_path)
    cell = cells.cell("tiny-sdar-eval", base=pb)
    drv = cells.driver("sdar_decode", pb)
    run = Run(cell=cell, seed=3, seconds=0, trace=False, device=torch.device("cpu"), t0=0.0)
    s, runner, rec = drv.build(run)
    inner = runner_mod.sdar_generate
    monkeypatch.setattr(runner_mod, "sdar_generate",
                        lambda fns, *a, **k: inner(make_sdar_fns(runner.cfg), *a, **k))
    b = next(traffic.prompt_batches(run.mix, 3, s["mask_token_id"]))
    runner.generate_ids(b.ids, attn_mask=b.mask, **drv.decode_kw(run.mix))
    with pytest.raises(RuntimeError, match="ModelRunner.block_fns"):
        rec.take()


class _Run:
    pass


def _run(kernels, counters, spans_s, busy):
    """A run with a traced slice of ``kernels`` and a span slice of
    ``counters`` and seconds by span name (all 'other')."""
    run = _Run()
    run.slice = Slice(window_s=10.0, busy_s=busy, kernels=kernels)
    span_times = {}
    for name, sec in spans_s.items():
        t = spans.SpanTime(n=1)
        t.incl[2] = sec
        span_times[name] = t
    run.span_slice = spans.SpanSlice(window_s=10.0, busy_s=busy, spans=span_times,
                                     counters=counters, gaps=[])
    run.sizes = {"num_heads": 32, "num_kv_heads": 4, "head_dim": 128, "num_layers": 48}
    run.peaks = H100
    run.slice_calls = [Call((4,) * 32, 4)]
    return run


def test_readers_against_hand_counts():
    keys, queries = 32 * 700, 32 * 4
    counters = {"cache.keys": keys, "cache.queries": queries, "cache.pairs": 4 * keys,
                "sdar.steps": 256, "sdar.commits": 64}
    run = _run({"cache_attn_kernel<128>": [2.0, 480]}, counters,
               {"sdar.step": 9.0, "sdar.commit": 2.2}, busy=11.5)
    # By hand: a layer reads K and V of 22400 keys x 4 kv heads x 128 in
    # bf16 (2 x 22400 x 4 x 128 x 2 = 45.875 MB) and q and the output of
    # 128 positions x 32 heads x 128 (2 x 128 x 32 x 128 x 2 = 2.097 MB):
    # 47.972 MB at 3.35 TB/s, x 48 layers; FLOPs 4 x 89600 x 32 x 128 =
    # 1.468 GFLOP a layer, far below.
    moved = 2 * 22400 * 4 * 128 * 2 + 2 * 128 * 32 * 128 * 2
    want = 100.0 * 48 * moved / 3.35e12 / 2.0
    got = {n: cells.reader(n).read(run) for n in NEW}
    assert got["cache_attn_roofline.decode"] == pytest.approx(want, rel=1e-12)
    assert got["denoise_step_ms.decode"] == pytest.approx(9000.0 / 256)
    assert got["commit_share.decode"] == pytest.approx(100.0 * 2.2 / 11.5)


def test_readers_find_nothing_in_a_run_without_the_sdar_path():
    run = _run({"flash_fwd_kernel<128>": [1.0, 10]}, {"model.forward": 3}, {"model.forward": 1.0},
               busy=2.0)
    assert all(cells.reader(n).read(run) is None for n in NEW)
    del run.span_slice
    assert all(cells.reader(n).read(run) is None for n in NEW)


def test_control_readings_on_a_tiny_cell(tmp_path):
    """The limits' readings script's per-seed function: the program's
    numbers and, with extras, the fp8 control's, on the CPU."""
    from portbench import sdar_control

    pb = sdar_base(tmp_path)
    cell = cells.cell("tiny-sdar-eval", base=pb)
    row = sdar_control.readings(cell, 5, torch.device("cpu"), True, base=pb)
    assert row["structure"] == 0 and row["token_gap"] < 1e-3 and row["order_gap"] < 1e-3
    assert {"control_token_gap", "control_order_gap"} <= set(row)
