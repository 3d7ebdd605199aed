"""Latent-attention mixes: batched offline block-diffusion decodes of a
DeepSeek-V3-layer model (``model_type`` ``deepseek_v3``) through
``ModelRunner.generate_ids``, over the program's latent cache.

As ``drivers/sdar_decode.py`` runs the SDAR mixes, and through its parts
(the recorder at ``ModelRunner.block_fns``, the passes of a batch, the
traced batch, the trajectories): set-up decodes one whole batch of the
mix's shape, the window decodes whole batches back to back, ``--trace 1``
runs one more under the profiler and the program's tracer, and the
comparison follows the recorded path once the window has closed and the
runner is freed.  What differs: the sizes and the weights
(``harness/mla_check.py``: the published column order, the routers'
selection bias), the record, which also takes the routes each pass left in
the program's cache (:class:`Recorder`), and the comparison's reference
(``portbench/reference/kanana.py``, one request a forward, routed as the
program routed).

The prompts are the generator's (``harness/traffic.py``: one a stratum of
``prompt_strata``, ids uniform in ``id_range``, left-padded to the bucket),
with their lengths drawn together (:func:`prompt_batches`): a batch's
prefill grows with the squares of its rows' lengths and K13 with their
sum, so at three batches a window, independent draws moved the window's
rate by about 1 % from seed to seed, and the traced batch's work was not
the window's mean batch's.

Before it draws any weight, the driver checks that the program's config of
the file carries latent attention (``is_mla``); a program without it stops
the run at once with an error, and no result line.
"""

from __future__ import annotations

import gc
import time
from typing import Iterator

import numpy as np
import torch

from portbench.harness import cells, decode_check, mla_check, seeds, traffic
from portbench.harness.runtime import Check, Run
from portbench.reference import kanana as ref

SDAR = cells.driver("sdar_decode")
# Batches whose lengths are drawn together: a window of the cell holds
# three batches of ~15 s (prompt_batches).
BALANCED = 3


def prompt_batches(mix: dict, seed: int, mask_id: int,
                   tag: int = seeds.TRAFFIC) -> Iterator[traffic.PromptBatch]:
    """The mix's batches, endlessly, as ``traffic.prompt_batches`` draws
    them but for the lengths.  The strata pair off from the ends (the first
    with the last, and so on); in batch j a pair puts its first prompt at
    the fraction f = frac(u + j / n) of its stratum and its second at 1 - f
    of its own (n = :data:`BALANCED`, u uniform from the seed, one a pair;
    a middle stratum left alone takes f).  Each prompt stays uniform over
    its stratum; with strata of equal width every batch holds the same
    tokens, and n batches in a row cover each pair's fractions evenly, so
    the window's work hardly moves from seed to seed."""
    rng = seeds.host_rng(seed, tag)
    strata, n = mix["prompt_strata"], BALANCED
    B = len(strata)
    if B != mix["batch"]:
        raise ValueError(f"{B} prompt strata for a batch of {mix['batch']}")
    starts, j = rng.random((B + 1) // 2), 0

    def length(s, x):
        lo, hi = strata[s]
        return lo + min(hi - lo, int(x * (hi - lo + 1)))

    while True:
        lengths = [0] * B
        for s, u in enumerate(starts):
            f = (u + j / n) % 1.0
            lengths[s] = length(s, f)
            if s != B - 1 - s:
                lengths[B - 1 - s] = length(B - 1 - s, 1.0 - f)
        lengths = [lengths[i] for i in rng.permutation(B)]
        p = -(-max(lengths) // mix["bucket"]) * mix["bucket"]
        ids = np.zeros((B, p), np.int64)
        mask = np.zeros((B, p), np.int32)
        for r, n_r in enumerate(lengths):
            ids[r, p - n_r:] = traffic._ids(rng, n_r, mix["id_range"], mask_id)
            mask[r, p - n_r:] = 1
        yield traffic.PromptBatch(ids, mask, lengths)
        j += 1


def program_config(run: Run):
    """The program's config of the cell's file; raises where the program
    has no latent attention."""
    from ct_diffusionmodelbench_tpu_torch.models.config import config_from_hf

    conf = run.cell.config
    cfg = config_from_hf(conf, name=conf["name"])
    if not getattr(cfg, "is_mla", False):
        raise SystemExit(f"portbench: the program reads {conf['name']} without latent "
                         "attention (its config has no kv_lora_rank): it cannot run this cell")
    return cfg if run.device.type == "cuda" else cfg.replace(dtype="float32")


class Recorder(SDAR.Recorder):
    """SDAR's recorder at ``ModelRunner.block_fns`` (``drivers/
    sdar_decode.py``), keeping also the routes each pass wrote into the
    cache (``harness/mla_check.py::Record``)."""

    def _prefill(self, fn):
        def prefill(params, ids, mask, total_len, real_keys):
            record = mla_check.Record(ids.detach().clone(), mask.detach().clone())
            cache = fn(params, ids, mask, total_len, real_keys)
            record.prompt_routes = mla_check.routes_of(cache, 0, ids.shape[1])
            self.record = record
            return cache
        return prefill

    def _keep(self, fn, kind):
        def call(params, cache, block_ids, start):
            getattr(self.record, kind).append((start, block_ids.detach().clone()))
            out = fn(params, cache, block_ids, start)
            getattr(self.record, kind[:-1] + "_routes").append(
                mla_check.routes_of(cache, start, start + block_ids.shape[1]))
            return out
        return call


def build(run: Run):
    """(sizes, runner, recorder) on the run's device."""
    from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer

    cfg = program_config(run)
    s = mla_check.sizes(run.cell.config)
    params = mla_check.draw_weights(s, run.seed, run.device)
    tok = Tokenizer.byte_fallback(vocab_size=s["vocab_size"], eos_token_id=s["eos_token_id"])
    runner = ModelRunner(cfg, params, tok, prompt_bucket=run.mix["bucket"],
                         device=run.device, **run.mix.get("runner", {}))
    return s, runner, Recorder(runner)


def decode_kw(mix: dict) -> dict:
    return SDAR.decode_kw(mix)


def trajectories(done, device):
    """Every completed request's trajectory with its routes, and its prompt
    length."""
    trajs, lengths = [], []
    for b, out, record in done:
        trajs += mla_check.trajectories(record, out, b.lengths, device)
        lengths += list(b.lengths)
    return trajs, lengths


def run(run: Run) -> None:
    mix = run.mix
    s, runner, rec = build(run)
    mask_id = s["mask_token_id"]
    kw = decode_kw(mix)
    warm = next(prompt_batches(mix, run.seed, mask_id, tag=seeds.WARMUP))
    runner.generate_ids(warm.ids, attn_mask=warm.mask, **kw)
    rec.take()
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    run.setup_done()
    run.log(f"set-up {run.setup_s:.2f} s; window of {run.seconds} s")

    batches, done = prompt_batches(mix, run.seed, mask_id), []
    start = time.perf_counter()
    end = start
    while end - start < run.seconds:
        b = next(batches)
        out = runner.generate_ids(b.ids, attn_mask=b.mask, **kw)
        end = time.perf_counter()
        done.append((b, out, rec.take()))
    run.window_s, run.units = end - start, len(done)
    run.calls = [c for b, _, r in done for c in SDAR.calls(b, r)]
    run.attempted = sum(len(b.lengths) for b, _, _ in done)
    run.tokens = run.attempted * mix["generate"]["gen_length"]
    run.log(f"window: {len(done)} batches, {run.tokens} tokens in {run.window_s:.3f} s")
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)

    if run.trace:
        b = next(batches)
        SDAR.traced_batch(run, lambda: runner.generate_ids(b.ids, attn_mask=b.mask, **kw))
        run.slice_calls = SDAR.calls(b, rec.take())
        run.log(f"traced batch: busy {run.slice.busy_s:.3f} of {run.slice.window_s:.3f} s")

    trajs, lengths = trajectories(done, run.device)
    del runner, rec, done
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    judge(run, s, trajs, lengths)


def judge(run: Run, s, trajs, lengths) -> None:
    """As ``drivers/sdar_decode.py::judge``, with this cell's reference: the
    cell's limits hold the sample's means; a request fails on its structure
    or a mask left in its output."""
    from portbench.harness import sdar_check

    t0 = time.perf_counter()
    mix, mask_id = run.mix, s["mask_token_id"]
    limits = run.cell.limits["limits"]
    pairs = decode_check.sample(trajs, lengths, mix, seeds.host_rng(run.seed, seeds.SAMPLE))
    sampled = sorted({r for r, _ in pairs})
    faults = {r: sdar_check.structure_faults(trajs[r], mix, mask_id) for r in sampled}
    G = mix["generate"]["gen_length"]
    unmasked = {r for r, t in enumerate(trajs) if (t.final[-G:] == mask_id).any()}
    ref.strict_f32()
    weights = mla_check.draw_weights(s, run.seed, run.device)
    worst, _ = mla_check.judge(trajs, pairs, weights, s, mix)
    run.checks = {"structure": Check(float(sum(faults.values()) + len(unmasked)), 0.0)}
    run.checks.update({k: Check(worst[k], v) for k, v in limits.items()})
    run.failed = len({r for r in sampled if faults[r]} | unmasked)
    run.log(f"reference: {len(pairs)} steps of {len(sampled)} requests in "
            f"{time.perf_counter() - t0:.2f} s")
