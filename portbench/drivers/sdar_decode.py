"""SDAR mixes: batched offline block-diffusion decodes through
``ModelRunner.generate_ids``, over the program's exact KV cache.

The program is built from the configuration file through its own
``config_from_hf`` (model_type ``sdar_moe``: family ``sdar``), the weights
drawn from the seed (``harness/model.py``, with qk-norm gains:
``harness/sdar_check.py::sizes``).  Set-up then decodes one whole batch of
the mix's shape: the program keeps its cache and the CUDA graphs of its
passes per batch shape, so the warm-up records every one the window
replays.  The window decodes whole batches back to
back, starting each while ``--seconds`` has not passed and ending with the
one in flight; each batch ends in the host's copy of its output.

With ``--trace 1`` one more batch runs after the window under the device
profiler and the program's tracer (``utils/profiling.py::tracing``) at
once: ``run.slice`` (device time by kernel) and ``run.span_slice`` (the
program's spans and counters joined to the same device trace by launch,
``harness/spans.py``) both read it, and ``run.slice_calls`` holds its
passes: the prefill at each row's real prompt length, every step and
commit at the block's length a row.

The mix's ``generate`` is passed to ``ModelRunner.generate_ids`` whole.
Each batch's path is recorded where the sampler hands it to the model:
``ModelRunner.block_fns``, the program's documented seam.  A program whose
sampler stops calling it makes the run stop with an error (no result
line), never read as not correct.  The comparison
(``harness/sdar_check.py``) follows the recorded path once the window has
closed, the peak memory has been read and the runner and its weights are
freed, on a fresh draw of the same weights.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench.harness import decode_check, model, sdar_check, seeds, spans, traffic
from portbench.harness.runtime import Call, Check, Run
from portbench.harness.trace import Slice, idle_gaps, union_seconds
from portbench.reference import sdar as ref

SEAM = ("the SDAR check reads each step's block where the sampler hands it to "
        "the model, at ModelRunner.block_fns (prefill_fn, step_fn, commit_fn); this "
        "batch made no step through it, so the program's sampler no longer goes "
        "through that seam and the benchmark has to read the steps elsewhere")


class Recorder:
    """Wraps the runner's ``block_fns``: keeps the padded prompt and mask
    the prefill is handed and each step's and commit's block and start."""

    def __init__(self, runner):
        prefill, step, commit = runner.block_fns
        self.record = None
        runner.block_fns = (self._prefill(prefill), self._keep(step, "steps"),
                            self._keep(commit, "commits"))

    def _prefill(self, fn):
        def prefill(params, ids, mask, total_len, real_keys):
            self.record = sdar_check.Record(ids.detach().clone(), mask.detach().clone())
            return fn(params, ids, mask, total_len, real_keys)
        return prefill

    def _keep(self, fn, kind):
        def call(params, cache, block_ids, start):
            getattr(self.record, kind).append((start, block_ids.detach().clone()))
            return fn(params, cache, block_ids, start)
        return call

    def take(self) -> sdar_check.Record:
        """The record since the last take; raises where the sampler made no
        step through the seam."""
        record, self.record = self.record, None
        if record is None or not record.steps:
            raise RuntimeError(SEAM)
        return record


def calls(b, record: sdar_check.Record) -> list:
    """The passes of batch ``b``: the prefill at each row's real prompt
    length, each step (the LM head over its block) and each commit (no head)
    at the block's length a row."""
    bl = record.steps[0][1].shape[1]
    block = (bl,) * len(b.lengths)
    return ([Call(tuple(b.lengths), 0)] + [Call(block, bl)] * len(record.steps)
            + [Call(block, 0)] * len(record.commits))


def decode_kw(mix: dict) -> dict:
    """``generate_ids``'s keyword arguments: the mix's ``generate``."""
    return dict(mix["generate"])


def build(run: Run):
    """(sizes, runner, recorder) on the run's device."""
    from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer
    from ct_diffusionmodelbench_tpu_torch.models.config import config_from_hf

    conf = run.cell.config
    s = sdar_check.sizes(conf)
    cfg = config_from_hf(conf, name=conf["name"])
    if run.device.type != "cuda":
        cfg = cfg.replace(dtype="float32")
    params = model.draw_weights(s, run.seed, run.device)
    tok = Tokenizer.byte_fallback(vocab_size=s["vocab_size"], eos_token_id=s["eos_token_id"])
    runner = ModelRunner(cfg, params, tok, prompt_bucket=run.mix["bucket"],
                         device=run.device, **run.mix.get("runner", {}))
    return s, runner, Recorder(runner)


def traced_batch(run: Run, decode):
    """Run ``decode`` (ending in a device sync) under the device profiler
    and the program's tracer; sets ``run.slice`` and ``run.span_slice``
    from the one trace."""
    from torch.profiler import ProfilerActivity, profile

    from ct_diffusionmodelbench_tpu_torch.utils.profiling import tracing

    gc.collect()   # the collector must not free an old profile inside the batch
    cuda = run.device.type == "cuda"
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with tracing() as recording, profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        out = decode()
        window = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    dev_type = torch.autograd.DeviceType.CUDA
    ops = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if e.device_type() == dev_type and not e.is_user_annotation()]
    kernels = {}
    for s, e, name in ops:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) * 1e-9
        k[1] += 1
    t0 = min((s for s, _, _ in ops), default=0)
    run.slice = Slice(window_s=window,
                      busy_s=union_seconds(((s - t0) * 1e-9, (e - t0) * 1e-9)
                                           for s, e, _ in ops),
                      kernels=kernels, gaps=idle_gaps(ops))
    run.span_slice = spans.join(events, recording.spans, recording.counters, window,
                                spans.classifier())
    return out


def run(run: Run) -> None:
    mix = run.mix
    s, runner, rec = build(run)
    mask_id = s["mask_token_id"]
    warm = next(traffic.prompt_batches(mix, run.seed, mask_id, tag=seeds.WARMUP))
    runner.generate_ids(warm.ids, attn_mask=warm.mask, **decode_kw(mix))
    rec.take()
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    run.setup_done()
    run.log(f"set-up {run.setup_s:.2f} s; window of {run.seconds} s")

    kw = decode_kw(mix)
    batches, done = traffic.prompt_batches(mix, run.seed, mask_id), []
    start = time.perf_counter()
    end = start
    while end - start < run.seconds:
        b = next(batches)
        out = runner.generate_ids(b.ids, attn_mask=b.mask, **kw)
        end = time.perf_counter()
        done.append((b, out, rec.take()))
    run.window_s, run.units = end - start, len(done)
    run.calls = [c for b, _, r in done for c in calls(b, r)]
    run.attempted = sum(len(b.lengths) for b, _, _ in done)
    run.tokens = run.attempted * mix["generate"]["gen_length"]
    run.log(f"window: {len(done)} batches, {run.tokens} tokens in {run.window_s:.3f} s")
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)

    if run.trace:
        b = next(batches)
        traced_batch(run, lambda: runner.generate_ids(b.ids, attn_mask=b.mask, **kw))
        run.slice_calls = calls(b, rec.take())
        run.log(f"traced batch: busy {run.slice.busy_s:.3f} of {run.slice.window_s:.3f} s")

    trajs, lengths = trajectories(done, run.device)
    del runner, rec, done
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    judge(run, s, trajs, lengths)


def trajectories(done, device):
    """Every completed request's trajectory, and its prompt length."""
    trajs, lengths = [], []
    for b, out, record in done:
        trajs += sdar_check.trajectories(record, out, b.lengths, device)
        lengths += list(b.lengths)
    return trajs, lengths


def judge(run: Run, s, trajs, lengths) -> None:
    """Compares a sample of the window's requests with the reference
    (``harness/sdar_check.py``), on a fresh draw of the weights.  The
    cell's limits hold the sample's numbers; a request fails on its
    structure (or a mask left in its output), not on one request's share of
    the sample: the cell's limits are on means over the sample (the widest
    gaps follow the expert router's near-ties, ``workloads/<cell>.json``),
    and sixteen tokens of one request make no steady mean."""
    t0 = time.perf_counter()
    mix, mask_id = run.mix, s["mask_token_id"]
    limits = run.cell.limits["limits"]
    pairs = decode_check.sample(trajs, lengths, mix, seeds.host_rng(run.seed, seeds.SAMPLE))
    sampled = sorted({r for r, _ in pairs})
    faults = {r: sdar_check.structure_faults(trajs[r], mix, mask_id) for r in sampled}
    G = mix["generate"]["gen_length"]
    unmasked = {r for r, t in enumerate(trajs) if (t.final[-G:] == mask_id).any()}
    ref.strict_f32()
    weights = model.draw_weights(s, run.seed, run.device)
    worst, _ = sdar_check.judge(trajs, pairs, weights, s, mix)
    run.checks = {"structure": Check(float(sum(faults.values()) + len(unmasked)), 0.0)}
    run.checks.update({k: Check(worst[k], v) for k, v in limits.items()})
    run.failed = len({r for r in sampled if faults[r]} | unmasked)
    run.log(f"reference: {len(pairs)} steps of {len(sampled)} requests in "
            f"{time.perf_counter() - t0:.2f} s")
