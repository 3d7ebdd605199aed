"""Eval mixes: batched offline decodes through ``ModelRunner.generate_ids``.

Set-up draws the weights, builds the runner and decodes one batch of the
mix's shape at one step a block (every kernel and product shape the window
uses).  The window then decodes whole batches back to back, starting each
while ``--seconds`` has not passed and ending with the one in flight; each
batch ends in the host's copy of its output, a device sync.  With
``--trace 1`` one more batch runs after the window under the profiler,
device only.

The mix names what the runner and the sampler are run with: ``runner``
holds ``ModelRunner``'s keyword arguments (``accel``, ``quant``) and
``generate`` those of ``ModelRunner.generate_ids`` (``gen_length``,
``steps``, ``block_length``, ``temperature``, ``remasking``,
``avoid_eos``, ``parallel_threshold`` ...), each passed on whole.

Each batch's sequence before every step is recorded where the sampler
hands it to the model: ``ModelRunner.forward_fn``, and with the block
cache ``ModelRunner.cached_fns``.  That seam is part of this benchmark's
contract with the program: a program whose sampler stops calling it makes
the run stop with an error (no result line), never read as not correct.
The copy costs one device-to-device copy of the batch's ids a step (53 kB
at B 8, S 832).  The comparison (``portbench/harness/decode_check.py``)
follows those states once the window has closed, the peak memory has been
read and the runner and its weights are freed, on a fresh draw of the same
weights.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import torch

from portbench.harness import decode_check, model, seeds, traffic
from portbench.harness.runtime import Call, Check, Run
from portbench.harness.trace import traced
from portbench.reference import llada as ref


SEAM = ("the decode check reads each step's sequence where the sampler hands "
        "it to the model, at ModelRunner.forward_fn (or the block cache's "
        "ModelRunner.cached_fns); this batch made no such call, so the program's "
        "sampler no longer goes through that seam and the benchmark has to read "
        "the steps elsewhere")


class Recorder:
    """Wraps the runner's forward (and the block cache's functions): keeps
    each sequence the model is handed, and each full forward pass's LM head
    width.  A cached step, which runs the model over one block, is a state
    but no full pass."""

    def __init__(self, runner):
        self.inner = runner.forward_fn
        self.states, self.heads, self.last = [], [], None
        runner.forward_fn = self.forward
        if runner.cached_fns is not None:
            refresh, step, init = runner.cached_fns
            runner.cached_fns = (self._refresh(refresh), self._step(step), init)

    def _keep(self, ids, head):
        self.last = ids.detach().clone()
        self.states.append(self.last)
        if head is not None:
            self.heads.append(head)

    def forward(self, params, input_ids, attn_mask=None, logit_start=None,
                logit_length=None, *, return_hidden=False):
        self._keep(input_ids, input_ids.shape[1] if logit_length is None else logit_length)
        return self.inner(params, input_ids, attn_mask, logit_start, logit_length,
                          return_hidden=return_hidden)

    def _refresh(self, fn):
        def refresh(params, x, attn_mask, block_start, block_length):
            self._keep(x, block_length)
            return fn(params, x, attn_mask, block_start, block_length)
        return refresh

    def _step(self, fn):
        def step(params, block_ids, block_start, k_cache, v_cache, attn_mask):
            x = self.last.clone()
            x[:, block_start:block_start + block_ids.shape[1]] = block_ids
            self._keep(x, None)
            return fn(params, block_ids, block_start, k_cache, v_cache, attn_mask)
        return step

    def take(self):
        """(the states, the full passes' head widths) since the last take;
        raises where the sampler made no call through the seam."""
        states, heads = self.states, self.heads
        self.states, self.heads = [], []
        if not states:
            raise RuntimeError(SEAM)
        return states, heads


def decode_kw(mix: dict, steps: Optional[int] = None) -> dict:
    """``generate_ids``'s keyword arguments: the mix's ``generate``, with
    ``steps`` in place of its own where given."""
    kw = dict(mix["generate"])
    if steps is not None:
        kw["steps"] = steps
    return kw


def calls(b, heads, gen_length: int) -> list:
    """The full forward passes of batch ``b``: each row at its prompt and
    generated length."""
    rows = tuple(n + gen_length for n in b.lengths)
    return [Call(rows, h) for h in heads]


def build(run: Run):
    """(sizes, runner, recorder) on the run's device."""
    from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
    from ct_diffusionmodelbench_tpu_torch.io.tokenizer import Tokenizer

    s = run.sizes
    cfg = model.port_config(s, run.device)
    params = model.draw_weights(s, run.seed, run.device)
    tok = Tokenizer.byte_fallback(vocab_size=s["vocab_size"],
                                  eos_token_id=s["eos_token_id"] or 2)
    runner = ModelRunner(cfg, params, tok, prompt_bucket=run.mix["bucket"],
                         device=run.device, **run.mix.get("runner", {}))
    return s, runner, Recorder(runner)


def run(run: Run) -> None:
    mix = run.mix
    s, runner, rec = build(run)
    mask_id = s["mask_token_id"]
    gen = mix["generate"]
    warm = next(traffic.prompt_batches(mix, run.seed, mask_id, tag=seeds.WARMUP))
    n_blocks = gen["gen_length"] // gen["block_length"]
    runner.generate_ids(warm.ids, attn_mask=warm.mask, **decode_kw(mix, n_blocks))
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
    run.calls = [c for b, _, (_, heads) in done for c in calls(b, heads, gen["gen_length"])]
    run.attempted = sum(len(b.lengths) for b, _, _ in done)
    run.tokens = run.attempted * gen["gen_length"]
    run.log(f"window: {len(done)} batches, {run.tokens} tokens in {run.window_s:.3f} s")
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)

    if run.trace:
        b = next(batches)
        _, run.slice = traced(lambda: runner.generate_ids(b.ids, attn_mask=b.mask, **kw))
        run.slice_calls = calls(b, rec.take()[1], gen["gen_length"])
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
    for b, out, (states, _) in done:
        for r in range(b.ids.shape[0]):
            trajs.append(decode_check.Trajectory(
                prompt=torch.as_tensor(b.ids[r], device=device),
                mask=torch.as_tensor(b.mask[r], device=device),
                states=[x[r] for x in states if r < x.shape[0]],
                final=torch.as_tensor(out[r], device=device)))
            lengths.append(b.lengths[r])
    return trajs, lengths


def judge(run: Run, s, trajs, lengths) -> None:
    """Compares a sample of the window's requests with the reference
    (``decode_check``), on a fresh draw of the weights."""
    t0 = time.perf_counter()
    mix, mask_id = run.mix, s["mask_token_id"]
    limits = run.cell.limits["limits"]
    pairs = decode_check.sample(trajs, lengths, mix, seeds.host_rng(run.seed, seeds.SAMPLE))
    sampled = sorted({r for r, _ in pairs})
    faults = {r: decode_check.structure_faults(trajs[r], mix, mask_id) for r in sampled}
    unmasked = {r for r, t in enumerate(trajs) if (t.final[t.prompt.shape[0]:] == mask_id).any()}
    ref.strict_f32()
    weights = model.draw_weights(s, run.seed, run.device)
    worst, per_request = decode_check.judge(trajs, pairs, weights, s, mix)
    run.checks = {"structure": Check(float(sum(faults.values()) + len(unmasked)), 0.0)}
    run.checks.update({k: Check(worst[k], v) for k, v in limits.items()})
    bad = {r for r in sampled if faults[r] or any(per_request[r][k] > v
                                                   for k, v in limits.items())}
    run.failed = len(bad | unmasked)
    run.log(f"reference: {len(pairs)} steps of {len(sampled)} requests in "
            f"{time.perf_counter() - t0:.2f} s")
