"""Training mixes: masked-diffusion SFT steps of ``make_train_step``.

Set-up draws the weights, builds the optimizer and the step once, and
drives that same step through its first ``check.steps`` steps with the
window's own feed: the program's ``DiffusionCollator`` over seeded rows
that all differ, and the diffusion noise (``t`` a row, ``u`` a token)
drawn on the card from the seed and handed to the step, so the reference
can draw it alike.  Those steps are the warm-up; from them the comparison
keeps each step's loss, each leaf's norm of the first gradient as the
optimizer got it (its first moment after one step, over 1 − β1), and each
leaf's norm of the parameters' change after the last (the parameters drawn
again from the seed, leaf by leaf).  The time that bookkeeping takes is
left out of ``setup_s``.

The window then runs whole steps back to back, each ending when its loss
is read on the host.  A CUDA-event span wraps the optimizer's ``update``
on the instance handed to ``make_train_step``.  With ``--trace 1`` one more
step runs after the window under the profiler, device only.  Once the
window has closed and the peak memory is read, the program is freed and
the plain reference (``portbench/reference/train.py``) takes the same
feeds from a fresh draw of the weights.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench.harness import model, seeds, train_check, traffic
from portbench.harness.runtime import Call, Check, Run
from portbench.harness.trace import traced


class OptimizerClock:
    """CUDA-event spans around an optimizer instance's ``update``."""

    def __init__(self, optimizer, device):
        self.spans = []
        self.device = device
        inner = optimizer.update

        def timed(*a, **kw):
            if device.type != "cuda":
                return inner(*a, **kw)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = inner(*a, **kw)
            end.record()
            self.spans.append((start, end))
            return out
        optimizer.update = timed

    def take_ms(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ms = [s.elapsed_time(e) for s, e in self.spans]
        self.spans = []
        return ms


def train_config(mix: dict):
    from ct_diffusionmodelbench_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(
        grad_accum=mix["grad_accum"], batch_size=mix["batch_size"],
        max_length=mix["seq_len"], learning_rate=mix["learning_rate"],
        warmup_steps=mix["warmup_steps"], lr_schedule="cosine",
        weight_decay=mix["weight_decay"], max_grad_norm=mix["max_grad_norm"],
        optimizer_state_dtype=mix["optimizer_state_dtype"],
        grad_accum_dtype=mix["grad_accum_dtype"], remat=mix["remat"],
        ce_chunk=mix["ce_chunk"], variable_length=False, bucket=64,
        aux_loss_coef=mix["aux_loss_coef"], mask_variant="recompute")


class Feed:
    """Step ``i``'s batch: the mix's rows through the program's collator,
    and its noise, both from the seed."""

    def __init__(self, run: Run, s: dict, collator=None):
        self.run, self.s, self.mix = run, s, run.mix
        self.collator = collator

    def rows(self, i: int):
        mix = self.mix
        return traffic.sft_rows(mix, self.run.seed, mix["grad_accum"] * mix["batch_size"],
                                self.s["mask_token_id"], tag=seeds.TRAFFIC + 100 * (i + 1))

    def noise(self, i: int):
        mix, dev = self.mix, self.run.device
        a, b, L = mix["grad_accum"], mix["batch_size"], mix["seq_len"]
        gen = seeds.device_generator(self.run.seed, seeds.NOISE, dev, i)
        t = torch.rand((a, b), generator=gen, device=dev, dtype=torch.float32)
        u = torch.rand((a, b, L), generator=gen, device=dev, dtype=torch.float32)
        return t, u

    def program(self, i: int):
        """(ids [A, B, L], prompt lengths [A, B], (t, u)) on the device,
        through the collator, as the trainer stacks its micro-batches."""
        mix, dev = self.mix, self.run.device
        batch = self.collator(self.rows(i), train=True)
        a, b = mix["grad_accum"], mix["batch_size"]
        ids = torch.from_numpy(batch["input_ids"]).long().to(dev).reshape(a, b, -1)
        plens = torch.from_numpy(batch["prompt_lengths"]).long().to(dev).reshape(a, b)
        return ids, plens, self.noise(i)

    def reference(self, i: int):
        """The same step's rows stacked by the reference's own hand."""
        mix, dev = self.mix, self.run.device
        rows = self.rows(i)
        a, b = mix["grad_accum"], mix["batch_size"]
        ids = torch.tensor([r["input_ids"] for r in rows], device=dev).reshape(a, b, -1)
        plens = torch.tensor([r["prompt_lengths"] for r in rows], device=dev).reshape(a, b)
        return (ids, plens) + self.noise(i)

    def tokens(self, ids: torch.Tensor) -> int:
        """Non-pad tokens: every row is ``seq_len`` real tokens long."""
        return int(ids.numel())


def micro_batches(mix: dict) -> list:
    """A step's forward passes: one a micro-batch, every row ``seq_len``
    real tokens, the LM head over all of them."""
    return [Call((mix["seq_len"],) * mix["batch_size"], mix["seq_len"])] * mix["grad_accum"]


def build(run: Run):
    from ct_diffusionmodelbench_tpu_torch.train.collator import DiffusionCollator
    from ct_diffusionmodelbench_tpu_torch.train.trainer import make_optimizer, make_train_step

    s = run.sizes
    cfg = model.port_config(s, run.device)
    tc = train_config(run.mix)
    params = model.draw_weights(s, run.seed, run.device)
    optimizer, _ = make_optimizer(tc, run.mix["total_steps"])
    state = optimizer.init(params)
    clock = OptimizerClock(optimizer, run.device)
    step, _ = make_train_step(cfg, tc, optimizer, run.device)
    # Every row is seq_len long: the collator pads nothing.
    collator = DiffusionCollator(pad_token_id=0, eos_token_id=s["eos_token_id"],
                                 max_length=tc.max_length, variable_length=False,
                                 bucket=tc.bucket, seed=tc.seed)
    return s, params, state, step, clock, Feed(run, s, collator)


def first_steps(run: Run, s: dict, params, state, step, feed):
    """The first ``check.steps`` steps through the window's own call and
    feed: (params, state, the program's readings, seconds spent reading
    them)."""
    losses, excluded = [], 0.0
    for i in range(run.mix["check"]["steps"]):
        ids, plens, noise = feed.program(i)
        params, state, metrics = step(params, state, ids, plens, noise)
        losses.append(float(metrics["loss"]))
        if i == 0:
            t0 = time.perf_counter()
            first = train_check.moment_norms(state.mu, 1.0 - train_check.B1)
            excluded += time.perf_counter() - t0
    t0 = time.perf_counter()
    change = train_check.change_norms(params, s, run.seed, run.device)
    excluded += time.perf_counter() - t0
    return params, state, {"losses": losses, "first": first, "change": change}, excluded


def run(run: Run) -> None:
    mix = run.mix
    s, params, state, step, clock, feed = build(run)
    n_check = mix["check"]["steps"]
    params, state, program, excluded = first_steps(run, s, params, state, step, feed)
    losses = program["losses"]
    clock.take_ms()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    run.setup_s = time.perf_counter() - run.t0 - excluded
    run.log(f"set-up {run.setup_s:.2f} s (and {excluded:.2f} s reading the check's norms); "
            f"losses {losses}")

    i, start = n_check, time.perf_counter()
    end, tokens = start, 0
    while end - start < run.seconds:
        ids, plens, noise = feed.program(i)
        params, state, metrics = step(params, state, ids, plens, noise)
        float(metrics["loss"])
        end = time.perf_counter()
        tokens += feed.tokens(ids)
        i += 1
    run.window_s, run.tokens = end - start, tokens
    run.attempted = run.units = i - n_check
    run.calls = micro_batches(mix) * run.attempted
    spans = clock.take_ms()
    run.spans["optimizer_ms"] = statistics.fmean(spans) if spans else None
    run.log(f"window: {run.attempted} steps, {tokens} tokens in {run.window_s:.3f} s")
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)

    if run.trace:
        ids, plens, noise = feed.program(i)

        def one():
            out = step(params, state, ids, plens, noise)
            float(out[2]["loss"])
        _, run.slice = traced(one)
        run.slice_calls = micro_batches(mix)
        clock.take_ms()
        run.log(f"traced step: busy {run.slice.busy_s:.3f} of {run.slice.window_s:.3f} s")

    del params, state, step, clock
    feed.collator = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    judge(run, s, feed, program)


def judge(run: Run, s: dict, feed: Feed, program: dict) -> None:
    t0 = time.perf_counter()
    readings = train_check.reference_readings(run, s, feed)
    numbers = train_check.compare(program, readings)
    limits = run.cell.limits["limits"]
    run.checks = {k: Check(v, limits[k]) for k, v in numbers.items()}
    run.failed = 0 if all(c.ok for c in run.checks.values()) else 1
    run.log(f"reference: {len(readings['losses'])} steps in {time.perf_counter() - t0:.2f} s; "
            f"losses {readings['losses']} against the program's {program['losses']}")
