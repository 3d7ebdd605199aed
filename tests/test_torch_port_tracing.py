"""The port's tracer (``utils/profiling.py``: ``span``, ``count``,
``tracing``) and the spans and counters of its decode path, on the CPU.

- Off, a span is one shared no-op object that records nothing and reads no
  clock; on, spans nest with their parents and counters sum; a tensor is
  refused as a count; ``tracing()`` scopes do not nest.
- A span's interval holds a ``record_function`` event of the same
  profile: both are on the clock of ``torch.profiler``'s Kineto events.
- A ``llada-tiny`` decode (fixed schedule, threshold decoding, CFG, the
  block cache) and a ``dream-tiny`` decode record one ``sampler.step`` a
  model call, a ``model.forward`` count equal to the calls, under each
  ``model.forward`` one ``model.embed`` and ``model.head`` and one
  ``model.attn`` and ``model.ffn`` a layer, and runner
  counters equal to the batch's shape and its mask's zeros; their outputs
  with the tracer on equal those with it off, bit for bit.
"""

import gc
import time
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
from ct_diffusionmodelbench_tpu_torch.utils import profiling as tprof
from tests.torch_port_threads import one_torch_thread  # noqa: F401


def test_off_is_one_shared_no_op(monkeypatch):
    def no_clock():
        raise AssertionError("an off span read the clock")

    monkeypatch.setattr(time, "time_ns", no_clock)
    first, second = tprof.span("a"), tprof.span("b")
    assert first is second
    with first as entered:
        with tprof.span("c"):
            tprof.count("n", 3)
    assert entered is None
    monkeypatch.undo()
    with tprof.tracing() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_spans_nest_with_their_parents():
    with tprof.tracing() as rec:
        with tprof.span("outer"):
            with tprof.span("a"):
                with tprof.span("leaf"):
                    pass
            with tprof.span("b"):
                pass
        with tprof.span("second"):
            pass
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("outer", -1), ("a", 0), ("leaf", 1), ("b", 0), ("second", -1)]
    for s in rec.spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert rec.spans[3].start_ns >= rec.spans[1].end_ns


def test_a_recording_is_freed_when_dropped():
    # A reference cycle would keep every span until a full collection; on
    # an H100 such a pass stalled a traced batch for half a second.
    gc.disable()
    try:
        with tprof.tracing() as rec:
            with tprof.span("outer"):
                with tprof.span("inner"):
                    pass
        gone = weakref.ref(rec)
        del rec
        assert gone() is None
    finally:
        gc.enable()


def test_a_span_closes_when_its_body_raises():
    with tprof.tracing() as rec:
        with pytest.raises(ValueError):
            with tprof.span("outer"):
                with tprof.span("inner"):
                    raise ValueError("x")
        with tprof.span("after"):
            pass
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("outer", -1), ("inner", 0), ("after", -1)]
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)


@pytest.mark.parametrize("kind", [int, np.int64])
def test_counters_sum(kind):
    with tprof.tracing() as rec:
        for n in (3, 4, 0):
            tprof.count("a", kind(n))
        with tprof.span("s"):
            tprof.count("b", kind(7))
    assert rec.counters == {"a": 7, "b": 7}
    assert all(type(v) is int for v in rec.counters.values())


@pytest.mark.parametrize("on", [False, True])
def test_count_refuses_a_tensor(on):
    scope = tprof.tracing() if on else _nothing()
    with scope:
        with pytest.raises(TypeError, match="host integer"):
            tprof.count("a", torch.tensor(3))


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_tracing_does_not_nest():
    with tprof.tracing():
        with pytest.raises(RuntimeError, match="do not nest"):
            with tprof.tracing():
                pass
        assert tprof.span("still on") is not tprof.span("off")
    assert tprof.span("a") is tprof.span("b")


@pytest.mark.parametrize("raises", [False, True])
def test_tracing_turns_off_at_its_exit(raises):
    def body():
        with tprof.tracing() as rec:
            with tprof.span("s"):
                if raises:
                    raise KeyError("x")
        return rec

    if raises:
        with pytest.raises(KeyError):
            body()
    else:
        assert [s.name for s in body().spans] == ["s"]
    assert tprof.span("a") is tprof.span("b")
    with tprof.tracing() as rec:   # a fresh recording each time
        pass
    assert rec.spans == []


def test_spans_share_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof, tprof.tracing() as rec:
        with tprof.span("outer"):
            with record_function("inside"):
                x = torch.ones((64, 64))
                (x @ x).sum()
    [s] = rec.spans
    marks = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside"]
    assert marks
    for e in marks:
        assert s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns


# -- the decode path -----------------------------------------------------

B, P, GEN = 2, 16, 16
DECODES = {
    "fixed": ("llada-tiny", {}, dict(steps=8, block_length=8)),
    "threshold": ("llada-tiny", {}, dict(steps=8, block_length=8, parallel_threshold=0.9,
                                         avoid_eos=True)),
    "cfg": ("llada-tiny", {}, dict(steps=8, block_length=8, cfg_scale=1.0,
                                   temperature=0.5)),
    "block-cache": ("llada-tiny", {"accel": "block-cache"},
                    dict(steps=8, block_length=8)),
    "dream": ("dream-tiny", {}, dict(steps=8, temperature=0.0, alg="entropy")),
}


class _Calls:
    """Counts the model calls the sampler makes through the runner's
    callables, with the positions each runs."""

    def __init__(self, runner):
        self.positions = []
        inner = runner.forward_fn

        def forward(params, ids, *a, **k):
            self.positions.append(ids.shape[0] * ids.shape[1])
            return inner(params, ids, *a, **k)

        runner.forward_fn = forward
        if runner.cached_fns is not None:
            refresh, step, init = runner.cached_fns

            def refresh_(params, x, *a):
                self.positions.append(x.shape[0] * x.shape[1])
                return refresh(params, x, *a)

            def step_(params, blk, *a):
                self.positions.append(blk.shape[0] * blk.shape[1])
                return step(params, blk, *a)

            runner.cached_fns = (refresh_, step_, init)


def _decode(case):
    preset, runner_kw, gen_kw = DECODES[case]
    runner = ModelRunner.random_init(preset, seed=3, device="cpu", **runner_kw)
    rng = np.random.default_rng(11)
    ids = rng.integers(10, 400, size=(B, P)).astype(np.int64)
    mask = np.ones((B, P), np.int32)
    mask[0, :5] = 0                   # a left-padded row
    ids[0, :5] = 0
    if gen_kw.get("avoid_eos"):
        # Random tiny weights may predict the mask id itself, which holds a
        # threshold block open to its last forward; bar it.
        runner.eos_token_id = runner.mask_id
    return runner, ids, mask, dict(gen_kw, gen_length=GEN)


@pytest.mark.parametrize("case", list(DECODES))
def test_decode_span_tree(case):
    runner, ids, mask, kw = _decode(case)
    calls = _Calls(runner)
    with tprof.tracing() as rec:
        runner.generate_ids(ids, attn_mask=mask, **kw)
    spans, counters = rec.spans, rec.counters
    names = [s.name for s in spans]

    def children(i, name):
        return [j for j, s in enumerate(spans) if s.parent == i and s.name == name]

    [gen] = [i for i, n in enumerate(names) if n == "runner.generate"]
    assert spans[gen].parent == -1
    [decode] = children(gen, "sampler.decode")
    assert len(children(gen, "runner.output")) == 1
    steps = [i for i, n in enumerate(names) if n == "sampler.step"]
    passes = len(calls.positions)
    assert passes > 0 and len(steps) == passes == counters["model.forward"]
    assert all(spans[i].parent == decode for i in steps)
    for i in steps:
        assert len(children(i, "model.forward")) == 1
        assert len(children(i, "sampler.select")) >= 1
    assert names.count("model.forward") == passes
    assert {spans[spans[i].parent].name for i, n in enumerate(names)
            if n in ("model.forward", "sampler.select")} == {"sampler.step"}
    assert counters["model.positions"] == sum(calls.positions)
    layers = runner.cfg.num_layers
    for name, per_pass in (("model.embed", 1), ("model.attn", layers),
                           ("model.ffn", layers), ("model.head", 1)):
        found = [i for i, n in enumerate(names) if n == name]
        assert len(found) == per_pass * passes
        assert {names[spans[i].parent] for i in found} == {"model.forward"}
    assert counters["runner.positions"] == B * (P + GEN)
    assert counters["runner.pad_positions"] == int((mask == 0).sum()) == 5
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


@pytest.mark.parametrize("case", list(DECODES))
def test_decode_outputs_do_not_change_with_tracing(case):
    runner, ids, mask, kw = _decode(case)
    off = runner.generate_ids(ids, attn_mask=mask, seed=5, **kw)
    with tprof.tracing() as rec:
        on = runner.generate_ids(ids, attn_mask=mask, seed=5, **kw)
    again = runner.generate_ids(ids, attn_mask=mask, seed=5, **kw)
    assert rec.spans
    assert on.dtype == off.dtype and np.array_equal(on, off) and np.array_equal(again, off)
    assert not (off[:, P:] == runner.mask_id).all()
