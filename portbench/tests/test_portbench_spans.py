"""The span batch's join (``portbench/harness/spans.py``) on hand-made
events, the four span metrics' readers, and the span batch of a tiny
decode cell on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from portbench.harness import cells, spans
from portbench.span_batch import SPAN_METRICS, span_batch
from portbench.tests.tiny import base

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Event:
    def __init__(self, name, start, end, corr, on_card, annotation=False):
        self._name, self._s, self._e, self._c = name, start, end, corr
        self._dev = CUDA if on_card else CPU
        self._ann = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._ann


def _span(name, start, end, parent):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, parent=parent)


BASE = 1_792_304_093_222_095_449       # a clock reading in ns
# runner.generate [0, 10000] > sampler.decode [100, 9000] > sampler.step
# [200, 5000] > model.forward [300, 4000] and sampler.select [4000, 5000];
# then runner.output [9000, 10000] under runner.generate.
SPANS = [_span("runner.generate", 0, 10_000, -1), _span("sampler.decode", 100, 9_000, 0),
         _span("sampler.step", 200, 5_000, 1), _span("model.forward", 300, 4_000, 2),
         _span("sampler.select", 4_000, 5_000, 2), _span("runner.output", 9_000, 10_000, 0)]
SPANS = [_span(s.name, BASE + s.start_ns, BASE + s.end_ns, s.parent) for s in SPANS]


def _launch(corr, at, card_start, card_end, kernel):
    """A runtime call on the host at ``at`` and the operation it launched;
    a module load inside the call shares its id."""
    return [_Event("cudaLaunchKernel", BASE + at, BASE + at + 5, corr, False),
            _Event("Lazy Function Loading", BASE + at + 1, BASE + at + 3, corr, False),
            _Event(kernel, BASE + card_start, BASE + card_end, corr, True)]


def _events():
    ev = []
    ev += _launch(1, 350, 1_000, 3_000, "nvjet_tss_320x128_64x3_1x2_h_bz_coopB_NNT")
    ev += _launch(2, 360, 3_000, 3_500, "void flash_fwd_kernel<128>")
    ev += _launch(3, 370, 3_600, 4_600, "void at::native::vectorized_elementwise_kernel<4>")
    ev += _launch(4, 4_100, 4_600, 4_900, "void at::native::reduce_kernel<512>")  # select
    ev += _launch(5, 150, 5_200, 5_300, "Memcpy HtoD (Pageable -> Device)")      # decode
    ev += _launch(6, 9_100, 9_400, 9_600, "Memcpy DtoH (Device -> Pageable)")     # output
    ev += _launch(7, 20_000, 20_100, 20_200, "void at::native::fill_kernel")       # outside
    ev.append(_Event("void lost_kernel", BASE + 20_300, BASE + 20_400, 99, True))  # no launch
    ev.append(_Event("gpu_user_annotation", BASE, BASE + 30_000, 0, True, annotation=True))
    return ev


def _slice():
    cls = spans.classifier()
    counters = {"model.forward": 1, "runner.positions": 40, "runner.pad_positions": 6}
    return spans.join(_events(), SPANS, counters, 1e-5, cls)


def test_join_puts_each_operation_under_the_innermost_span_that_launched_it():
    sl = _slice()
    s = sl.spans
    assert s["model.forward"].incl == pytest.approx([2000e-9, 500e-9, 1000e-9])
    assert s["model.forward"].own == s["model.forward"].incl
    assert s["sampler.select"].incl == pytest.approx([0.0, 0.0, 300e-9])
    assert s["sampler.step"].incl == pytest.approx([2000e-9, 500e-9, 1300e-9])
    assert sum(s["sampler.step"].own) == 0.0
    assert s["sampler.decode"].own == pytest.approx([0.0, 0.0, 100e-9])
    assert s["sampler.decode"].incl == pytest.approx([2000e-9, 500e-9, 1400e-9])
    assert s["runner.output"].incl == pytest.approx([0.0, 0.0, 200e-9])
    assert sum(s["runner.generate"].incl) == pytest.approx(4100e-9)
    assert s[spans.OUTSIDE].incl == pytest.approx([0.0, 0.0, 100e-9])
    assert sl.unlaunched_s == pytest.approx(100e-9)
    assert {k: v.n for k, v in s.items()} == {
        "runner.generate": 1, "sampler.decode": 1, "sampler.step": 1, "model.forward": 1,
        "sampler.select": 1, "runner.output": 1, spans.OUTSIDE: 0}
    assert sl.seconds("model.forward", "other") == pytest.approx(1000e-9)
    assert sl.seconds("model.forward", "gemm", "attention") == pytest.approx(2500e-9)
    assert sl.seconds("nothing") == 0.0
    top = sl.top(3)
    assert [row[0] for row in top] == ["runner.generate", "sampler.decode", "sampler.step"]
    assert top[2][1:] == pytest.approx([1, 3800e-9, 0.0, 2000e-9, 500e-9, 1300e-9])


def test_join_labels_every_idle_gap_by_the_span_open_when_it_starts():
    sl = _slice()
    # Busy: [1000, 3500], [3600, 4900], [5200, 5300], [9400, 9600],
    # [20100, 20200], [20300, 20400] (the unlaunched operation counts).
    assert sl.busy_s == pytest.approx(4300e-9)
    got = [(label, round(sec * 1e9)) for label, sec in sl.gaps]
    assert got == [("runner.output", 10_500), ("sampler.decode", 4_100),
                   ("sampler.select", 300), ("model.forward", 100), (spans.OUTSIDE, 100)]
    idle = sl.idle(2)
    assert [label for label, _ in idle["longest"]] == ["runner.output", "sampler.decode"]
    assert dict(idle["by_span"])[spans.OUTSIDE] == pytest.approx(100e-9)
    assert len(idle["by_span"]) == 5


def test_join_without_spans_puts_everything_outside():
    sl = spans.join(_events(), [], {}, 1e-5, spans.classifier())
    assert set(sl.spans) == {spans.OUTSIDE}
    assert sl.seconds(spans.OUTSIDE) == pytest.approx(4200e-9)
    assert {label for label, _ in sl.gaps} == {spans.OUTSIDE}


def test_innermost_follows_nesting_and_siblings():
    s = [_span("a", 0, 10, -1), _span("b", 2, 4, 0), _span("c", 6, 8, 0),
         _span("d", 20, 30, -1)]
    assert spans.innermost(s, [0, 3, 5, 7, 9, 10, 15, 25, 31]) == [0, 1, 0, 2, 0, 0, -1, 3, -1]


EXPECTED = {"sampler_share.decode": 100 * 300 / 4300,
            "model_glue_share.decode": 100 * 1000 / 4300,
            "forward_ms.decode": 1e3 * 3500e-9,
            "pad_share.decode": 100 * 6 / 40}


@pytest.mark.parametrize("name", list(EXPECTED))
def test_each_span_metric_reads_a_hand_made_slice(name):
    read = cells.reader(name).read
    assert read(SimpleNamespace(span_slice=_slice())) == pytest.approx(EXPECTED[name])
    assert read(SimpleNamespace(span_slice=None)) is None
    assert read(SimpleNamespace()) is None          # a run with no span batch
    empty = spans.join([], [], {}, 0.0, spans.classifier())
    assert read(SimpleNamespace(span_slice=empty)) is None


def test_the_tiny_cell_has_a_span_batch_on_the_cpu(tmp_path):
    pb = base(tmp_path)
    cell = cells.cell("tiny-dense-eval", base=pb)
    out = span_batch(cell, 2**31 + 11, torch.device("cpu"), pairs=1, base=pb)
    steps = cell.traffic["generate"]["steps"]
    assert out["passes"] == {"model.forward": steps, "recorder": steps}
    assert len(out["walls_s"]["off"]) == len(out["walls_s"]["on"]) == 2
    counters = out["span_batch"]["counters"]
    assert counters["runner.positions"] == 4 * (64 + cell.traffic["generate"]["gen_length"])
    assert set(out["metrics"]) == {"pad_share.decode"}    # no device trace on the CPU
    assert out["metrics"]["pad_share.decode"]["value"] == pytest.approx(
        100 * counters["runner.pad_positions"] / counters["runner.positions"])
    assert {m["name"] for m in SPAN_METRICS} == set(EXPECTED)
