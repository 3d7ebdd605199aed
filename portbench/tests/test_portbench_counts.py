"""Each FLOP and byte count against a count made by hand at a tiny shape."""

import pytest
import torch

from portbench.harness import cells
from portbench.harness.counts import forward_flops
from portbench.harness.model import port_config, sizes
from portbench.harness.runtime import Call
from portbench.tests.tiny import TINY_DENSE, TINY_MOE

PEAKS = {"bf16": 1e12, "f32": 1e11, "bytes": 1e9}


def test_forward_flops_by_hand_moe():
    s = sizes(TINY_MOE)   # D 64, H 4 x 16, KV 2 x 16, 8 experts top-2 + 1 shared, Fm 32
    S, d = 10, 64
    per_layer = (2 * S * (64 * 64 + 2 * 64 * 32 + 64 * 64)      # q, k, v, o
                 + 4 * S * S * 64                               # scores, weighted sum
                 + 2 * S * 3 * d * 32 * (2 + 1)                 # routed + shared
                 + 2 * S * d * 8)                               # router
    assert forward_flops(s, S, 4) == 2 * per_layer + 2 * 4 * d * 512


def test_forward_flops_by_hand_dense_full_head():
    s = sizes(TINY_DENSE)  # D 64, 4 heads of 16, FFN 128
    S = 7
    per_layer = 2 * S * 4 * 64 * 64 + 4 * S * S * 64 + 2 * S * 3 * 64 * 128
    assert forward_flops(s, S) == 2 * per_layer + 2 * S * 64 * 512


def test_forward_flops_matches_the_programs_count():
    from ct_diffusionmodelbench_tpu_torch.models.config import get_config

    s = sizes(cells.load_json(cells.PORTBENCH / "configs" / "llada-8b.json"))
    cfg = get_config("llada-8b")
    for seq in (300, 832):
        assert forward_flops(s, seq, 32) == cfg.forward_flops(seq, lm_head_width=32)
    moe = sizes(TINY_MOE)
    cfg = port_config(moe, torch.device("cpu"))
    for seq in (30, 83):
        assert forward_flops(moe, seq, 8) == cfg.forward_flops(seq, lm_head_width=8)


def test_grouped_ffn_least_time_by_hand():
    m = cells.reader("grouped_ffn_roofline.decode")
    s = sizes(TINY_MOE)
    calls = [Call((5, 3), 4)] * 5         # 8 real tokens a pass, 5 passes
    n, k, D, Fm = 8, 2, 64, 32
    flops = 6 * n * k * D * Fm
    moved = 2 * (2 * n * D + 8 * 3 * D * Fm)   # all 8 experts hit (n·k = 16)
    per_layer = max(flops / 1e12, moved / 1e9)
    assert m.least_seconds(s, calls, PEAKS) == pytest.approx(5 * 2 * per_layer)
    # Fewer routed slots than experts: only those experts' weights.
    moved1 = 2 * (2 * 1 * D + 2 * 3 * D * Fm)
    assert m.least_seconds(s, [Call((1,), 4)], PEAKS) == pytest.approx(
        2 * max(6 * 1 * k * D * Fm / 1e12, moved1 / 1e9))


def test_flash_fwd_least_time_by_hand():
    m = cells.reader("flash_fwd_roofline.decode")
    s = sizes(TINY_MOE)                   # H 4, KV 2, Dh 16
    calls = [Call((10, 3), 4)] * 3        # S 10 and 3, 3 passes
    flops = 4 * (100 + 9) * 4 * 16
    moved = 2 * (10 + 3) * (8 + 4) * 16
    assert m.least_seconds(s, calls, PEAKS) == pytest.approx(
        3 * 2 * max(flops / 1e12, moved / 1e9))


def test_dense_gemm_least_time_by_hand():
    m = cells.reader("dense_gemm_roofline.decode")
    s = sizes(TINY_DENSE)                 # D 64, q = kv = 64, F 128, V 512
    calls = [Call((8,), 4)] * 2           # N 8, one row, 2 passes
    n, D, F, V, bl = 8, 64, 128, 512, 4

    def prod(mm, kk, nn, peak, ib, ob):
        return max(2 * mm * kk * nn / peak, (ib * (mm * kk + kk * nn) + ob * mm * nn) / 1e9)

    layer = (prod(n, D, 192, 1e12, 2, 2) + prod(n, 64, D, 1e12, 2, 2)
             + prod(n, D, 2 * F, 1e12, 2, 2) + prod(n, F, D, 1e12, 2, 2))
    head = prod(bl, D, V, 1e12, 2, 4)
    assert m.least_seconds(s, calls, PEAKS) == pytest.approx(2 * (2 * layer + head))
    moe = sizes(TINY_MOE)                 # adds the f32 router, the shared expert as FFN
    layer_moe = (prod(n, D, 64 + 64, 1e12, 2, 2) + prod(n, 64, D, 1e12, 2, 2)
                 + prod(n, D, 8, 1e11, 4, 4)
                 + prod(n, D, 64, 1e12, 2, 2) + prod(n, 32, D, 1e12, 2, 2))
    assert m.least_seconds(moe, calls[:1], PEAKS) == pytest.approx(2 * layer_moe + head)


def test_flash_bwd_least_time_by_hand():
    m = cells.reader("flash_bwd_roofline.train")
    s = sizes(TINY_MOE)                   # H 4, KV 2, Dh 16
    calls = [Call((10,), 10), Call((6,), 6)]
    def row(n):
        flops = 10 * n * n * 4 * 16
        moved = 2 * n * 16 * ((12 + 4) + (4 + 4)) + 4 * n * 4
        return max(flops / 1e12, moved / 1e9)
    assert m.least_seconds(s, calls, PEAKS) == pytest.approx(2 * (row(10) + row(6)))


class _Run:
    """What the mfu readers read of a run."""

    def __init__(self, s, calls):
        self.sizes, self.calls, self.window_s, self.chips = s, calls, 2.0, 1
        self.peaks = PEAKS


def test_mfu_readers_count_every_pass():
    s = sizes(TINY_MOE)
    calls = [Call((10, 7), 4)] * 3 + [Call((9,), 9)]
    flops = 3 * (forward_flops(s, 10, 4) + forward_flops(s, 7, 4)) + forward_flops(s, 9)
    assert cells.reader("mfu.decode").read(_Run(s, calls)) == pytest.approx(
        100 * flops / 2.0 / 1e12)
    assert cells.reader("mfu.train").read(_Run(s, calls)) == pytest.approx(
        300 * flops / 2.0 / 1e12)
    assert cells.reader("mfu.decode").read(_Run(s, [])) is None
