"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; each test asks the ``cuda_device`` fixture, which skips
when no card is present (decided at run time, never at import).  On a
machine with a card and no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances: kernel and plain version take the same bf16 inputs, accumulate
in f32 and round once to bf16, so they differ by at most one bf16 ulp
(2**-7 relative) plus an absolute floor (the int8 pair likewise: int8
weights are exact in bf16, and both versions scale the f32 product before
the one rounding); flash attention also rounds P to
bf16 against differently tiled running maxima (two ulps).  The forward's
lse is f32 from scores and sums taken in another order than the plain
version's (and, in K9's case, may fuse the rotation's multiply-add where
PyTorch rounds twice): 2e-3 absolute.
The backward's f32 outputs sum products of bf16-rounded P and dS, whose
f32 sources differ in their last bits between the two versions; a flipped
rounding moves one term by one bf16 ulp (2**-8 relative), so each result
stays within 2**-6 relative plus 2**-8 of the tensor's largest magnitude.
"""

import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn
from ct_diffusionmodelbench_tpu_torch.models import moe
from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope, rope_angles
from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions
from ct_diffusionmodelbench_tpu_torch.ops import attention
from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts
from ct_diffusionmodelbench_tpu_torch.ops.quant import quantize_tensor, quantized_leaf_transform
from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate
from ct_diffusionmodelbench_tpu_torch.train.trainer import (
    TrainConfig, make_optimizer, make_train_step)

pytestmark = pytest.mark.cuda

GROUPED_TOL = dict(rtol=2 ** -7, atol=1e-3)
FLASH_TOL = dict(rtol=2 ** -6, atol=4e-3)
LSE_TOL = dict(rtol=0.0, atol=2e-3)
SERVING_KERNELS = ("grouped_gateup", "grouped_down", "flash_attention_fwd")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _routing(dev, n, d, e, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev, dtype=torch.bfloat16)
    idx = torch.randint(0, e, (n, k), generator=g, device=dev)
    return x, idx, g


@pytest.mark.parametrize("d,f,layers", [(64, 32, None), (128, 96, 3), (256, 200, 2)])
def test_grouped_kernels_match_plain(cuda_device, d, f, layers):
    dev, e, k = cuda_device, 8, 2
    x, idx, g = _routing(dev, 100, d, e, k, d + f)
    lead = () if layers is None else (layers,)
    wg, wu = (torch.randn(lead + (e, d, f), generator=g, device=dev,
                          dtype=torch.bfloat16) / d ** 0.5 for _ in range(2))
    wd = torch.randn(lead + (e, f, d), generator=g, device=dev,
                     dtype=torch.bfloat16) / f ** 0.5
    li = None if layers is None else layers - 1
    dest, te, _, m_pad = gg.counting_layout(idx, e, gg.TILE_M)
    xs = gg.gather_rows(x, dest, k, m_pad)
    h = gg.grouped_gateup(xs, wg, wu, te, gg.TILE_M, li)
    torch.testing.assert_close(
        h, gg.grouped_gateup_plain(xs, wg, wu, te, gg.TILE_M, li), **GROUPED_TOL)
    o = gg.grouped_down(h, wd, te, gg.TILE_M, li)
    torch.testing.assert_close(
        o, gg.grouped_down_plain(h, wd, te, gg.TILE_M, li), **GROUPED_TOL)


# The grouped pairs' schedule (csrc/grouped_gemm.cu, csrc/grouped_gemm_q.cu):
# a block takes the 64-row tiles 2y, 2y + 1 as one n128 pass when one expert
# owns both, else one n64 pass each, or zeros for a tile that tile_valid
# marks empty.  The bf16 pair runs it on TMA loads and shared-memory wgmma
# (the weight box an MN-major A, x the K-major B), the int8 pair on
# cp.async and register-A wgmma.

def _routing_of_sizes(dev, sizes, d, seed):
    """Top-1 routing with exactly sizes[e] rows on expert e, seeded order."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.repeat_interleave(torch.arange(len(sizes), device=dev),
                                   torch.tensor(sizes, device=dev))
    idx = flat[torch.randperm(flat.numel(), generator=g, device=dev)][:, None]
    x = torch.randn((flat.numel(), d), generator=g, device=dev, dtype=torch.bfloat16)
    return x, idx, g



def _bf16_experts(g, dev, lead, e, k_dim, n_dim):
    return torch.randn(lead + (e, k_dim, n_dim), generator=g, device=dev,
                       dtype=torch.bfloat16) / k_dim ** 0.5


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("d,f,layers,tile_m,sizes", [
    (256, 384, 3, 64, [30, 100, 0, 64, 130, 1, 65, 10]),
    (128, 256, None, 128, [200, 30, 0, 300, 10, 0, 0, 90]),
    (128, 128, 2, 64, [0, 0, 0, 0, 0, 300, 0, 0]),
], ids=["odd_runs_last_layer", "tile_m_128", "one_expert"])
def test_grouped_kernel_schedule_edges(cuda_device, d, f, layers, tile_m, sizes,
                                       with_valid):
    """The int8 pair's schedule edges for the bf16 pair: tile pairs split
    across experts, an odd tile count, tile_m 128, one expert, the last of
    3 layers; with the pad-skip vector the real rows match and the rest is
    zero."""
    dev, e = cuda_device, len(sizes)
    x, idx, g = _routing_of_sizes(dev, sizes, d, d + f + tile_m)
    lead = () if layers is None else (layers,)
    wg, wu = (_bf16_experts(g, dev, lead, e, d, f) for _ in range(2))
    wd = _bf16_experts(g, dev, lead, e, f, d)
    li = None if layers is None else layers - 1
    dest, te, got_sizes, m_pad = gg.counting_layout(idx, e, tile_m)
    assert got_sizes.tolist() == sizes
    valid = gg.valid_tiles(got_sizes, te, tile_m, m_pad)
    assert bool((valid[-1] == 0).item())
    tv = valid if with_valid else None
    xs = gg.gather_rows(x, dest, 1, m_pad)
    reset_launch_counts()
    h = gg.grouped_gateup(xs, wg, wu, te, tile_m, li, tv)
    h_p = gg.grouped_gateup_plain(xs, wg, wu, te, tile_m, li, tv)
    torch.testing.assert_close(h, h_p, **GROUPED_TOL)
    o = gg.grouped_down(h_p, wd, te, tile_m, li, tv)
    torch.testing.assert_close(
        o, gg.grouped_down_plain(h_p, wd, te, tile_m, li, tv), **GROUPED_TOL)
    assert KERNELS["grouped_gateup"].launches == KERNELS["grouped_down"].launches == 1
    if with_valid:
        empty = valid.repeat_interleave(tile_m) == 0
        assert not h[empty].any() and not o[empty].any()
        real = ~empty
        assert torch.equal(h[real], gg.grouped_gateup(xs, wg, wu, te, tile_m, li)[real])


def _ints(g, dev, shape, lo, hi, scale):
    """bf16 integers in [lo, hi) times ``scale`` (a power of two)."""
    return (torch.randint(lo, hi, shape, generator=g, device=dev) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("d,f,layers,e", [(256, 384, None, 8), (2048, 896, 2, 64)])
def test_grouped_kernels_exact_arithmetic(cuda_device, d, f, layers, e):
    """Integers in [-8, 8] times 2**-7 (x, h) and times 2**-5 (weights):
    every sum over K <= 2048 stays below 2**18 units of 2**-12, exact in f32
    in any order, so a wrong descriptor, swizzle or box gives a wrong number,
    never a rounding.  The down kernel is bit-equal to its plain version;
    gate/up within one bf16 ulp (the SiLU's exp)."""
    dev = cuda_device
    _, idx, g = _routing(dev, 300, d, e, 2, d + f + e)
    lead = () if layers is None else (layers,)
    x = _ints(g, dev, (300, d), -8, 9, 2 ** -7)
    wg, wu = (_ints(g, dev, lead + (e, d, f), -8, 9, 2 ** -5) for _ in range(2))
    wd = _ints(g, dev, lead + (e, f, d), -8, 9, 2 ** -5)
    li = None if layers is None else layers - 1
    dest, te, _, m_pad = gg.counting_layout(idx, e, gg.TILE_M)
    xs = gg.gather_rows(x, dest, 2, m_pad)
    h = gg.grouped_gateup(xs, wg, wu, te, gg.TILE_M, li)
    torch.testing.assert_close(
        h, gg.grouped_gateup_plain(xs, wg, wu, te, gg.TILE_M, li), rtol=2 ** -7, atol=0.0)
    h_in = _ints(g, dev, (m_pad, f), -8, 9, 2 ** -7)
    assert torch.equal(gg.grouped_down(h_in, wd, te, gg.TILE_M, li),
                       gg.grouped_down_plain(h_in, wd, te, gg.TILE_M, li))


@pytest.mark.parametrize("layers", [None, 2])
def test_grouped_kernels_k_tail_reads_no_neighbour(cuda_device, layers):
    """K = 200 (three full 64-deep steps and a tail of 8): the rows k >= K
    of an expert's box must be zeros, not the next expert's first rows.
    Experts 1, 3 and 5 (and, stacked, the layer after the one used) hold
    +inf and own no row (the trailing padding tiles belong to the last
    expert, which has rows), so a read past an expert's end turns 0 * inf
    into NaN; with exact inputs the outputs equal the plain versions'."""
    dev, d, f = cuda_device, 200, 200
    sizes = [100, 0, 70, 0, 130, 0, 10, 40]
    e = len(sizes)
    x, idx, g = _routing_of_sizes(dev, sizes, d, 17)
    lead = () if layers is None else (layers,)
    x = _ints(g, dev, x.shape, -8, 9, 2 ** -7)
    wg, wu = (_ints(g, dev, lead + (e, d, f), -8, 9, 2 ** -5) for _ in range(2))
    wd = _ints(g, dev, lead + (e, f, d), -8, 9, 2 ** -5)
    for w in (wg, wu, wd):
        w[..., 1:6:2, :, :] = float("inf")
        if layers is not None:
            w[1:] = float("inf")
    li = None if layers is None else 0
    dest, te, _, m_pad = gg.counting_layout(idx, e, gg.TILE_M)
    xs = gg.gather_rows(x, dest, 1, m_pad)
    h = gg.grouped_gateup(xs, wg, wu, te, gg.TILE_M, li)
    assert bool(torch.isfinite(h).all())
    torch.testing.assert_close(
        h, gg.grouped_gateup_plain(xs, wg, wu, te, gg.TILE_M, li), rtol=2 ** -7, atol=0.0)
    h_in = _ints(g, dev, (m_pad, f), -8, 9, 2 ** -7)
    o = gg.grouped_down(h_in, wd, te, gg.TILE_M, li)
    assert bool(torch.isfinite(o).all())
    assert torch.equal(o, gg.grouped_down_plain(h_in, wd, te, gg.TILE_M, li))


@pytest.mark.parametrize("rows", [64, 128])
def test_grouped_wgmma_rehearsal_single_tile(cuda_device, rows):
    """One tile of one expert through the down kernel (one n64 pass at 64
    rows, one n128 pass at 128; 64 of the block's 256 columns, the rest
    past the ragged edge): the weight box as the MN-major A of a
    shared-memory wgmma, x as the K-major B, against torch.matmul.  Exact
    sums, so bit-equal."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(rows)
    x = _ints(g, dev, (rows, 64), -8, 9, 2 ** -7)
    w = _ints(g, dev, (1, 64, 64), -8, 9, 2 ** -5)
    te = torch.zeros(rows // 64, dtype=torch.int32, device=dev)
    out = gg.grouped_down(x, w, te, 64)
    assert torch.equal(out, torch.matmul(x.float(), w[0].float()).to(torch.bfloat16))


def test_bf16_ffn_hands_kernels_tile_valid(cuda_device, monkeypatch):
    """The bf16 expert FFN gives both kernels the pad-skip vector; its output
    is the same as with none."""
    dev, e = cuda_device, 8
    x, idx, g = _routing(dev, 150, 256, e, 2, 12)
    probs = torch.rand(idx.shape, generator=g, device=dev)
    ws = [_bf16_experts(g, dev, (), e, 256, 128), _bf16_experts(g, dev, (), e, 256, 128),
          _bf16_experts(g, dev, (), e, 128, 256)]
    seen = []

    def recording(kernel, keep):
        def run(*args):
            seen.append(args[-1])
            return kernel(*args[:-1], args[-1] if keep else None)
        return run

    gateup, down = gg.grouped_gateup, gg.grouped_down
    monkeypatch.setattr(gg, "grouped_gateup", recording(gateup, False))
    monkeypatch.setattr(gg, "grouped_down", recording(down, False))
    want = gg.grouped_expert_ffn_cuda(x, probs, idx, *ws)
    monkeypatch.setattr(gg, "grouped_gateup", recording(gateup, True))
    monkeypatch.setattr(gg, "grouped_down", recording(down, True))
    assert torch.equal(gg.grouped_expert_ffn_cuda(x, probs, idx, *ws), want)
    assert all(v is not None for v in seen) and bool((seen[0] == 0).any())


def test_bf16_wrappers_refuse_bad_tile_valid(cuda_device):
    dev = cuda_device
    x = torch.zeros((128, 64), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((2, 64, 64), device=dev, dtype=torch.bfloat16)
    te = torch.zeros(2, dtype=torch.int32, device=dev)
    for bad in (torch.ones(2, dtype=torch.int64, device=dev),
                torch.ones(3, dtype=torch.int32, device=dev)):
        with pytest.raises(ValueError, match="tile_valid"):
            gg.grouped_gateup(x, w, w, te, 64, None, bad)
        with pytest.raises(ValueError, match="tile_valid"):
            gg.grouped_down(x, w, te, 64, None, bad)


def _int8_experts(g, dev, lead, e, k_dim, n_dim):
    w = torch.randn(lead + (e, k_dim, n_dim), generator=g, device=dev) / k_dim ** 0.5
    return quantize_tensor(w)


@pytest.mark.parametrize("d,f,layers,e,skew", [
    (128, 128, None, 8, False),     # flat
    (256, 384, 3, 8, False),        # layer-stacked, several column tiles
    (64, 48, 2, 16, True),          # ragged: most experts empty, N % 16 only
])
def test_int8_grouped_kernels_match_plain(cuda_device, d, f, layers, e, skew):
    dev, k = cuda_device, 2
    x, idx, g = _routing(dev, 100, d, e, k, d + f + e)
    if skew:
        idx = torch.where(idx < e // 2, idx % 3, idx)   # experts 3 .. e/2-1 empty
    lead = () if layers is None else (layers,)
    qg, qu = (_int8_experts(g, dev, lead, e, d, f) for _ in range(2))
    qd = _int8_experts(g, dev, lead, e, f, d)
    li = None if layers is None else layers - 1
    dest, te, sizes, m_pad = gg.counting_layout(idx, e, gg.TILE_M)
    if skew:
        assert int((sizes == 0).sum()) >= e // 2 - 3
    xs = gg.gather_rows(x, dest, k, m_pad)
    reset_launch_counts()
    h = gg.grouped_gateup_q(xs, qg, qu, te, gg.TILE_M, li)
    torch.testing.assert_close(
        h, gg.grouped_gateup_q_plain(xs, qg, qu, te, gg.TILE_M, li), **GROUPED_TOL)
    o = gg.grouped_down_q(h, qd, te, gg.TILE_M, li)
    torch.testing.assert_close(
        o, gg.grouped_down_q_plain(h, qd, te, gg.TILE_M, li), **GROUPED_TOL)
    assert KERNELS["grouped_gateup_q"].launches == 1
    assert KERNELS["grouped_down_q"].launches == 1
    assert KERNELS["grouped_gateup"].launches == 0


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("d,f,layers,tile_m,sizes", [
    # odd runs of 64-row tiles (pairs span two experts), an odd tile count
    # (the last pair is one tile), a pair of one real and one padding tile
    # of the same expert; the last of 3 layers
    (256, 384, 3, 64, [30, 100, 0, 64, 130, 1, 65, 10]),
    (128, 256, None, 128, [200, 30, 0, 300, 10, 0, 0, 90]),     # tile_m 128
    (128, 128, 2, 64, [0, 0, 0, 0, 0, 300, 0, 0]),               # one expert
], ids=["odd_runs_last_layer", "tile_m_128", "one_expert"])
def test_int8_grouped_kernel_schedule_edges(cuda_device, d, f, layers, tile_m, sizes,
                                            with_valid):
    dev, e = cuda_device, len(sizes)
    x, idx, g = _routing_of_sizes(dev, sizes, d, d + f + tile_m)
    lead = () if layers is None else (layers,)
    qg, qu = (_int8_experts(g, dev, lead, e, d, f) for _ in range(2))
    qd = _int8_experts(g, dev, lead, e, f, d)
    li = None if layers is None else layers - 1
    dest, te, got_sizes, m_pad = gg.counting_layout(idx, e, tile_m)
    assert got_sizes.tolist() == sizes
    valid = gg.valid_tiles(got_sizes, te, tile_m, m_pad)
    assert bool((valid[-1] == 0).item())        # trailing all-padding tiles
    tv = valid if with_valid else None
    xs = gg.gather_rows(x, dest, 1, m_pad)
    reset_launch_counts()
    h = gg.grouped_gateup_q(xs, qg, qu, te, tile_m, li, tv)
    h_p = gg.grouped_gateup_q_plain(xs, qg, qu, te, tile_m, li, tv)
    torch.testing.assert_close(h, h_p, **GROUPED_TOL)
    o = gg.grouped_down_q(h_p, qd, te, tile_m, li, tv)
    torch.testing.assert_close(
        o, gg.grouped_down_q_plain(h_p, qd, te, tile_m, li, tv), **GROUPED_TOL)
    assert KERNELS["grouped_gateup_q"].launches == KERNELS["grouped_down_q"].launches == 1
    if with_valid:
        empty = valid.repeat_interleave(tile_m) == 0
        assert not h[empty].any() and not o[empty].any()
        real = ~empty
        assert torch.equal(h[real], gg.grouped_gateup_q(xs, qg, qu, te, tile_m, li)[real])


@pytest.mark.parametrize("d,f,layers,e", [(256, 384, None, 8), (2048, 896, 2, 64)])
def test_int8_grouped_kernels_exact_arithmetic(cuda_device, d, f, layers, e):
    """Integers in [-8, 8] times 2**-7 against int8 weights over their whole
    range: every sum over K <= 2048 stays below 2**21 units of 2**-7, exact
    in f32 in any order, so a wrong descriptor, swizzle, column order or
    widening gives a wrong number, never a rounding.  The down kernel is
    bit-equal to its plain version; gate/up within one bf16 ulp (the SiLU's
    exp)."""
    dev = cuda_device
    x, idx, g = _routing(dev, 300, d, e, 2, d + f + e)
    lead = () if layers is None else (layers,)

    def ints(shape, lo, hi, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=dtype)

    def experts(k_dim, n_dim):
        return {"q": ints(lead + (e, k_dim, n_dim), -128, 128, torch.int8),
                "s": torch.rand(lead + (e, n_dim), generator=g, device=dev) * 0.1 + 0.01}

    x = (ints(x.shape, -8, 9) * 2 ** -7).to(torch.bfloat16)
    qg, qu, qd = experts(d, f), experts(d, f), experts(f, d)
    li = None if layers is None else layers - 1
    dest, te, _, m_pad = gg.counting_layout(idx, e, gg.TILE_M)
    xs = gg.gather_rows(x, dest, 2, m_pad)
    h = gg.grouped_gateup_q(xs, qg, qu, te, gg.TILE_M, li)
    torch.testing.assert_close(
        h, gg.grouped_gateup_q_plain(xs, qg, qu, te, gg.TILE_M, li), rtol=2 ** -7, atol=0.0)
    h_in = (ints((m_pad, f), -8, 9) * 2 ** -7).to(torch.bfloat16)
    assert torch.equal(gg.grouped_down_q(h_in, qd, te, gg.TILE_M, li),
                       gg.grouped_down_q_plain(h_in, qd, te, gg.TILE_M, li))


@pytest.mark.parametrize("rows", [64, 128])
def test_int8_wgmma_rehearsal_single_tile(cuda_device, rows):
    """One tile of one expert through the down kernel (one n64 pass at 64
    rows, one n128 pass at 128; 64 of the block's 256 columns, the rest
    past the ragged edge): the int8 A widened in registers (every
    int8 value, -128 included), x as the K-major B, against torch.matmul on
    the widened tile.  Exact sums with unit scales, so bit-equal."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(rows)
    x = (torch.randint(-8, 9, (rows, 64), generator=g, device=dev) * 2 ** -7).to(torch.bfloat16)
    q = torch.randint(-128, 128, (1, 64, 64), generator=g, device=dev, dtype=torch.int8)
    q[0, 0, 0] = -128
    w = {"q": q, "s": torch.ones((1, 64), device=dev)}
    te = torch.zeros(rows // 64, dtype=torch.int32, device=dev)
    out = gg.grouped_down_q(x, w, te, 64)
    assert torch.equal(out, torch.matmul(x.float(), q[0].float()).to(torch.bfloat16))


def test_int8_ffn_hands_kernels_tile_valid(cuda_device, monkeypatch):
    """The int8 expert FFN gives both kernels the pad-skip vector; its output
    is the same as with none."""
    dev, e = cuda_device, 8
    x, idx, g = _routing(dev, 150, 256, e, 2, 11)
    probs = torch.rand(idx.shape, generator=g, device=dev)
    ws = [_int8_experts(g, dev, (), e, 256, 128), _int8_experts(g, dev, (), e, 256, 128),
          _int8_experts(g, dev, (), e, 128, 256)]
    seen = []

    def recording(kernel, keep):
        def run(*args):
            seen.append(args[-1])
            return kernel(*args[:-1], args[-1] if keep else None)
        return run

    gateup, down = gg.grouped_gateup_q, gg.grouped_down_q
    monkeypatch.setattr(gg, "grouped_gateup_q", recording(gateup, False))
    monkeypatch.setattr(gg, "grouped_down_q", recording(down, False))
    want = gg.grouped_expert_ffn_cuda(x, probs, idx, *ws)
    monkeypatch.setattr(gg, "grouped_gateup_q", recording(gateup, True))
    monkeypatch.setattr(gg, "grouped_down_q", recording(down, True))
    assert torch.equal(gg.grouped_expert_ffn_cuda(x, probs, idx, *ws), want)
    assert all(v is not None for v in seen) and bool((seen[0] == 0).any())


def test_int8_wrappers_refuse_bad_tile_valid(cuda_device):
    dev = cuda_device
    x = torch.zeros((128, 64), device=dev, dtype=torch.bfloat16)
    w = quantize_tensor(torch.randn((2, 64, 64), device=dev))
    te = torch.zeros(2, dtype=torch.int32, device=dev)
    for bad in (torch.ones(2, dtype=torch.int64, device=dev),
                torch.ones(3, dtype=torch.int32, device=dev)):
        with pytest.raises(ValueError, match="tile_valid"):
            gg.grouped_gateup_q(x, w, w, te, 64, None, bad)
        with pytest.raises(ValueError, match="tile_valid"):
            gg.grouped_down_q(x, w, te, 64, None, bad)


def _kernels_against_plain(cfg, params, ids, dev, monkeypatch, seams):
    """Logits of a forward through the kernels and of the same forward with
    ``seams`` ((module, name, plain version) swapped in).  The second run
    takes the first one's expert choice in every layer: a one-ulp
    difference at a router input decides a near-tie of the top-k-th and the
    next expert now and then, which moves that token's logits by far more
    than any kernel error (chip_smoke.py's 2-layer checks do the same)."""
    router_probs, chosen = moe.router_probs, []

    def recording_router(x, w, top_k, norm_topk):
        out = router_probs(x, w, top_k, norm_topk)
        chosen.append(out[1])
        return out

    def pinned_router(x, w, top_k, norm_topk):
        _, _, probs = router_probs(x, w, top_k, norm_topk)
        idx = chosen.pop(0)
        topk_probs = probs.gather(-1, idx)
        if norm_topk:
            topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True)
        return topk_probs, idx, probs

    with monkeypatch.context() as m:
        m.setattr(moe, "router_probs", recording_router)
        lk, _ = make_forward_fn(cfg, device=dev)(params, ids)
    with monkeypatch.context() as m:
        m.setattr(moe, "router_probs", pinned_router)
        for module, name, plain in seams:
            m.setattr(module, name, plain)
        lp, _ = make_forward_fn(cfg, device=dev)(params, ids)
    assert not chosen
    return lk, lp


def test_int8_ffn_and_tiny_model_against_plain(cuda_device, monkeypatch):
    """The int8 expert FFN and an aligned tiny int8 model: kernels against
    plain versions, and a greedy decode through the int8 pair only."""
    dev = cuda_device
    cfg = get_config("llada-moe-tiny", hidden_size=128, moe_intermediate_size=128,
                     head_dim=32)                               # bf16
    params = init_params(cfg, seed=6, device=dev, leaf_transform=quantized_leaf_transform)
    ids = torch.randint(3, 400, (2, 40), device=dev)
    lk, lp = _kernels_against_plain(cfg, params, ids, dev, monkeypatch, [
        (attention, "flash_attention", fa.flash_attention_plain),
        (gg, "grouped_gateup_q", gg.grouped_gateup_q_plain),
        (gg, "grouped_down_q", gg.grouped_down_q_plain)])
    assert (lk - lp).abs().max() <= 2 ** -4 * lp.abs().max()
    reset_launch_counts()
    out = llada_generate(make_forward_fn(cfg, device=dev), params, ids[:, :8],
                         steps=8, gen_length=16, block_length=8,
                         mask_id=cfg.mask_token_id)
    assert not (out[:, 8:] == cfg.mask_token_id).any()
    launches = {n: kk.launches for n, kk in KERNELS.items()}
    want = cfg.num_layers * 8
    assert (launches["grouped_gateup_q"], launches["grouped_down_q"],
            launches["flash_attention_fwd"]) == (want, want, want)
    assert launches["grouped_gateup"] == launches["grouped_down"] == 0


def test_int8_wrappers_refuse_grad_and_bad_scales(cuda_device):
    dev = cuda_device
    x = torch.zeros((64, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = quantize_tensor(torch.randn((2, 64, 64), device=dev))
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        gg.grouped_gateup_q(x, w, w, te)
    with pytest.raises(NotImplementedError, match="no backward"):
        gg.grouped_down_q(x, w, te)
    probs = torch.ones((4, 1), device=dev)
    idx = torch.zeros((4, 1), dtype=torch.long, device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        gg.grouped_expert_ffn_cuda(x[:4], probs, idx, w, w, w)
    with torch.no_grad():
        assert gg.grouped_gateup_q(x, w, w, te).shape == (64, 64)
        bad = {"q": w["q"], "s": w["s"].to(torch.bfloat16)}
        with pytest.raises(ValueError, match="f32"):
            gg.grouped_down_q(x, bad, te)


def test_grouped_kernel_raises_on_f32(cuda_device):
    x = torch.zeros((64, 64), device=cuda_device)
    w = torch.zeros((2, 64, 64), device=cuda_device)
    te = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        gg.grouped_gateup(x, w, w, te)


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("h,kv,s", [(4, 2, 37), (8, 2, 130), (4, 4, 64)])
def test_flash_kernel_matches_plain(cuda_device, dh, h, kv, s):
    dev, b = cuda_device, 3
    g = torch.Generator(device=dev).manual_seed(dh + s)
    q = torch.randn((b, s, h, dh), generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn((b, s, kv, dh), generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn((b, s, kv, dh), generator=g, device=dev, dtype=torch.bfloat16)
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[1, :5] = 0
    mask[2] = 0  # every key masked: the padded keys of the reference count
    cos, sin = rope_angles(token_positions(mask, b, s, dev), dh, 10000.0)
    for rope in (None, (cos, sin)):
        got = fa.flash_attention(q, k, v, mask=mask, rope=rope)
        want = fa.flash_attention_plain(q, k, v, mask=mask, rope=rope)
        torch.testing.assert_close(got, want, **FLASH_TOL)


def test_tiny_model_kernels_against_plain(cuda_device, monkeypatch):
    cfg = get_config("llada-moe-tiny")  # bf16
    params = init_params(cfg, seed=3, device=cuda_device)
    ids = torch.randint(3, 400, (2, 40), device=cuda_device)
    lk, lp = _kernels_against_plain(cfg, params, ids, cuda_device, monkeypatch, [
        (attention, "flash_attention", fa.flash_attention_plain),
        (gg, "grouped_gateup", gg.grouped_gateup_plain),
        (gg, "grouped_down", gg.grouped_down_plain)])
    assert (lk - lp).abs().max() <= 2 ** -4 * lp.abs().max()
    reset_launch_counts()
    out = llada_generate(make_forward_fn(cfg, device=cuda_device), params,
                         ids[:, :8], steps=8, gen_length=16, block_length=8,
                         mask_id=cfg.mask_token_id)
    assert not (out[:, 8:] == cfg.mask_token_id).any()
    launches = {n: kk.launches for n, kk in KERNELS.items()}
    assert {n: launches[n] for n in SERVING_KERNELS} == {
        n: cfg.num_layers * 8 for n in SERVING_KERNELS}
    assert launches["flash_attention_bwd_dq"] == 0


def _bwd_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2 ** -6,
                                   atol=2 ** -8 * float(w.abs().max()))


def _attn_case(dev, b, s, h, kv, dh, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((b, s, h, dh), generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, s, kv, dh), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[1, :5] = 0
    mask[2] = 0  # every key masked
    return q, k, v, do, mask


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])   # GQA rep 1 and 4
@pytest.mark.parametrize("s", [37, 300, 2048])
def test_flash_lse_and_backward_kernels_match_plain(cuda_device, dh, h, kv, s):
    dev = cuda_device
    q, k, v, do, mask = _attn_case(dev, 3, s, h, kv, dh, dh + s + h)
    cos, sin = rope_angles(token_positions(mask, 3, s, dev), dh, 10000.0)
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, rope=(cos, sin),
                                       with_lse=True)
    out_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=(cos, sin),
                                            with_lse=True)
    torch.testing.assert_close(out, out_p, **FLASH_TOL)
    torch.testing.assert_close(lse, lse_p, **LSE_TOL)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, mask=mask,
                                                    rope=(cos, sin)))
    bias = fa.mask_bias(mask, 3, s, dev)
    got = fab.flash_attention_bwd(q, k, v, bias, out, do, lse)
    _bwd_close(got, fab.flash_attention_bwd_plain(q, k, v, bias, out, do, lse))
    masked_keys = mask[:2] == 0  # rows of batch 2 see every key with p = 1
    assert not got[1][:2][masked_keys].any() and not got[2][:2][masked_keys].any()


@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 1023, 1025])
def test_flash_kernel_tile_edges(cuda_device, s):
    """The forward where its 64-row query tiles and 64-key tiles end, and
    across the kv_tile_len switch at 1024 (1023 pads to 1024 keys, 1025 to
    1536), with the all-masked row; lse too."""
    dev = cuda_device
    q, k, v, _, mask = _attn_case(dev, 3, s, 8, 2, 128, 3 * s)
    rope = rope_angles(token_positions(mask, 3, s, dev), 128, 10000.0)
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope, with_lse=True)
    out_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=rope, with_lse=True)
    torch.testing.assert_close(out, out_p, **FLASH_TOL)
    torch.testing.assert_close(lse, lse_p, **LSE_TOL)


@pytest.mark.parametrize("h,kv", [(16, 4), (28, 4)])  # llada-moe-7b's heads; rep 7 (Dream)
def test_flash_kernel_decode_shape(cuda_device, h, kv):
    """The forward at the decode path's shape: B 8, S 320 (384 keys after
    padding, a whole tile of zero keys), left padding of 0, 4, ..., 28
    tokens, RoPE; two calls bit-equal."""
    dev, b, s, dh = cuda_device, 8, 320, 128
    g = torch.Generator(device=dev).manual_seed(h)
    q = torch.randn((b, s, h, dh), generator=g, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, kv, dh), generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    for i in range(b):
        mask[i, :4 * i] = 0
    rope = rope_angles(token_positions(mask, b, s, dev), dh, 10000.0)
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope, with_lse=True)
    out_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=rope, with_lse=True)
    torch.testing.assert_close(out, out_p, **FLASH_TOL)
    torch.testing.assert_close(lse, lse_p, **LSE_TOL)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope))


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (28, 4)])   # rep 1, 4, 7
@pytest.mark.parametrize("s", [37, 300])
def test_flash_dkv_kernel_rep_and_repeat(cuda_device, h, kv, s):
    """dk/dv summed over rep query heads inside the block, on the ragged
    last tile and the all-masked row (batch 2); two calls bit-equal."""
    dev = cuda_device
    q, k, v, do, mask = _attn_case(dev, 3, s, h, kv, 128, 7 * s + h)
    cos, sin = rope_angles(token_positions(mask, 3, s, dev), 128, 10000.0)
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, rope=(cos, sin), with_lse=True)
    qr, kr = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    bias = fa.mask_bias(mask, 3, s, dev)
    got = fab.flash_attention_bwd(qr, kr, v, bias, out, do, lse)
    _bwd_close(got, fab.flash_attention_bwd_plain(qr, kr, v, bias, out, do, lse))
    again = fab.flash_attention_bwd(qr, kr, v, bias, out, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_flash_backward_kernels_head_dims(cuda_device, dh):
    """The backward at every head dim (each takes its own swizzle width)."""
    dev = cuda_device
    q, k, v, do, mask = _attn_case(dev, 3, 130, 8, 2, dh, dh)
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, with_lse=True)
    bias = fa.mask_bias(mask, 3, 130, dev)
    got = fab.flash_attention_bwd(q, k, v, bias, out, do, lse)
    _bwd_close(got, fab.flash_attention_bwd_plain(q, k, v, bias, out, do, lse))


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_flash_dq_kernel_single_tile_exact(cuda_device, dh):
    """One 64-row tile of one head against 64 keys on inputs where every
    step is exact: q = 0 and lse = 0 make p = 1; dO, V, K are integers in
    [-1, 1], D integers in [-64, 64] and the scale 2**-3, so dP, dS =
    (dP - D) / 8 (exact in bf16) and dQ = dS K are exact in f32 in any
    order.  The kernel's dq equals the formula bit for bit: a wrong
    descriptor, swizzle or TMA box gives a wrong number, not a rounding."""
    dev, s = cuda_device, 64
    g = torch.Generator(device=dev).manual_seed(dh)
    k, v, do = (torch.randint(-1, 2, (1, s, 1, dh), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(3))
    q = torch.zeros_like(k)
    bias = torch.zeros((1, s), device=dev)
    lse = torch.zeros((1, 1, s), device=dev)
    dsum = torch.randint(-64, 65, (1, 1, s), generator=g, device=dev).float()
    dq = torch.empty((1, s, 1, dh), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fab.DQ_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), 1, s, 1, 1, dh, 2 ** -3,
                  stream)
    dp = do[0, :, 0].float() @ v[0, :, 0].float().T
    ds = ((dp - dsum[0, 0][:, None]) * 2 ** -3).to(torch.bfloat16).float()
    assert torch.equal(dq[0, :, 0], ds @ k[0, :, 0].float())


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])   # GQA rep 1 and 4
@pytest.mark.parametrize("s", [63, 64, 65, 127, 129, 1025])
def test_flash_dq_kernel_tile_edges(cuda_device, h, kv, s):
    """dq where its 64-row query tiles and 64-key tiles end (a block's two
    units are two row tiles of one head at rep 1, two heads of one kv head
    at rep 4), with the all-masked row (batch 2); two calls bit-identical."""
    dev = cuda_device
    q, k, v, do, mask = _attn_case(dev, 3, s, h, kv, 128, 11 * s + h)
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, with_lse=True)
    bias = fa.mask_bias(mask, 3, s, dev)
    got = fab.flash_attention_bwd(q, k, v, bias, out, do, lse)
    _bwd_close(got, fab.flash_attention_bwd_plain(q, k, v, bias, out, do, lse))
    assert torch.equal(got[0], fab.flash_attention_bwd(q, k, v, bias, out, do, lse)[0])


@pytest.mark.parametrize("name", ["q", "k", "v", "do"])
def test_flash_backward_refuses_unaligned_operands(cuda_device, name):
    """The dq kernel reads q, k, v and dO by TMA, whose boxes start on
    16-byte boundaries: a contiguous view 8 bytes into its buffer is refused
    with a message before any map is encoded."""
    dev = cuda_device
    q, k, v, do, mask = _attn_case(dev, 3, 130, 8, 2, 64, 9)
    out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, with_lse=True)
    bias = fa.mask_bias(mask, 3, 130, dev)
    ops = {"q": q, "k": k, "v": v, "do": do}
    t = ops[name]
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=dev)
    shifted = buf[4:].view(t.shape)                           # 8 bytes in, contiguous
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    ops[name] = shifted
    with pytest.raises(ValueError, match=f"^{name} must be 16-byte aligned"):
        fab.flash_attention_bwd(ops["q"], ops["k"], ops["v"], bias, out, ops["do"], lse)


def test_flash_function_carries_gradients_on_card(cuda_device, monkeypatch):
    dev = cuda_device
    q, k, v, do, mask = _attn_case(dev, 3, 130, 8, 2, 128, 5)
    cos, sin = rope_angles(token_positions(mask, 3, 130, dev), 128, 10000.0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launch_counts()
    out = fa.flash_attention(*leaves, mask=mask, rope=(cos, sin))
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    assert KERNELS["flash_attention_bwd_dq"].launches == 1
    assert KERNELS["flash_attention_bwd_dkv"].launches == 1
    with monkeypatch.context() as m:
        m.setattr(fa, "flash_attention_fwd", lambda *a, **kw: fa.flash_attention_plain(
            *a, with_lse=True, **kw))
        m.setattr(fab, "flash_attention_bwd", fab.flash_attention_bwd_plain)
        want = torch.autograd.grad(
            fa.flash_attention(*leaves, mask=mask, rope=(cos, sin)), leaves, do)
    _bwd_close([g.float() for g in got], [w.float() for w in want])


def test_grouped_wrappers_raise_under_grad(cuda_device):
    dev = cuda_device
    x = torch.zeros((64, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = torch.zeros((2, 64, 64), device=dev, dtype=torch.bfloat16)
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        gg.grouped_gateup(x, w, w, te)
    with pytest.raises(NotImplementedError, match="no backward"):
        gg.grouped_down(x, w, te)
    probs = torch.ones((4, 1), device=dev)
    idx = torch.zeros((4, 1), dtype=torch.long, device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        gg.grouped_expert_ffn_cuda(x[:4], probs, idx, w, w, w)
    with torch.no_grad():
        assert gg.grouped_gateup(x, w, w, te).shape == (64, 64)


@pytest.mark.parametrize("remat", [False, True])
def test_tiny_train_step_launches_kernels(cuda_device, remat):
    cfg = get_config("llada-tiny")  # bf16
    params = init_params(cfg, seed=4, device=cuda_device)
    tcfg = TrainConfig(grad_accum=2, remat=remat, learning_rate=1e-3, warmup_steps=1)
    opt, _ = make_optimizer(tcfg, 10)
    state = opt.init(params)
    step, _ = make_train_step(cfg, tcfg, opt, device=cuda_device)
    ids = torch.randint(10, 400, (2, 1, 64), device=cuda_device)
    plens = torch.full((2, 1), 8, device=cuda_device)
    reset_launch_counts()
    params, state, m = step(params, state, ids, plens,
                            torch.Generator(device=cuda_device).manual_seed(0))
    fwd = cfg.num_layers * 2 * (2 if remat else 1)
    assert KERNELS["flash_attention_fwd"].launches == fwd
    assert KERNELS["flash_attention_bwd_dq"].launches == cfg.num_layers * 2
    assert KERNELS["flash_attention_bwd_dkv"].launches == cfg.num_layers * 2
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0


# ---------------------------------------------------------------------------
# The single-prompt serving kernels: the fused expert FFN (K3) and the
# direct-softmax flash attention (K9).  K9 takes the softmax against the same
# max over all keys as the plain version, so it holds to the grouped kernels'
# one-ulp tolerance, tighter than K8's two.  Both round P to bf16 from f32
# scores whose dot products they sum in different orders, so where a p lies
# at a bf16 rounding boundary the plain version itself is ambiguous: summed
# in float64 instead, its dots may round that P the other way, which moves
# out past one ulp where the key weighs much in its row.  There, and only
# where those two plain versions differ past GROUPED_TOL, K9 may match the
# float64 one instead.  K3's h stays in shared memory:
# kernel and plain version round it to bf16 from f32 sums taken in different
# orders, so now and then one h element differs by one bf16 ulp (2**-8
# relative), which moves out[row, j] by up to 2**-8 * |h_i| * |Wd[i, j]|
# beyond out's own one-ulp rounding.  On inputs whose products and sums are
# exact in f32 (small integers times a power of two) h is bit-equal in both,
# and out holds to one ulp; on random inputs the tolerance adds that term.
# ---------------------------------------------------------------------------

def fused_tol(h_plain, wd):
    """GROUPED_TOL plus one flipped bf16 ulp of the largest h element
    through the largest down weight."""
    flip = 2 ** -8 * float(h_plain.abs().max()) * float(wd.abs().max())
    return dict(rtol=GROUPED_TOL["rtol"], atol=max(GROUPED_TOL["atol"], flip))


def direct_plain_f64_dots(q, k, v, mask, rope):
    """``fa.flash_attention_plain``'s out with its q.k dot products summed in
    float64 and rounded to f32 once; every other step as the plain version."""
    b, s, h, dh = q.shape
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    sk, rep = fa.kv_tile_len(s), h // k.shape[2]
    bias = torch.full((b, sk), fa.NEG_INF, dtype=torch.float32, device=q.device)
    bias[:, :s] = fa.mask_bias(mask, b, s, q.device)
    kp, vp = (torch.zeros((b, sk) + t.shape[2:], dtype=t.dtype, device=t.device)
              for t in (k, v))
    kp[:, :s], vp[:, :s] = k, v
    dots = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                        kp.repeat_interleave(rep, dim=2).double())
    scores = dots.float() * dh ** -0.5 + bias[:, None, None, :]
    m = torch.clamp_min(scores.amax(dim=-1, keepdim=True), fa.NEG_INF)
    p = torch.exp(scores - m)
    l = torch.clamp_min(p.sum(dim=-1), 1e-30)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                      vp.repeat_interleave(rep, dim=2).float())
    return (pv / l.permute(0, 2, 1)[..., None]).to(q.dtype)


def assert_direct_close(got, want, want_f64_dots):
    """K9's out within GROUPED_TOL of the plain version's at every element,
    or, where the plain version and its float64-dot twin differ past
    GROUPED_TOL, within GROUPED_TOL of the twin."""
    def close(a, b):
        return ((a.float() - b.float()).abs()
                <= GROUPED_TOL["atol"] + GROUPED_TOL["rtol"] * b.float().abs())
    ok = close(got, want) | (~close(want, want_f64_dots) & close(got, want_f64_dots))
    assert ok.all(), (f"{int((~ok).sum())} of {ok.numel()} elements past GROUPED_TOL "
                      f"of both plain versions")


def _fused_inputs(dev, d, f, layers, e, routing, seed, exact=False):
    x, idx, g = _routing(dev, 120, d, e, 2, seed)
    if routing == "skew":
        idx = torch.where(idx < e // 2, idx % 3, idx)   # experts 3 .. e/2-1 empty
    elif routing == "single":
        idx = torch.full_like(idx[:, :1], e - 1)        # one expert, top-1
    lead = () if layers is None else (layers,)
    if exact:
        # Integers in [-2, 2], weights times 2**-7: every product and partial
        # sum of the gate/up products is a multiple of 2**-7 below 2**10,
        # exact in f32 in any order.
        def draw(shape, scale):
            return (torch.randint(-2, 3, shape, generator=g, device=dev)
                    * scale).to(torch.bfloat16)
        x = draw(x.shape, 1.0)
        wg, wu = draw(lead + (e, d, f), 2 ** -7), draw(lead + (e, d, f), 2 ** -7)
        wd = draw(lead + (e, f, d), 2 ** -7)
        return x, idx, wg, wu, wd
    wg, wu = (torch.randn(lead + (e, d, f), generator=g, device=dev,
                          dtype=torch.bfloat16) / d ** 0.5 for _ in range(2))
    wd = torch.randn(lead + (e, f, d), generator=g, device=dev,
                     dtype=torch.bfloat16) / f ** 0.5
    return x, idx, wg, wu, wd


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d,f,layers,e,routing", [
    (128, 128, None, 8, "random"),     # flat
    (256, 384, 3, 8, "random"),        # layer-stacked, several F and D passes
    (128, 256, 2, 16, "skew"),         # most experts empty
    (256, 128, None, 8, "single"),     # every row on one expert
    (2048, 896, 2, 64, "random"),      # llada-moe-7b's D, F and E
])
def test_fused_ffn_kernel_matches_plain(cuda_device, d, f, layers, e, routing, exact):
    dev = cuda_device
    x, idx, wg, wu, wd = _fused_inputs(dev, d, f, layers, e, routing, d + f + e, exact)
    li = None if layers is None else layers - 1
    k = idx.shape[1]
    dest, te, sizes, m_pad = gg.counting_layout(idx, e, gg.TILE_M)
    if routing == "skew":
        assert int((sizes == 0).sum()) >= e // 2 - 3
    xs = gg.gather_rows(x, dest, k, m_pad)
    reset_launch_counts()
    got = gg.grouped_ffn_fused(xs, wg, wu, wd, te, gg.TILE_M, li)
    h_p = gg.grouped_gateup_plain(xs, wg, wu, te, gg.TILE_M, li)
    want = gg.grouped_down_plain(h_p, wd, te, gg.TILE_M, li)
    assert torch.equal(want, gg.grouped_ffn_fused_plain(xs, wg, wu, wd, te, gg.TILE_M, li))
    tol = GROUPED_TOL if exact else fused_tol(h_p, wd if li is None else wd[li])
    torch.testing.assert_close(got, want, **tol)
    assert KERNELS["grouped_ffn_fused"].launches == 1
    assert torch.equal(got, gg.grouped_ffn_fused(xs, wg, wu, wd, te, gg.TILE_M, li))


def _fused_experts(g, dev, lead, e, d, f, exact):
    """Gate, up and down weights: integers in [-2, 2] times 2**-7 (exact
    arithmetic, as in _fused_inputs) or scaled normals."""
    if exact:
        return (_ints(g, dev, lead + (e, d, f), -2, 3, 2 ** -7),
                _ints(g, dev, lead + (e, d, f), -2, 3, 2 ** -7),
                _ints(g, dev, lead + (e, f, d), -2, 3, 2 ** -7))
    return (_bf16_experts(g, dev, lead, e, d, f), _bf16_experts(g, dev, lead, e, d, f),
            _bf16_experts(g, dev, lead, e, f, d))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d,f,layers,sizes", [
    (256, 384, None, [30, 40, 20, 63, 1, 50, 10, 33]),
    (128, 256, 2, [0, 0, 0, 0, 0, 300, 0, 0]),
    (256, 1024, 2, [100, 0, 70, 0, 130, 0, 10, 40]),
    (2048, 896, 2, [(37 * i) % 90 if i % 3 else 0 for i in range(64)]),
], ids=["expert_per_tile", "one_expert", "f_1024", "llada_moe_7b"])
def test_fused_ffn_kernel_pad_skip(cuda_device, d, f, layers, sizes, exact):
    """K3 with the pad-skip vector: the tiles it marks 0 are zero, every
    other row equals the call without it bit for bit, both hold to the plain
    version, and the FFN output after the combine is the same with and
    without it.  Routings: the expert changes at every tile; one expert owns
    every tile; F at the limit (a cluster of 8 CTAs) with empty experts
    between used ones; llada-moe-7b's D, F and 64 experts.  Two calls are
    bit-identical."""
    dev, e = cuda_device, len(sizes)
    x, idx, g = _routing_of_sizes(dev, sizes, d, d + f + e)
    if exact:
        x = _ints(g, dev, x.shape, -2, 3, 1.0)
    lead = () if layers is None else (layers,)
    wg, wu, wd = _fused_experts(g, dev, lead, e, d, f, exact)
    li = None if layers is None else layers - 1
    dest, te, got_sizes, m_pad = gg.counting_layout(idx, e, gg.TILE_M)
    assert got_sizes.tolist() == sizes
    valid = gg.valid_tiles(got_sizes, te, gg.TILE_M, m_pad)
    empty = valid.repeat_interleave(gg.TILE_M) == 0
    assert bool(empty.any())
    xs = gg.gather_rows(x, dest, 1, m_pad)
    reset_launch_counts()
    got = gg.grouped_ffn_fused(xs, wg, wu, wd, te, gg.TILE_M, li, valid)
    whole = gg.grouped_ffn_fused(xs, wg, wu, wd, te, gg.TILE_M, li)
    assert KERNELS["grouped_ffn_fused"].launches == 2
    assert not got[empty].any()
    assert torch.equal(got[~empty], whole[~empty])
    h_p = gg.grouped_gateup_plain(xs, wg, wu, te, gg.TILE_M, li)
    want = gg.grouped_down_plain(h_p, wd, te, gg.TILE_M, li, valid)
    assert torch.equal(want, gg.grouped_ffn_fused_plain(xs, wg, wu, wd, te, gg.TILE_M, li,
                                                        valid))
    tol = GROUPED_TOL if exact else fused_tol(h_p, wd if li is None else wd[li])
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got, gg.grouped_ffn_fused(xs, wg, wu, wd, te, gg.TILE_M, li, valid))
    n = x.shape[0]
    probs = torch.rand((n, 1), generator=g, device=dev)
    assert torch.equal(gg.combine(got, dest, probs, n, 1, x.dtype),
                       gg.combine(whole, dest, probs, n, 1, x.dtype))


def test_fused_ffn_hands_kernel_tile_valid(cuda_device, monkeypatch):
    """Under CTDB_GROUPED_FUSED=1 the expert FFN hands K3 the pad-skip
    vector; its output is the same as with none."""
    monkeypatch.setenv("CTDB_GROUPED_FUSED", "1")
    dev, e = cuda_device, 8
    x, idx, g = _routing(dev, 150, 256, e, 2, 13)
    probs = torch.rand(idx.shape, generator=g, device=dev)
    ws = _fused_experts(g, dev, (), e, 256, 128, False)
    seen = []
    fused = gg.grouped_ffn_fused

    def recording(keep):
        def run(*args):
            seen.append(args[-1])
            return fused(*args[:-1], args[-1] if keep else None)
        return run

    monkeypatch.setattr(gg, "grouped_ffn_fused", recording(False))
    want = gg.grouped_expert_ffn_cuda(x, probs, idx, *ws)
    monkeypatch.setattr(gg, "grouped_ffn_fused", recording(True))
    assert torch.equal(gg.grouped_expert_ffn_cuda(x, probs, idx, *ws), want)
    assert len(seen) == 2 and all(v is not None for v in seen)
    assert bool((seen[0] == 0).any())


def test_fused_ffn_wrapper_refuses(cuda_device):
    dev = cuda_device
    te = torch.zeros(1, dtype=torch.int32, device=dev)

    def experts(d, f, dtype=torch.bfloat16):
        return (torch.zeros((2, d, f), device=dev, dtype=dtype),
                torch.zeros((2, d, f), device=dev, dtype=dtype),
                torch.zeros((2, f, d), device=dev, dtype=dtype))

    x = torch.zeros((64, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cluster"):
        gg.grouped_ffn_fused(x, *experts(128, 1408), te)     # past a cluster of 8
    with pytest.raises(ValueError, match="cluster"):
        gg.grouped_ffn_fused(x, *experts(128, 1152), te)
    with pytest.raises(ValueError, match="tile_valid"):
        gg.grouped_ffn_fused(x, *experts(128, 128), te, 64, None,
                             torch.ones(2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="% 128"):
        gg.grouped_ffn_fused(x, *experts(128, 192), te)
    with pytest.raises(ValueError, match="% 128"):
        gg.grouped_ffn_fused(torch.zeros((64, 64), device=dev, dtype=torch.bfloat16),
                             *experts(64, 128), te)
    q = [quantize_tensor(w.float()) for w in experts(128, 128)]
    with pytest.raises(ValueError, match="int8"):
        gg.grouped_ffn_fused(x, *q, te)
    with pytest.raises(ValueError, match="bf16"):
        gg.grouped_ffn_fused(x, *experts(128, 128, torch.float32), te)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        gg.grouped_ffn_fused(xg, *experts(128, 128), te)
    with torch.no_grad():
        assert gg.grouped_ffn_fused(xg, *experts(128, 128), te).shape == (64, 128)


def test_fused_switch_selects_kernel(cuda_device, monkeypatch):
    """CTDB_GROUPED_FUSED=1 sends aligned bf16 experts to K3 and nothing
    else: unaligned ones and int8 ones keep their pair."""
    dev = cuda_device
    x, idx, wg, wu, wd = _fused_inputs(dev, 128, 128, 2, 8, "random", 3)
    probs = torch.full(idx.shape, 0.5, device=dev)

    def launches(xx, *ws):
        reset_launch_counts()
        out = gg.grouped_expert_ffn_cuda(xx, probs, idx, *ws, layer_index=1)
        return out, {n: KERNELS[n].launches for n in (
            "grouped_ffn_fused", "grouped_gateup", "grouped_down", "grouped_gateup_q")}

    pair, n = launches(x, wg, wu, wd)
    assert n == {"grouped_ffn_fused": 0, "grouped_gateup": 1, "grouped_down": 1,
                 "grouped_gateup_q": 0}
    monkeypatch.setenv("CTDB_GROUPED_FUSED", "1")
    fused, n = launches(x, wg, wu, wd)
    assert n == {"grouped_ffn_fused": 1, "grouped_gateup": 0, "grouped_down": 0,
                 "grouped_gateup_q": 0}
    dest, te, _, m_pad = gg.counting_layout(idx, 8)
    h_p = gg.grouped_gateup_plain(gg.gather_rows(x, dest, 2, m_pad), wg, wu, te,
                                  layer_index=1)
    tol = fused_tol(h_p, wd[1])        # each side may flip an h element
    torch.testing.assert_close(fused, pair, rtol=tol["rtol"], atol=2 * tol["atol"])
    unaligned = [w.contiguous() for w in (wg[..., :64, :96], wu[..., :64, :96],
                                          wd[..., :96, :64])]
    _, n = launches(x[:, :64].contiguous(), *unaligned)
    assert n["grouped_ffn_fused"] == 0 and n["grouped_gateup"] == 1
    _, n = launches(x, *[quantize_tensor(w.float()) for w in (wg, wu, wd)])
    assert n["grouped_ffn_fused"] == 0 and n["grouped_gateup_q"] == 1


# S at K9's tile edges (64 keys, 64 query rows) and residency edges (K stays
# in shared memory up to 512 keys at Dh 128: S 512 pads to 512 keys, 513 to
# 640).  A block takes two warpgroups when K is streamed (S > 512) or when
# B * H * ceil(S / 64) exceeds the card's SMs; one of them is idle where
# rep * ceil(S / 64) is odd (rep 1 at S 513 and 641, and at H 12 also at
# S 320; rep 7 at S 320, 513 and 641).
DIRECT_S = [1, 24, 63, 64, 65, 200, 320, 511, 512, 513, 640, 641, 1024]


@pytest.mark.parametrize("h,kv", [(4, 4), (12, 12), (16, 4), (28, 4)])   # rep 1, 1, 4, 7
@pytest.mark.parametrize("s", DIRECT_S)
def test_direct_flash_kernel_matches_plain(cuda_device, monkeypatch, h, kv, s):
    """K9 with and without RoPE, with lse, on the fully masked row (batch
    2), against its plain version (see above where a P is ambiguous); a
    repeated call is bit-identical."""
    monkeypatch.setenv("CTDB_FLASH_DIRECT", "1")
    dev, dh = cuda_device, 128
    q, k, v, _, mask = _attn_case(dev, 3, s, h, kv, dh, h + s)
    cos, sin = rope_angles(token_positions(mask, 3, s, dev), dh, 10000.0)
    for rope in (None, (cos, sin)):
        reset_launch_counts()
        out, lse = fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope, with_lse=True)
        out_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask, rope=rope,
                                                with_lse=True)
        assert_direct_close(out, out_p, direct_plain_f64_dots(q, k, v, mask, rope))
        torch.testing.assert_close(lse, lse_p, **LSE_TOL)
        # the fully masked row (batch 2) averages every padded key, as plain
        torch.testing.assert_close(out[2], out_p[2], **GROUPED_TOL)
        assert torch.equal(out, fa.flash_attention_cuda(q, k, v, mask=mask, rope=rope))
        assert KERNELS["flash_attention_direct"].launches == 2
        assert KERNELS["flash_attention_fwd"].launches == 0


@pytest.mark.parametrize("s,h,kv", [(512, 16, 4), (512, 28, 4), (1024, 8, 2), (640, 28, 4)])
def test_direct_flash_kernel_exact_scores(cuda_device, monkeypatch, s, h, kv):
    """K9 where every score is exact in f32: q, k and v integers in [-1, 1],
    no RoPE, B 1 (one and two warpgroups, K resident and streamed).  Each
    score is then q.k (exact) times the scale, rounded once, in the kernel
    and in a float64 reference alike (the padded keys' bias of -1e30 makes
    their exp 0), so lse may differ from the reference only by the f32
    rounding of exp, of the sum (taken in another order) and of the log:
    far inside LSE_TOL, where a wrong wgmma descriptor or swizzle, which
    changes scores, is not."""
    monkeypatch.setenv("CTDB_FLASH_DIRECT", "1")
    dev, dh = cuda_device, 128
    g = torch.Generator(device=dev).manual_seed(s + h)
    q = torch.randint(-1, 2, (1, s, h, dh), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randint(-1, 2, (1, s, kv, dh), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    reset_launch_counts()
    out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v))
    assert KERNELS["flash_attention_direct"].launches == 2
    kr = k.double().repeat_interleave(h // kv, dim=2)
    dots = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr)             # exact
    scores = (dots.float() * torch.tensor(dh ** -0.5, dtype=torch.float32)).double()
    m = scores.amax(dim=-1)
    want = m + torch.log(torch.exp(scores - m[..., None]).sum(dim=-1))
    torch.testing.assert_close(lse.double(), want, rtol=2 ** -20, atol=2e-5)
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v), **GROUPED_TOL)


@pytest.mark.parametrize("dh", [16, 32, 64])
def test_direct_flash_kernel_head_dims(cuda_device, monkeypatch, dh):
    monkeypatch.setenv("CTDB_FLASH_DIRECT", "1")
    q, k, v, _, mask = _attn_case(cuda_device, 3, 130, 8, 2, dh, dh)
    cos, sin = rope_angles(token_positions(mask, 3, 130, cuda_device), dh, 10000.0)
    got = fa.flash_attention(q, k, v, mask=mask, rope=(cos, sin))
    want = fa.flash_attention_plain(q, k, v, mask=mask, rope=(cos, sin))
    torch.testing.assert_close(got, want, **GROUPED_TOL)


def test_direct_switch_selects_kernel(cuda_device, monkeypatch):
    """CTDB_FLASH_DIRECT=1 takes K9 for one kv tile (S <= 1024), K8 past it;
    the autograd wrapper's forward goes through K9 too."""
    dev = cuda_device

    def counts(s, grad=False):
        q, k, v, do, mask = _attn_case(dev, 3, s, 8, 2, 64, s)
        reset_launch_counts()
        if grad:
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            torch.autograd.grad(fa.flash_attention(*leaves, mask=mask), leaves, do)
        else:
            fa.flash_attention(q, k, v, mask=mask)
        return (KERNELS["flash_attention_direct"].launches,
                KERNELS["flash_attention_fwd"].launches)

    assert counts(300) == (0, 1)
    monkeypatch.setenv("CTDB_FLASH_DIRECT", "1")
    assert counts(300) == (1, 0) and counts(1024) == (1, 0)
    assert counts(1100) == (0, 1)
    assert counts(300, grad=True) == (1, 0)
    assert KERNELS["flash_attention_bwd_dq"].launches == 1
    monkeypatch.setenv("CTDB_FLASH_DIRECT", "0")
    assert counts(300) == (0, 1)


def test_tiny_model_single_prompt_kernels(cuda_device, monkeypatch):
    """An aligned tiny MoE model under both switches: kernels against plain
    versions, and a B = 1 greedy decode through K3 and K9 only."""
    dev = cuda_device
    monkeypatch.setenv("CTDB_GROUPED_FUSED", "1")
    monkeypatch.setenv("CTDB_FLASH_DIRECT", "1")
    cfg = get_config("llada-moe-tiny", hidden_size=128, moe_intermediate_size=128,
                     head_dim=32)                               # bf16
    params = init_params(cfg, seed=7, device=dev)
    ids = torch.randint(3, 400, (1, 40), device=dev)
    lk, lp = _kernels_against_plain(cfg, params, ids, dev, monkeypatch, [
        (attention, "flash_attention", fa.flash_attention_plain),
        (gg, "grouped_ffn_fused", gg.grouped_ffn_fused_plain)])
    assert (lk - lp).abs().max() <= 2 ** -4 * lp.abs().max()
    reset_launch_counts()
    out = llada_generate(make_forward_fn(cfg, device=dev), params, ids[:, :8],
                         steps=8, gen_length=16, block_length=8,
                         mask_id=cfg.mask_token_id)
    assert not (out[:, 8:] == cfg.mask_token_id).any()
    launches = {n: kk.launches for n, kk in KERNELS.items()}
    want = cfg.num_layers * 8
    assert launches["grouped_ffn_fused"] == launches["flash_attention_direct"] == want
    assert launches["grouped_gateup"] == launches["grouped_down"] == 0
    assert launches["flash_attention_fwd"] == 0
