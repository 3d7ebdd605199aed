"""The MoE layer's weighted combine (``ops/grouped_gemm_cuda.py``:
``combine``, its plain chain ``combine_plain`` and G3's wrapper
``combine_cuda``), on the CPU.

- ``combine_plain`` is the per-slot sum it stands for: token n gets
  ``Σ_j out_padded[dest[n·k + j]] · probs[n, j]``, held against that sum in
  float64.  The chain rounds each f32 product and sum (at most k · 2**-23 of
  the sum of |terms| in all) and the result once to the output's dtype (one
  ulp of it: 2**-8 relative in bf16, 2**-23 in f32).  Routing slots that
  expert parallelism drops (``drop_foreign``) have zero rows in the padded
  output, so they add nothing.
- A CPU tensor takes the chain and launches nothing.
- G3's wrapper checks shapes and dtypes before the device, so its refusals
  show here; that it refuses a CPU tensor at all, too.  Its arithmetic,
  bit-equal to the chain run on the card, is held there
  (``tests/test_torch_port_cuda.py``).
- G3's name reads as neither a product nor an expert FFN kernel to the
  benchmark's readers.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ULP = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -23}


def _routing(n, k, e, d, dtype, drop, seed):
    """(out_padded, dest, probs, topk_idx) of a softmax top-k routing of n
    tokens over e experts; with ``drop`` the upper half of the experts lie
    on another rank (slot id e // 2) and their rows of ``out_padded`` are
    zero, as the expert kernels leave them."""
    g = torch.Generator().manual_seed(seed)
    probs = torch.softmax(torch.randn((n, e), generator=g), dim=-1)
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_probs, topk_idx = sp[:, :k], order[:, :k]
    experts = e
    if drop:
        experts = e // 2
        topk_idx = torch.where(topk_idx < experts, topk_idx, torch.full_like(topk_idx, experts))
    dest, _, _, m_pad = gg.counting_layout(topk_idx, experts, gg.TILE_M, drop)
    out_padded = (torch.randn((m_pad, d), generator=g) * 2).to(dtype)
    if drop:
        out_padded[dest.reshape(n, k)[topk_idx == experts]] = 0
    return out_padded, dest, topk_probs, topk_idx


@pytest.mark.parametrize("drop", [False, True], ids=["local", "drop_foreign"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_combine_plain_is_the_slot_sum(dtype, k, drop):
    n, e, d = 37, 16, 64
    out_padded, dest, probs, idx = _routing(n, k, e, d, dtype, drop, seed=k + 2 * drop)
    reset_launch_counts()
    got = gg.combine(out_padded, dest, probs, n, k, dtype)
    assert KERNELS["moe_combine"].launches == 0
    assert got.dtype == dtype and got.shape == (n, d)
    assert torch.equal(got, gg.combine_plain(out_padded, dest, probs, n, k, dtype))
    terms = out_padded.double()[dest].reshape(n, k, d) * probs.double()[:, :, None]
    if drop:
        assert not terms[idx == e // 2].any()
        assert int((idx == e // 2).sum()) > 0
    want = terms.sum(dim=1)
    tol = ULP[dtype] * want.abs() + k * 2.0 ** -23 * terms.abs().sum(dim=1)
    assert bool(((got.double() - want).abs() <= tol).all())


N, K, D = 5, 3, 64
ROWS = torch.zeros((192, D), dtype=torch.bfloat16)
DEST = torch.arange(N * K)
PROBS = torch.rand((N, K), generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("rows,dest,probs,dtype,match", [
    (ROWS[0], DEST, PROBS, torch.bfloat16, r"\[m_pad, D\]"),
    (ROWS.half(), DEST, PROBS, torch.bfloat16, "out_padded has dtype"),
    (ROWS, DEST, PROBS.double(), torch.bfloat16, "topk_probs must be float32"),
    (ROWS, DEST, PROBS.bfloat16(), torch.bfloat16, "topk_probs must be float32"),
    (ROWS, DEST, PROBS, torch.float16, "the output has dtype"),
    (ROWS[:, :60], DEST, PROBS, torch.bfloat16, "multiple of 8"),
    (ROWS, DEST.int(), PROBS, torch.bfloat16, "dest must be int64"),
    (ROWS, DEST[:-1], PROBS, torch.bfloat16, "dest must be int64"),
    (ROWS, DEST, PROBS[:, :2], torch.bfloat16, "topk_probs must be"),
    (ROWS, DEST, PROBS, torch.bfloat16, "CUDA"),
], ids=["rows_1d", "rows_f16", "probs_f64", "probs_bf16", "out_f16", "d_60", "dest_int32",
        "dest_short", "probs_narrow", "cpu"])
def test_combine_cuda_refuses_before_the_device(rows, dest, probs, dtype, match):
    with pytest.raises(ValueError, match=match):
        gg.combine_cuda(rows, dest, probs, N, K, dtype)


def _metric_module(name):
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_combine_kernel_name_reads_as_neither_product_nor_expert_ffn():
    """G3's name holds none of the GEMM metric's patterns and none of the
    expert FFN roofline's kernels, so a profile counts it in neither."""
    src = (REPO / "ct_diffusionmodelbench_tpu_torch" / "csrc" / "moe_combine.cu").read_text()
    names = set(re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(", src))
    assert names == {"ctdb_moe_combine_kernel"}
    gemm = _metric_module("dense_gemm_roofline.decode")
    ffn = _metric_module("grouped_ffn_roofline.decode")
    shown = "void ctdb_moe_combine_kernel<__nv_bfloat16, float, __nv_bfloat16>(...)"
    assert not any(p in shown for p in gemm.PATTERNS)
    assert not any(kname in shown for kname in ffn.KERNELS)
