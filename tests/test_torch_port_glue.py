"""The model step's glue (``ops/glue.py``: ``rms_norm``, ``swiglu_act``)
against the composites it replaced.

On the CPU: each plain version equals the old composite bit for bit, the
model's layers still compute it, a CPU tensor launches nothing and keeps
the composite's own autograd, and the two backward formulas of the card's
Functions (``rms_norm_grads`` and ``_silu_grads``) match autograd of the
composite in f64 and in f32.

Marked ``cuda`` (the ``cuda_device`` fixture skips without a card, decided
at run time), on the card, with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_glue.py

- ``swiglu_act`` is bit-equal to the composite: the same f32 operations in
  the same order, rounded once.
- ``rms_norm`` differs from the composite only in the order of its sum of
  squares.  A sum one f32 ulp off moves r by at most one ulp, so the output
  lies within one bf16 ulp of the composite's everywhere, is bit-equal on
  at least 99 % of bf16 elements (the f32 change crosses a bf16 rounding
  boundary rarely).  An f32 output carries the sums' own order errors
  (a few f32 ulps each at D 4096; r takes half of them): within 16 f32
  ulps, far inside one bf16 ulp (2**16 of them).
- Bad dtypes, shapes, strides and alignment raise; a tiny dense, MoE and
  Dream forward launch each kernel as often as the model has norms and
  activations; gradients through both autograd Functions match the
  composite's to one rounding of the output's dtype.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params
from ct_diffusionmodelbench_tpu_torch.models import layers
from ct_diffusionmodelbench_tpu_torch.models.transformer import forward
from ct_diffusionmodelbench_tpu_torch.ops import glue
from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts
from ct_diffusionmodelbench_tpu_torch.ops.grouped_gemm import _silu_grads
from tests.torch_port_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
GLUE_KERNELS = ("rms_norm", "swiglu_act")
EPS = 1e-5


def composite_rms_norm(x, scale, eps):
    """``models/layers.py::rms_norm`` as it was before the kernels."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def composite_swiglu_act(gate, up, dtype):
    """The activation of ``models/layers.py::swiglu`` before the kernels."""
    return (F.silu(gate) * up).to(dtype)


def _draw(shape, dtype, seed, device="cpu", scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


def _glue_launches():
    return {n: KERNELS[n].launches for n in GLUE_KERNELS}


# --------------------------------------------------------------------- CPU


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 4, 16), (7, 3584)])
def test_plain_rms_norm_is_the_composite(dtype, scale_dtype, shape):
    x = _draw(shape, dtype, 1, scale=3.0)
    s = _draw(shape[-1:], scale_dtype, 2)
    want = composite_rms_norm(x, s, EPS)
    for got in (glue.rms_norm_plain(x, s, EPS), glue.rms_norm(x, s, EPS),
                layers.rms_norm(x, s, EPS)):
        assert got.dtype == dtype and torch.equal(got, want)


def test_layers_rms_norm_takes_a_strided_slice():
    """The block cache's final norm reads a slice of the sequence."""
    x = _draw((2, 10, 64), torch.bfloat16, 3)
    s = _draw((64,), torch.bfloat16, 4)
    xb = x[:, 3:7]
    assert not xb.is_contiguous()
    assert torch.equal(layers.rms_norm(xb, s, EPS), composite_rms_norm(xb, s, EPS))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(5, 128), (3, 7, 13)])
def test_plain_swiglu_act_is_the_composite(out_dtype, shape):
    gate = _draw(shape, torch.float32, 5, scale=4.0)
    up = _draw(shape, torch.float32, 6)
    want = composite_swiglu_act(gate, up, out_dtype)
    for got in (glue.swiglu_act_plain(gate, up, out_dtype),
                glue.swiglu_act(gate, up, out_dtype)):
        assert got.dtype == out_dtype and torch.equal(got, want)


def test_layers_swiglu_is_the_composite():
    x = _draw((6, 64), torch.bfloat16, 7)
    wg, wu = _draw((64, 96), torch.bfloat16, 8, scale=0.1), _draw((64, 96), torch.bfloat16, 9,
                                                                   scale=0.1)
    wd = _draw((96, 64), torch.bfloat16, 10, scale=0.1)
    gate, up = x.float() @ wg.float(), x.float() @ wu.float()
    h = composite_swiglu_act(gate, up, x.dtype)
    want = (h.float() @ wd.float()).to(x.dtype)
    assert torch.equal(layers.swiglu(x, wg, wu, wd), want)


@pytest.mark.parametrize("name", ["llada-tiny", "llada-moe-tiny"])
def test_cpu_tensors_launch_nothing(name):
    x = _draw((4, 64), torch.float32, 11, scale=2.0).requires_grad_(True)
    s = _draw((64,), torch.float32, 12).requires_grad_(True)
    reset_launch_counts()
    y = glue.rms_norm(x, s, EPS)
    a = glue.swiglu_act(x, x * 0.5, torch.bfloat16)
    (y.sum() + a.float().sum()).backward()
    with torch.no_grad():
        glue.rms_norm(x, s, EPS), glue.swiglu_act(x, x, torch.float32)
    cfg = get_config(name)
    params = init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(3, 400, (2, 12))
    with torch.no_grad():
        forward(cfg, params, ids)
    assert _glue_launches() == {"rms_norm": 0, "swiglu_act": 0}


def test_cuda_entry_points_refuse_cpu_tensors():
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        glue.rms_norm_cuda(x, torch.ones(64), EPS)
    with pytest.raises(ValueError, match="CUDA"):
        glue.swiglu_act_cuda(x, x, torch.bfloat16)


def _rms_norm_math(x, s, eps):
    """The composite's arithmetic in x's own dtype (f64 stays f64)."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * s


@pytest.mark.parametrize("dtype,tol", [(torch.float64, dict(rtol=1e-12, atol=1e-13)),
                                       (torch.float32, dict(rtol=2e-5, atol=2e-6))])
@pytest.mark.parametrize("shape", [(6, 64), (2, 3, 5, 16)])
def test_rms_norm_grads_match_autograd(dtype, tol, shape):
    x = _draw(shape, dtype, 13, scale=2.0).requires_grad_(True)
    s = (1.0 + _draw(shape[-1:], dtype, 14, scale=0.3)).requires_grad_(True)
    g = _draw(shape, dtype, 15)
    if dtype == torch.float32:
        y = composite_rms_norm(x, s, EPS)
    else:
        y = _rms_norm_math(x, s, EPS)
    want_dx, want_ds = torch.autograd.grad(y, (x, s), g)
    dx, ds = glue.rms_norm_grads(x.detach(), s.detach(), EPS, g)
    assert dx.dtype == dtype and ds.dtype == dtype and ds.shape == s.shape
    torch.testing.assert_close(dx, want_dx, **tol)
    torch.testing.assert_close(ds, want_ds, **tol)
    # A CPU tensor keeps the composite under PyTorch's own autograd.
    if dtype == torch.float32:
        y2 = glue.rms_norm(x, s, EPS)
        assert type(y2.grad_fn).__name__ != "RMSNormBackward"
        assert torch.equal(y2, y)
        got = torch.autograd.grad(y2, (x, s), g)
        assert torch.equal(got[0], want_dx) and torch.equal(got[1], want_ds)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_silu_grads_match_autograd(dtype):
    """``_silu_grads`` computes in f32: against the f64 composite it holds
    to f32's precision, against the f32 composite to a few roundings."""
    gate = _draw((7, 96), dtype, 16, scale=4.0).requires_grad_(True)
    up = _draw((7, 96), dtype, 17).requires_grad_(True)
    dh = _draw((7, 96), dtype, 18)
    want = torch.autograd.grad(composite_swiglu_act(gate, up, dtype), (gate, up), dh)
    _, d_gate, d_up = _silu_grads(gate.detach(), up.detach(), dh)
    for got, w in zip((d_gate, d_up), want):
        torch.testing.assert_close(got.to(dtype), w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))
    if dtype == torch.float32:
        # A CPU tensor keeps the composite under PyTorch's own autograd.
        h = glue.swiglu_act(gate, up, torch.bfloat16)
        assert type(h.grad_fn).__name__ != "SwiGLUActBackward"
        got = torch.autograd.grad(h, (gate, up), dh.to(torch.bfloat16))
        ref = torch.autograd.grad(composite_swiglu_act(gate, up, torch.bfloat16),
                                  (gate, up), dh.to(torch.bfloat16))
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _metric_module(name):
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_names_read_as_glue():
    """The kernels' names hold none of the GEMM metric's patterns and no
    ``flash_``, so a profile counts them as neither products nor
    attention."""
    src = (REPO / "ct_diffusionmodelbench_tpu_torch" / "csrc" / "glue.cu").read_text()
    names = set(re.findall(r"__global__ void __launch_bounds__\(\d+\)\s+(\w+)\(", src))
    assert names == {"ctdb_rms_norm_kernel", "ctdb_swiglu_act_kernel"}
    gemm = _metric_module("dense_gemm_roofline.decode")
    flash = _metric_module("flash_fwd_roofline.decode")
    for name in names:
        shown = f"void {name}<__nv_bfloat16, __nv_bfloat16, 4, false>(...)"
        assert not any(p in shown for p in gemm.PATTERNS)
        assert "flash_" not in shown and not any(k in shown for k in flash.KERNELS)


# -------------------------------------------------------------------- CUDA


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16_ulps(a, b):
    """|a − b| in units of the last place of bf16 at b's magnitude."""
    b = b.float()
    exp = torch.floor(torch.log2(b.abs().clamp_min(2.0 ** -126)))
    return (a.float() - b).abs() / torch.exp2(exp - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(37, 128), (37, 2048), (37, 3584), (29, 4096),
                                   (3328, 12288), (3, 7, 13), (5,)])
def test_swiglu_act_is_bit_equal(cuda_device, out_dtype, shape):
    gate = _draw(shape, torch.float32, 21, cuda_device, scale=6.0)
    up = _draw(shape, torch.float32, 22, cuda_device, scale=2.0)
    flat = gate.view(-1)
    flat[:4] = torch.tensor([0.0, -100.0, 100.0, -0.0], device=cuda_device)[:flat.numel()]
    reset_launch_counts()
    got = glue.swiglu_act(gate, up, out_dtype)
    assert KERNELS["swiglu_act"].launches == 1
    want = composite_swiglu_act(gate, up, out_dtype)
    assert got.dtype == out_dtype and got.shape == gate.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(37, 64), (37, 128), (4, 9, 8, 128), (37, 1024),
                                   (37, 1032), (37, 2048), (37, 3584), (3328, 4096)])
def test_rms_norm_within_one_rounding(cuda_device, dtype, scale_dtype, shape):
    x = _draw(shape, dtype, 23, cuda_device, scale=3.0)
    s = (1.0 + _draw(shape[-1:], torch.float32, 24, cuda_device, scale=0.5)).to(scale_dtype)
    reset_launch_counts()
    got = glue.rms_norm(x, s, EPS)
    assert KERNELS["rms_norm"].launches == 1
    want = composite_rms_norm(x, s, EPS)
    assert got.dtype == dtype and got.shape == x.shape
    assert float(_bf16_ulps(got, want).max()) <= 1.0
    if dtype == torch.bfloat16:
        assert float((got == want).float().mean()) >= 0.99
    else:
        exp = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
        f32_ulps = (got - want).abs() / torch.exp2(exp - 23)
        assert float(f32_ulps.max()) <= 16.0


@pytest.mark.cuda
def test_glue_wrappers_refuse_bad_operands(cuda_device):
    dev = cuda_device
    x = torch.zeros((4, 64), device=dev, dtype=torch.bfloat16)
    s = torch.ones(64, device=dev, dtype=torch.bfloat16)
    bad_norm = [
        (x.half(), s, "dtype"),
        (x, s.half(), "dtype"),
        (torch.zeros((4, 12), device=dev, dtype=torch.bfloat16), torch.ones(12, device=dev),
         "multiple of 8"),
        (torch.zeros((2, 40960), device=dev, dtype=torch.bfloat16),
         torch.ones(40960, device=dev), "bytes a row"),
        (x, torch.ones(32, device=dev), "shape"),
        (torch.zeros((64, 8), device=dev, dtype=torch.bfloat16).t(), s, "contiguous"),
        (torch.zeros(4 * 64 + 1, device=dev, dtype=torch.bfloat16)[1:].view(4, 64), s,
         "16-byte"),
    ]
    for xx, ss, match in bad_norm:
        with pytest.raises(ValueError, match=match):
            glue.rms_norm(xx, ss, EPS)
    g = torch.zeros((4, 64), device=dev)
    bad_act = [
        (g.bfloat16(), g, torch.bfloat16, "float32"),
        (g, g[:, :32], torch.bfloat16, "differ"),
        (g, g, torch.float16, "dtype"),
        (torch.zeros((64, 4), device=dev).t(), g, torch.bfloat16, "contiguous"),
        (torch.zeros(257, device=dev)[1:].view(4, 64), g, torch.bfloat16, "16-byte"),
    ]
    for gg, uu, dt, match in bad_act:
        with pytest.raises(ValueError, match=match):
            glue.swiglu_act(gg, uu, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("name,norms,acts", [
    ("llada-tiny", lambda L: 2 * L + 1, lambda L: L),
    ("llada-moe-tiny", lambda L: 4 * L + 1, lambda L: L),   # qk-norm, shared expert
    ("dream-tiny", lambda L: 2 * L + 1, lambda L: L)])
def test_tiny_forward_launches_glue(cuda_device, name, norms, acts):
    cfg = get_config(name)
    params = init_params(cfg, seed=5, device=cuda_device)
    ids = torch.randint(3, 400, (2, 40), device=cuda_device)
    reset_launch_counts()
    with torch.no_grad():
        logits, _ = forward(cfg, params, ids)
    L = cfg.num_layers
    assert _glue_launches() == {"rms_norm": norms(L), "swiglu_act": acts(L)}
    assert bool(torch.isfinite(logits).all())


def _grads_close(got, want, dtype):
    """One rounding of ``dtype`` at the tensor's scale."""
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 2e-5
    atol = rtol * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(37, 128), (3, 11, 4096)])
def test_functions_carry_gradients_on_card(cuda_device, dtype, shape):
    dev = cuda_device
    x = _draw(shape, dtype, 31, dev, scale=2.0).requires_grad_(True)
    s = (1.0 + _draw(shape[-1:], torch.float32, 32, dev, scale=0.3)).to(dtype)
    s.requires_grad_(True)
    g = _draw(shape, dtype, 33, dev)
    reset_launch_counts()
    y = glue.rms_norm(x, s, EPS)
    assert type(y.grad_fn).__name__ == "RMSNormBackward"
    got = torch.autograd.grad(y, (x, s), g)
    want = torch.autograd.grad(composite_rms_norm(x, s, EPS), (x, s), g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        _grads_close(a, b, dtype)

    gate = _draw(shape, torch.float32, 34, dev, scale=4.0).requires_grad_(True)
    up = _draw(shape, torch.float32, 35, dev).requires_grad_(True)
    dh = _draw(shape, dtype, 36, dev)
    h = glue.swiglu_act(gate, up, dtype)
    assert type(h.grad_fn).__name__ == "SwiGLUActBackward"
    assert torch.equal(h, composite_swiglu_act(gate, up, dtype))
    got = torch.autograd.grad(h, (gate, up), dh)
    want = torch.autograd.grad(composite_swiglu_act(gate, up, dtype), (gate, up), dh)
    for a, b in zip(got, want):
        _grads_close(a, b, torch.float32)
    assert _glue_launches() == {"rms_norm": 1, "swiglu_act": 1}
