"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; each test asks the ``cuda_device`` fixture, which skips
when no card is present (decided at run time, never at import).  On a
machine with a card and no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances: kernel and plain version take the same bf16 inputs, accumulate
in f32 and round once to bf16, so they differ by at most one bf16 ulp
(2**-7 relative) plus an absolute floor; flash attention also rounds P to
bf16 against differently tiled running maxima (two ulps).
"""

import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn
from ct_diffusionmodelbench_tpu_torch.models.layers import rope_angles
from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions
from ct_diffusionmodelbench_tpu_torch.ops import attention
from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts
from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate

pytestmark = pytest.mark.cuda

GROUPED_TOL = dict(rtol=2 ** -7, atol=1e-3)
FLASH_TOL = dict(rtol=2 ** -6, atol=4e-3)


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
    lk, _ = make_forward_fn(cfg, device=cuda_device)(params, ids)
    with monkeypatch.context() as m:  # each wrapper → its plain version
        m.setattr(attention, "flash_attention", fa.flash_attention_plain)
        m.setattr(gg, "grouped_gateup", gg.grouped_gateup_plain)
        m.setattr(gg, "grouped_down", gg.grouped_down_plain)
        lp, _ = make_forward_fn(cfg, device=cuda_device)(params, ids)
    assert (lk - lp).abs().max() <= 2 ** -4 * lp.abs().max()
    reset_launch_counts()
    out = llada_generate(make_forward_fn(cfg, device=cuda_device), params,
                         ids[:, :8], steps=8, gen_length=16, block_length=8,
                         mask_id=cfg.mask_token_id)
    assert not (out[:, 8:] == cfg.mask_token_id).any()
    assert {n: kk.launches for n, kk in KERNELS.items()} == {
        n: cfg.num_layers * 8 for n in KERNELS}
