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
lse is f32 from scores that may differ by one bf16 ulp of a rotated q/k
element (the kernel may fuse the rotation's multiply-add): 2e-3 absolute.
The backward's f32 outputs sum products of bf16-rounded P and dS, whose
f32 sources differ in their last bits between the two versions; a flipped
rounding moves one term by one bf16 ulp (2**-8 relative), so each result
stays within 2**-6 relative plus 2**-8 of the tensor's largest magnitude.
"""

import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.models import get_config, init_params, make_forward_fn
from ct_diffusionmodelbench_tpu_torch.models.layers import rope_angles
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


def test_int8_ffn_and_tiny_model_against_plain(cuda_device, monkeypatch):
    """The int8 expert FFN and an aligned tiny int8 model: kernels against
    plain versions, and a greedy decode through the int8 pair only."""
    dev = cuda_device
    cfg = get_config("llada-moe-tiny", hidden_size=128, moe_intermediate_size=128,
                     head_dim=32)                               # bf16
    params = init_params(cfg, seed=6, device=dev, leaf_transform=quantized_leaf_transform)
    ids = torch.randint(3, 400, (2, 40), device=dev)
    lk, _ = make_forward_fn(cfg, device=dev)(params, ids)
    with monkeypatch.context() as m:
        m.setattr(attention, "flash_attention", fa.flash_attention_plain)
        m.setattr(gg, "grouped_gateup_q", gg.grouped_gateup_q_plain)
        m.setattr(gg, "grouped_down_q", gg.grouped_down_q_plain)
        lp, _ = make_forward_fn(cfg, device=dev)(params, ids)
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
