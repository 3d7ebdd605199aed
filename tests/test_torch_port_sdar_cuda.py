"""The SDAR family's kernels on a card: K12 (``ops/cache_attention.py``)
and the flash kernel's block-causal mode against their plain versions, and
the exact launches of an ``sdar-tiny`` decode.

Marked ``cuda``; each test asks the ``cuda_device`` fixture, which skips
when no card is present (decided at run time, never at import).  On a
machine with a card and no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_sdar_cuda.py

Tolerance (``FLASH_TOL``, as ``tests/test_torch_port_cuda.py``'s flash
tests): kernel and plain version take the same bf16 inputs and sum in f32,
but round P to bf16 against running maxima taken over other key ranges
(K12 merges four key quarters, the plain version takes one max), so an
output moves by up to two bf16 ulps.
"""

import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.models.layers import rope_angles
from ct_diffusionmodelbench_tpu_torch.models.transformer import token_positions
from ct_diffusionmodelbench_tpu_torch.ops import attention as attn_ops
from ct_diffusionmodelbench_tpu_torch.ops import cache_attention as ca
from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts

pytestmark = pytest.mark.cuda

FLASH_TOL = dict(rtol=2 ** -6, atol=4e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(g, shape, dev):
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)


@pytest.mark.parametrize("b,bl,h,kv,dh,s,n_keys,pad_max", [
    (32, 4, 32, 4, 128, 832, 580, 320),     # sdar30b-eval's first step
    (32, 4, 32, 4, 128, 832, 832, 320),     # its last commit
    (3, 4, 4, 2, 16, 40, 28, 11),           # sdar-tiny
    (2, 2, 8, 2, 64, 300, 17, 9),           # fewer keys than a warp's quarter
    (4, 1, 32, 1, 32, 200, 200, 150),       # 32 rows from heads alone
], ids=["sdar-first-step", "sdar-last-commit", "tiny", "short", "mqa"])
def test_cache_attention_kernel_matches_plain(cuda_device, b, bl, h, kv, dh, s, n_keys,
                                             pad_max):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(b * s + n_keys)
    q = _bf16(g, (b, bl, h, dh), dev)
    k = _bf16(g, (b, s, kv, dh), dev)
    v = _bf16(g, (b, s, kv, dh), dev)
    start = torch.randint(0, min(pad_max, n_keys - bl) + 1, (b,), generator=g, device=dev,
                          dtype=torch.int32)
    end = torch.tensor([n_keys], dtype=torch.int32, device=dev)
    got = ca.cache_attention(q, k, v, start, end)
    torch.testing.assert_close(got, ca.cache_attention_plain(q, k, v, start, end),
                               **FLASH_TOL)
    # Keys outside a row's range are never read: changing them changes nothing.
    k2, v2 = k.clone(), v.clone()
    k2[:, n_keys:] = 1e4
    v2[:, n_keys:] = float("nan")
    for r in range(b):
        k2[r, :int(start[r])] = -1e4
        v2[r, :int(start[r])] = float("nan")
    assert torch.equal(ca.cache_attention(q, k2, v2, start, end), got)


def test_cache_attention_refuses(cuda_device):
    dev = cuda_device
    q = torch.zeros((2, 8, 32, 128), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 64, 4, 128), dtype=torch.bfloat16, device=dev)
    start = torch.zeros(2, dtype=torch.int32, device=dev)
    end = torch.tensor([64], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="pack"):
        ca.cache_attention(q, k, k, start, end)         # 8 x 8 rows > 32
    q4 = q[:, :4].contiguous()
    with pytest.raises(ValueError, match="key_end"):
        ca.cache_attention(q4, k, k, start, end.long())
    with pytest.raises(ValueError, match="key_start"):
        ca.cache_attention(q4, k, k, start.long(), end)
    with pytest.raises(ValueError, match="contiguous"):
        ca.cache_attention(q[:, :4], k, k, start, end)


@pytest.mark.parametrize("b,s,h,kv,dh,bl,pads,rope", [
    (2, 576, 32, 4, 128, 4, (0, 320), True),        # sdar30b-eval's prefill rows
    (3, 130, 4, 2, 16, 2, (5, 0, 64), False),
    (2, 300, 8, 8, 64, 64, (70, 3), True),
    (1, 64, 16, 4, 32, 1, (0,), False),             # block length 1: causal
], ids=["sdar", "tiny-odd", "blocks-of-64", "causal"])
def test_block_causal_flash_kernel_matches_plain(cuda_device, b, s, h, kv, dh, bl, pads,
                                                 rope):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(s + bl)
    q, k, v = (_bf16(g, (b, s, n, dh), dev) for n in (h, kv, kv))
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    for r, n in enumerate(pads):
        mask[r, :n] = 0
    rp = rope_angles(token_positions(mask, b, s, dev), dh, 1e6) if rope else None
    reset_launch_counts()
    got = fa.flash_attention(q, k, v, mask=mask, rope=rp, block_len=bl)
    assert KERNELS["flash_attention_fwd_block_causal"].launches == 1
    assert KERNELS["flash_attention_fwd"].launches == 0
    want = fa.flash_attention_plain(q, k, v, mask=mask, rope=rp, block_len=bl)
    torch.testing.assert_close(got, want, **FLASH_TOL)


def test_sdar_tiny_decode_launches(cuda_device, monkeypatch):
    """An sdar-tiny decode on the card runs K12 once a layer for every step
    and commit, the block-causal flash kernel once a layer for the prefill,
    and no other attention: no SDPA, no reference attention; K1, K2, G3
    (the combine), G4 (the router's top-k) and G5 (the layout) once a layer
    for every pass."""
    runner = ModelRunner.random_init("sdar-tiny", seed=3, device=cuda_device)
    cfg = runner.cfg
    rng = np.random.default_rng(0)
    ids = rng.integers(10, 400, (2, 16))
    mask = np.ones((2, 16), np.int32)
    mask[0, :5] = 0
    called = []
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        lambda *a, **k: called.append("sdpa"))
    monkeypatch.setattr(attn_ops, "attention_reference",
                        lambda *a, **k: called.append("reference"))
    reset_launch_counts()
    out = runner.generate_ids(ids, attn_mask=mask, gen_length=16, steps=16, block_length=4)
    passes = 16 + 4                          # steps and commits, graphs after the first
    launches = {n: k.launches for n, k in KERNELS.items()}
    assert launches["cache_attention"] == cfg.num_layers * passes
    assert launches["flash_attention_fwd_block_causal"] == cfg.num_layers
    assert launches["flash_attention_fwd"] == launches["flash_attention_direct"] == 0
    assert launches["grouped_gateup"] == launches["grouped_down"] == cfg.num_layers * (1 + passes)
    assert launches["moe_combine"] == cfg.num_layers * (1 + passes)
    assert launches["moe_topk"] == launches["moe_layout"] == cfg.num_layers * (1 + passes)
    assert not called and not (out[:, 16:] == cfg.mask_token_id).any()


def test_sdar_graphed_passes_match_eager(cuda_device, monkeypatch):
    """The steps and commits replayed as CUDA graphs give the tokens the
    same decode run eagerly gives."""
    from ct_diffusionmodelbench_tpu_torch.models import sdar_cache

    runner = ModelRunner.random_init("sdar-tiny", seed=5, device=cuda_device)
    rng = np.random.default_rng(1)
    ids = rng.integers(10, 400, (3, 13))
    mask = np.ones((3, 13), np.int32)
    mask[1, :4] = 0
    kw = dict(gen_length=24, steps=12, block_length=4)
    graphed = runner.generate_ids(ids, attn_mask=mask, **kw)
    again = runner.generate_ids(ids, attn_mask=mask, **kw)   # replays only
    monkeypatch.setattr(sdar_cache.GraphedPass, "__call__", lambda self, ids: self.fn(ids))
    runner.block_fns = sdar_cache.make_sdar_fns(runner.cfg)
    eager = runner.generate_ids(ids, attn_mask=mask, **kw)
    np.testing.assert_array_equal(graphed, eager)
    np.testing.assert_array_equal(again, eager)

