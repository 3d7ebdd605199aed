"""Latent attention's kernels on a card: K13 (``ops/mla_attention.py``'s
cache attention) and the prefill kernel (K8's block-causal design at q/k
heads of 192 and v heads of 128) against their plain versions, G4's sigmoid
mode against the torch chain bit for bit, and a two-layer decode at
kanana-2-30B-A3B's attention widths whose cached step (absorbed, K13) agrees with the
full forward (up-projected, the prefill kernel).

Marked ``cuda``; each test asks the ``cuda_device`` fixture, which skips
when no card is present (decided at run time, never at import).  On a
machine with a card and no JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_mla_cuda.py

Tolerances: ``ATTN_TOL`` as ``tests/test_torch_port_sdar_cuda.py``'s
``FLASH_TOL``: kernel and plain version take the same bf16 inputs and sum in
f32 but round P to bf16 against running maxima over other key ranges (K13
over 16 key splits merged in f32, the prefill kernel tile by tile), so an
output moves by up to two bf16 ulps.  ``LOGITS_TOL``: the two attention
forms round differently (the absorbed form rounds q·W_UK and the latent
output to bf16, the up-projected form every key and value), each a bf16
rounding of a layer's attention output; through two layers and the head
the f32 logits (magnitude ~4) agree to 0.1.
"""

import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.models.config import get_config
from ct_diffusionmodelbench_tpu_torch.models.sdar_cache import make_sdar_fns
from ct_diffusionmodelbench_tpu_torch.models.transformer import forward, init_params
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg
from ct_diffusionmodelbench_tpu_torch.ops import mla_attention as ma
from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS, reset_launch_counts

pytestmark = pytest.mark.cuda

ATTN_TOL = dict(rtol=2 ** -6, atol=4e-3)
LOGITS_TOL = dict(rtol=0.0, atol=0.1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(g, shape, dev):
    return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)


@pytest.mark.parametrize("b,bl,s,n_keys,pad_max", [
    (4, 4, 32768, 24576, 16384),     # kanana30b-ctx32k's step mid-decode
    (4, 4, 32768, 32768, 16384),     # its last commit
    (2, 4, 300, 41, 30),             # fewer keys than the splits: empty splits
    (1, 2, 100, 100, 0),             # rows that fill half a row tile
], ids=["cell-step", "cell-last-commit", "short", "half-tile"])
def test_mla_cache_attention_matches_plain(cuda_device, b, bl, s, n_keys, pad_max):
    dev = cuda_device
    h = 32
    g = torch.Generator(device=dev).manual_seed(b * s + n_keys)
    q = _bf16(g, (b, bl, h, 576), dev)
    cache = _bf16(g, (b, s, 576), dev)
    start = torch.randint(0, min(pad_max, n_keys - bl) + 1, (b,), generator=g, device=dev,
                          dtype=torch.int32)
    end = torch.tensor([n_keys], dtype=torch.int32, device=dev)
    scale = 192 ** -0.5
    reset_launch_counts()
    got = ma.mla_cache_attention_cuda(q, cache, start, end, 512, scale)
    torch.cuda.synchronize()
    assert KERNELS["mla_cache_attention"].launches == 1
    want = ma.mla_cache_attention_plain(q, cache, start, end, 512, scale)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)


@pytest.mark.parametrize("b,s,h,starts,bl", [
    (1, 4096, 32, (1000,), 4),       # a long left pad: tiles before it skipped
    (2, 520, 4, (0, 201), 4),        # two rows, one unpadded
    (1, 130, 2, (67,), 3),           # blocks that straddle tiles
], ids=["long", "two-rows", "odd-block"])
def test_mla_prefill_attention_matches_plain(cuda_device, b, s, h, starts, bl):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(s * h)
    q = _bf16(g, (b, s, h, 192), dev)
    k = _bf16(g, (b, s, h, 192), dev)
    v = _bf16(g, (b, s, h, 128), dev)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    scale = 192 ** -0.5
    reset_launch_counts()
    got = ma.mla_prefill_attention_cuda(q, k, v, start, bl, scale)
    torch.cuda.synchronize()
    assert KERNELS["mla_prefill_attention"].launches == 1
    want = ma.mla_prefill_attention_plain(q, k, v, start, bl, scale)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)


@pytest.mark.parametrize("n,e,k,ties", [(4096, 128, 6, False), (300, 128, 6, True),
                                        (64, 8, 2, True)], ids=["cell", "ties", "tiny"])
def test_g4_sigmoid_bit_equal_to_chain(cuda_device, n, e, k, ties):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(n + e)
    logits = torch.randn((n, e), generator=g, device=dev)
    if ties:
        # Whole rows of a few values, so equal selection values abound.
        logits = torch.round(logits * 2) / 2
    bias = 0.02 * torch.randn((e,), generator=g, device=dev)
    if ties:
        bias = torch.zeros_like(bias)
    reset_launch_counts()
    got = gg.router_topk_cuda(logits, k, True, sigmoid=True, bias=bias, scale=2.448)
    torch.cuda.synchronize()
    assert KERNELS["moe_topk_sigmoid"].launches == 1
    want = gg.router_topk_plain(logits, k, True, sigmoid=True, bias=bias, scale=2.448)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def _kanana(layers: int, dense: int, dev):
    cfg = get_config("kanana-2-30b-a3b", num_layers=layers, first_k_dense_replace=dense)
    params = init_params(cfg, seed=3, device=dev)
    if "e_bias" in params["blocks"]:
        params["blocks"]["e_bias"].normal_(0.0, 0.02)
    return cfg, params


def _prefill_and_step(cfg, params, dev):
    """(the cached step's logits, the state it ran on and its mask)."""
    B, P, bl = 2, 256, cfg.block_length
    g = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(10, 128000, (B, P), generator=g, device=dev)
    mask = torch.ones((B, P), dtype=torch.int32, device=dev)
    mask[0, :61] = 0
    prefill, step, _ = make_sdar_fns(cfg)
    cache = prefill(params, ids, mask, P + bl, int(mask.sum()))
    blk = torch.full((B, bl), cfg.mask_token_id, device=dev)
    blk[:, 1] = 4242
    reset_launch_counts()
    got = step(params, cache, blk, P).clone()
    torch.cuda.synchronize()
    full = torch.cat([ids, blk], dim=1)
    full_mask = torch.cat([mask, torch.ones((B, bl), dtype=torch.int32, device=dev)], dim=1)
    return got, full, full_mask


def test_mla_decode_absorbed_matches_up_projected(cuda_device):
    """Two dense layers at kanana's widths: a prefill then a cached step
    (K13) against the full forward of the same state (the prefill kernel).
    Dense, so that no router near-tie (an expert flipped by a bf16
    rounding) moves a logit."""
    dev = cuda_device
    cfg, params = _kanana(2, 2, dev)
    got, full, full_mask = _prefill_and_step(cfg, params, dev)
    assert KERNELS["mla_cache_attention"].launches == cfg.num_layers
    P, bl = full.shape[1] - cfg.block_length, cfg.block_length
    with torch.inference_mode():
        want = forward(cfg, params, full, full_mask, logit_start=P, logit_length=bl)[0]
    torch.testing.assert_close(got, want, **LOGITS_TOL)


def test_mla_decode_step_launches(cuda_device):
    """kanana's first two layers (one dense, one of 128 experts): a cached
    step launches K13 a layer and G4's sigmoid mode an MoE layer."""
    dev = cuda_device
    cfg, params = _kanana(2, 1, dev)
    got, _, _ = _prefill_and_step(cfg, params, dev)
    assert bool(torch.isfinite(got).all())
    assert KERNELS["mla_cache_attention"].launches == cfg.num_layers
    assert KERNELS["moe_topk_sigmoid"].launches == cfg.num_layers - cfg.dense_layers
    assert KERNELS["moe_topk"].launches == 0
