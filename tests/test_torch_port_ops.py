"""PyTorch port against the JAX package, op by op, in f32 on the CPU.

Inputs come from a numpy seed and go through both the JAX function (Pallas
kernels in interpret mode, as the JAX package's own tests run them) and the
port's counterpart, whose kernels take their plain PyTorch versions on CPU
tensors.  Tolerances are stated per test: the two sides run the same f32
arithmetic in different summation orders.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.models import layers as jl
from ct_diffusionmodelbench_tpu.models import moe as jmoe
from ct_diffusionmodelbench_tpu.ops import grouped_gemm_pallas as jgg
from ct_diffusionmodelbench_tpu.ops import sampling_ops as jso
from ct_diffusionmodelbench_tpu.ops.flash_attention import flash_attention as j_flash
from ct_diffusionmodelbench_tpu.sampling.schedule import (
    get_num_transfer_tokens as j_transfer)
from ct_diffusionmodelbench_tpu_torch.models import layers as tl
from ct_diffusionmodelbench_tpu_torch.models import moe as tmoe
from ct_diffusionmodelbench_tpu_torch.ops import attention as tattn
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as tgg
from ct_diffusionmodelbench_tpu_torch.ops import sampling_ops as tso
from ct_diffusionmodelbench_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain)
from ct_diffusionmodelbench_tpu_torch.sampling.schedule import (
    get_num_transfer_tokens as t_transfer)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

# ops/__init__ re-exports the function ``attention`` over the module's name.
jattn = importlib.import_module("ct_diffusionmodelbench_tpu.ops.attention")

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)      # one op, f32
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)       # f32 softmax over <= 64 keys
GROUPED_TOL = dict(rtol=1e-4, atol=1e-5)    # as tests/test_grouped_gemm_pallas.py


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# layers, sampler ops
# ---------------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(tl.rms_norm(_t(x), _t(scale), 1e-5),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), LAYER_TOL)
    pos = np.cumsum(rng.integers(0, 2, (2, 11)), axis=1).astype(np.int32)
    cos_t, sin_t = tl.rope_angles(_t(pos), 16, 10000.0)
    cos_j, sin_j = jl.rope_angles(jnp.asarray(pos), 16, 10000.0)
    _close(cos_t, cos_j, LAYER_TOL)
    _close(sin_t, sin_j, LAYER_TOL)
    _close(tl.apply_rope(_t(x), cos_t, sin_t),
           jl.apply_rope(jnp.asarray(x), cos_j, sin_j), LAYER_TOL)
    h = rng.standard_normal((5, 16)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) / 4 for s in
          ((16, 24), (16, 24), (24, 16))]
    _close(tl.swiglu(_t(h), *map(_t, ws)),
           jl.swiglu(jnp.asarray(h), *map(jnp.asarray, ws)), LAYER_TOL)


def test_sampling_ops_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32)
    np.testing.assert_array_equal(tso.gumbel_rescore(_t(logits), 0.0).numpy(),
                                  logits)
    chosen = rng.integers(0, 50, (3, 7))
    _close(tso.token_confidence(_t(logits), _t(chosen)),
           jso.token_confidence(jnp.asarray(logits), jnp.asarray(chosen)),
           LAYER_TOL)
    # ties and -inf must rank exactly as the reference's stable argsort
    conf = rng.integers(0, 4, (4, 16)).astype(np.float32)
    conf[0, 3:9] = -np.inf
    k = np.array([0, 3, 16, 7], np.int32)
    np.testing.assert_array_equal(
        tso.rank_topk_mask(_t(conf), _t(k)).numpy(),
        np.asarray(jso.rank_topk_mask(jnp.asarray(conf), jnp.asarray(k))))
    mask = rng.random((4, 32)) < 0.6
    for steps in (1, 4, 7):
        np.testing.assert_array_equal(
            t_transfer(_t(mask), steps).numpy(),
            np.asarray(j_transfer(jnp.asarray(mask), steps)))


def test_gumbel_rescore_uses_generator():
    logits = torch.zeros((2, 3, 40))
    a = tso.gumbel_rescore(logits, 1.0, torch.Generator().manual_seed(3))
    b = tso.gumbel_rescore(logits, 1.0, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.std() > 0.5


# ---------------------------------------------------------------------------
# attention (flash kernel's plain version, reference, dispatcher)
# ---------------------------------------------------------------------------

def _attn_inputs(seed, b, s, h, kv, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, :5] = 0                               # left padding
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    return q, k, v, mask, pos


@pytest.mark.parametrize("h,kv", [(4, 2), (8, 2)])    # GQA rep 2 and 4
@pytest.mark.parametrize("s", [37, 70])              # not a multiple of any tile
def test_flash_plain_matches_jax(h, kv, s):
    q, k, v, mask, pos = _attn_inputs(s + h, 2, s, h, kv, 32)
    cos_j, sin_j = jl.rope_angles(jnp.asarray(pos), 32, 10000.0)
    cos_t, sin_t = tl.rope_angles(_t(pos), 32, 10000.0)
    got = flash_attention_plain(_t(q), _t(k), _t(v), mask=_t(mask),
                                rope=(cos_t, sin_t))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   mask=jnp.asarray(mask), rope=(cos_j, sin_j))
    _close(got, want, ATTN_TOL)
    ref = jattn.attention_reference(
        jl.apply_rope(jnp.asarray(q), cos_j, sin_j),
        jl.apply_rope(jnp.asarray(k), cos_j, sin_j), jnp.asarray(v),
        mask=jnp.asarray(mask))
    _close(got, ref, ATTN_TOL)
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal(flash_attention(_t(q), _t(k), _t(v), mask=_t(mask),
                                       rope=(cos_t, sin_t)), got)


@pytest.mark.parametrize("s", [37, 300])
def test_flash_plain_all_masked_row_matches_jax(s):
    """A row whose every key is masked averages V over the reference's
    padded key length (zero keys past S), not over S."""
    q, k, v, mask, _ = _attn_inputs(s, 2, s, 4, 2, 16)
    mask[0] = 0
    got = flash_attention_plain(_t(q), _t(k), _t(v), mask=_t(mask))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   mask=jnp.asarray(mask))
    _close(got, want, ATTN_TOL)


def test_flash_plain_without_rope_or_mask():
    q, k, v, _, _ = _attn_inputs(5, 2, 21, 4, 1, 16)
    got = flash_attention_plain(_t(q), _t(k), _t(v))
    want = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("impl", ["auto", "reference", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_dispatch_matches_jax(impl, causal):
    q, k, v, mask, pos = _attn_inputs(9, 2, 19, 4, 2, 16)
    cos_j, sin_j = jl.rope_angles(jnp.asarray(pos), 16, 10000.0)
    cos_t, sin_t = tl.rope_angles(_t(pos), 16, 10000.0)
    got = tattn.attention(_t(q), _t(k), _t(v), mask=_t(mask), impl=impl,
                          causal=causal, rope=(cos_t, sin_t))
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           mask=jnp.asarray(mask), impl="reference",
                           causal=causal, rope=(cos_j, sin_j))
    _close(got, want, ATTN_TOL)


# ---------------------------------------------------------------------------
# grouped expert GEMMs
# ---------------------------------------------------------------------------

def _grouped_inputs(seed, n=48, d=128, e=6, f=128, k=2, layers=None, skew=False):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    x = rng.standard_normal((n, d)).astype(np.float32)
    wg = (rng.standard_normal(lead + (e, d, f)) / math.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal(lead + (e, d, f)) / math.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal(lead + (e, f, d)) / math.sqrt(f)).astype(np.float32)
    wr = (rng.standard_normal((d, e)) / math.sqrt(d)).astype(np.float32)
    probs, idx, _ = jmoe.router_probs(jnp.asarray(x), jnp.asarray(wr), k, True)
    idx = np.asarray(idx)
    if skew:  # experts {0, 3} only: the worst-case ragged layout
        idx = np.zeros_like(idx)
        idx[:, 1] = 3
    return x, np.asarray(probs), idx, wg, wu, wd


@pytest.mark.parametrize("m,tile_m,want", [
    (20480, 64, 64), (65535, 64, 64), (65536, 64, 128), (69632, 64, 128),
    (69632, 32, 32), (1024, 128, 128)])
def test_layout_tile_m_follows_reference_rule(m, tile_m, want):
    """``grouped_expert_ffn_pallas``'s row tile: 128 from M 65536 up where
    the caller left the default 64, else the caller's."""
    assert tgg.TILE_M == jgg.TILE_M == 64
    assert tgg.layout_tile_m(m, tile_m) == want


@pytest.mark.parametrize("e,tile_m", [(6, 8), (64, 64), (5, 16)])
@pytest.mark.parametrize("skew", [False, True])
def test_counting_layout_matches_jax(e, tile_m, skew):
    rng = np.random.default_rng(e + tile_m)
    idx = rng.integers(0, e, (37, 4)).astype(np.int32)
    if skew:
        idx[:, :3] = e - 1
    dest_j, te_j, sizes_j, mpad_j = jgg.counting_layout(jnp.asarray(idx), e, tile_m)
    dest_t, te_t, sizes_t, mpad_t = tgg.counting_layout(_t(idx), e, tile_m)
    assert mpad_t == mpad_j
    np.testing.assert_array_equal(dest_t.numpy(), np.asarray(dest_j))
    np.testing.assert_array_equal(te_t.numpy(), np.asarray(te_j))
    np.testing.assert_array_equal(sizes_t.numpy(), np.asarray(sizes_j))
    assert te_t.dtype == torch.int32


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("layers", [None, 3])
def test_grouped_pair_plain_matches_jax_kernels(skew, layers):
    """Plain versions of the gate/up and down kernels against the JAX manual
    and padded kernel pairs (interpret mode), same padded rows."""
    x, probs, idx, wg, wu, wd = _grouped_inputs(7, layers=layers, skew=skew)
    li = None if layers is None else 1
    jli = None if li is None else jnp.int32(li)
    n, k = idx.shape
    tile = 8
    dest_j, te_j, _, m_pad = jgg.counting_layout(jnp.asarray(idx), wg.shape[-3], tile)
    src = jnp.zeros((m_pad,), jnp.int32).at[dest_j].set(
        jnp.arange(n * k, dtype=jnp.int32) // k)
    xp_j = jnp.take(jnp.asarray(x), src, axis=0)
    dest_t, te_t, _, _ = tgg.counting_layout(_t(idx), wg.shape[-3], tile)
    xp_t = tgg.gather_rows(_t(x), dest_t, k, m_pad)
    np.testing.assert_array_equal(xp_t.numpy(), np.asarray(xp_j))

    h_t = tgg.grouped_gateup(xp_t, _t(wg), _t(wu), te_t, tile, li)
    for fn in (jgg.grouped_gateup_manual, jgg.grouped_gateup_padded):
        h_j = fn(xp_j, jnp.asarray(wg), jnp.asarray(wu), te_j, tile,
                 layer_index=jli)
        _close(h_t, h_j, GROUPED_TOL)
    o_t = tgg.grouped_down(h_t, _t(wd), te_t, tile, li)
    h_in = jnp.asarray(h_t.numpy())
    for fn in (jgg.grouped_matmul_manual, jgg.grouped_matmul_padded):
        o_j = fn(h_in, jnp.asarray(wd), te_j, tile, layer_index=jli)
        _close(o_t, o_j, GROUPED_TOL)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("layers", [None, 2])
def test_grouped_expert_ffn_matches_jax(skew, layers):
    x, probs, idx, wg, wu, wd = _grouped_inputs(11, layers=layers, skew=skew)
    li = None if layers is None else 1
    got = tgg.grouped_expert_ffn_cuda(_t(x), _t(probs), _t(idx), _t(wg), _t(wu),
                                      _t(wd), tile_m=8, layer_index=li)
    want = jgg.grouped_expert_ffn_pallas(
        jnp.asarray(x), jnp.asarray(probs), jnp.asarray(idx), jnp.asarray(wg),
        jnp.asarray(wu), jnp.asarray(wd), tile_m=8,
        layer_index=None if li is None else jnp.int32(li))
    _close(got, want, GROUPED_TOL)
    wgl, wul, wdl = (w if li is None else w[li] for w in (wg, wu, wd))
    dense = jmoe._experts_dense(jnp.asarray(x), jnp.asarray(probs),
                                jnp.asarray(idx), jnp.asarray(wgl),
                                jnp.asarray(wul), jnp.asarray(wdl))
    _close(got, dense, GROUPED_TOL)
    _close(tmoe._experts_dense(_t(x), _t(probs), _t(idx), _t(wgl), _t(wul),
                               _t(wdl)), dense, GROUPED_TOL)


def _moe_params(seed, d, e, f, layers=None, shared=True):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)

    def w(shape, fan):
        return (rng.standard_normal(shape) / math.sqrt(fan)).astype(np.float32)

    p = {"router": w((d, e), d), "we_gate": w(lead + (e, d, f), d),
         "we_up": w(lead + (e, d, f), d), "we_down": w(lead + (e, f, d), f)}
    if shared:
        p.update(ws_gate=w((d, f), d), ws_up=w((d, f), d), ws_down=w((f, d), f))
    return p, rng.standard_normal((24, d)).astype(np.float32)


@pytest.mark.parametrize("d,f,layers", [(64, 32, None), (128, 128, None),
                                        (128, 128, 2)])
def test_moe_block_matches_jax_grouped(monkeypatch, d, f, layers):
    monkeypatch.setenv("CTDB_GROUPED_GEMM", "pallas")
    p, x = _moe_params(d + f, d, 8, f, layers)
    li = None if layers is None else 1
    want, aux_j = jmoe.moe_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, top_k=2,
        norm_topk=True, impl="grouped",
        layer_index=None if li is None else jnp.int32(li))
    got, aux_t = tmoe.moe_block(_t(x), {k: _t(v) for k, v in p.items()},
                                top_k=2, norm_topk=True, layer_index=li)
    _close(got, want, GROUPED_TOL)
    _close(aux_t, aux_j, GROUPED_TOL)
    dense, _ = tmoe.moe_block(_t(x), {k: _t(v) for k, v in p.items()},
                              top_k=2, norm_topk=True, impl="dense",
                              layer_index=li)
    _close(dense, want, GROUPED_TOL)


def test_router_top_k_ties_take_lowest_index():
    # identical router columns: every expert ties, top-k must be 0..k-1.  An
    # integer-valued x makes the tie exact: sums of small integers are exact
    # in f32 in any order, so no BLAS column order can break it by an ulp.
    x = torch.from_numpy(
        np.random.default_rng(0).integers(-4, 5, (5, 8)).astype(np.float32))
    w = torch.ones(8, 6)
    _, idx, _ = tmoe.router_probs(x, w, 3, True)
    assert idx.tolist() == [[0, 1, 2]] * 5
    _, idx_j, _ = jmoe.router_probs(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                                    3, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
