"""The reference's pad-skip (``tile_valid``) in the port's bf16 grouped pair.

The bf16 gate/up and down kernels (K1/K4, K2/K5) take the pad-skip vector
as the int8 pair does: a row tile that ``tile_valid`` marks 0 holds no real
row and comes out as zeros.  Here, on the CPU, the plain versions (which
the wrappers take for CPU tensors) run against JAX's manual kernels with
``tile_valid`` (interpret mode), and ``grouped_expert_ffn_cuda`` against
``grouped_expert_ffn_pallas`` with the switch ``CTDB_GROUPED_SKIP_PAD`` off
and on.  Inputs are seeded with numpy and go to both packages as the same
arrays; tolerances as ``tests/test_torch_port_ops.py`` (one f32 product,
summed in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.models import moe as jmoe
from ct_diffusionmodelbench_tpu.ops import grouped_gemm_pallas as jgg
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as tgg

GROUPED_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, n, k, e, d, f, layers=None):
    """x [n, d], router output for top-k of e experts, f32 expert weights."""
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)

    def w(shape, fan):
        return (rng.standard_normal(shape) / math.sqrt(fan)).astype(np.float32)

    x = rng.standard_normal((n, d)).astype(np.float32)
    probs, idx, _ = jmoe.router_probs(jnp.asarray(x), jnp.asarray(w((d, e), d)), k, True)
    return (x, np.asarray(probs), np.asarray(idx),
            (w(lead + (e, d, f), d), w(lead + (e, d, f), d), w(lead + (e, f, d), f)))


def _reference_tile_valid(sizes, tile_expert, tile_m, m_pad):
    """``tile_valid`` as ``grouped_expert_ffn_pallas`` builds it under
    ``CTDB_GROUPED_SKIP_PAD=1``."""
    padded = jgg._round_up_arr(sizes, tile_m)
    pend_real = jnp.cumsum(padded) - padded + sizes
    tile_start = jnp.arange(m_pad // tile_m, dtype=jnp.int32) * tile_m
    return (tile_start < jnp.take(pend_real, tile_expert)).astype(jnp.int32)


@pytest.mark.parametrize("layers,last_empty", [(None, False), (2, True), (None, True)])
def test_bf16_grouped_pair_plain_pad_skip_matches_jax(layers, last_empty):
    """The plain versions of K1/K2 with ``tile_valid`` against JAX's manual
    bf16 kernels with it (D = F = 128, which the manual kernels need).  The
    reference zero-fills a tile marked 0 unless it starts an expert run:
    that one it still multiplies, to keep its weight-DMA semaphores
    balanced.  No real row lies there, the combine reads none of it, and
    the port zero-fills it too.  With the last expert empty, the trailing
    padding tiles form such a run; the test checks the real rows against
    the reference and the zero rows, as the int8 pair's test does."""
    x, _, idx, (wg, wu, wd) = _inputs(5, 48, 2, 4, 128, 128, layers)
    if last_empty:
        idx = np.where(idx == 3, 2, idx)
    li = None if layers is None else 1
    jli = None if li is None else jnp.int32(li)
    k = idx.shape[1]
    tile = 16
    dest_t, te_t, sizes_t, m_pad = tgg.counting_layout(_t(idx), 4, tile)
    valid_t = tgg.valid_tiles(sizes_t, te_t, tile, m_pad)
    te_j = jnp.asarray(te_t.numpy())
    valid_j = _reference_tile_valid(jnp.asarray(sizes_t.numpy()), te_j, tile, m_pad)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert int((valid_t == 0).sum()) > 0
    te_np = te_t.numpy()
    starts = np.r_[True, te_np[1:] != te_np[:-1]]
    skipped = (valid_t.numpy() == 0) & ~starts          # the reference's zero tiles
    run_start = (valid_t.numpy() == 0) & starts
    assert run_start.any() == last_empty
    real = np.repeat(valid_t.numpy() == 1, tile)
    xs_t = tgg.gather_rows(_t(x), dest_t, k, m_pad)
    xs_j = jnp.asarray(xs_t.numpy())

    def check(got, want):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[real], want[real], **GROUPED_TOL)
        assert not got[~real].any() and not want[np.repeat(skipped, tile)].any()
        return want[np.repeat(run_start, tile)]

    h_t = tgg.grouped_gateup(xs_t, _t(wg), _t(wu), te_t, tile, li, valid_t)
    h_run_start = check(h_t, jgg.grouped_gateup_manual(
        xs_j, jnp.asarray(wg), jnp.asarray(wu), te_j, tile, layer_index=jli,
        tile_valid=valid_j))
    assert h_run_start.any() == last_empty              # multiplied there
    o_t = tgg.grouped_down(h_t, _t(wd), te_t, tile, li, valid_t)
    check(o_t, jgg.grouped_matmul_manual(jnp.asarray(h_t.numpy()), jnp.asarray(wd),
                                         te_j, tile, layer_index=jli, tile_valid=valid_j))
    # Without the vector, the plain versions multiply every tile; the real
    # rows are the same.
    h_all = tgg.grouped_gateup_plain(xs_t, _t(wg), _t(wu), te_t, tile, li)
    np.testing.assert_array_equal(h_all.numpy()[real], h_t.numpy()[real])


@pytest.mark.parametrize("layers", [None, 2])
def test_bf16_grouped_expert_ffn_hands_tile_valid(monkeypatch, layers):
    """``grouped_expert_ffn_cuda`` hands both bf16 calls the same
    ``tile_valid`` on every call; its output matches
    ``grouped_expert_ffn_pallas`` with ``CTDB_GROUPED_SKIP_PAD`` at "0" and
    at "1"."""
    x, probs, idx, ws = _inputs(6, 48, 2, 4, 128, 128, layers)
    li = None if layers is None else 1
    seen = []

    def recording(kernel):
        def run(*args):
            seen.append(args[-1])
            return kernel(*args)
        return run

    monkeypatch.setattr(tgg, "grouped_gateup", recording(tgg.grouped_gateup))
    monkeypatch.setattr(tgg, "grouped_down", recording(tgg.grouped_down))
    got = tgg.grouped_expert_ffn_cuda(_t(x), _t(probs), _t(idx), *[_t(w) for w in ws],
                                      tile_m=16, layer_index=li)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert bool((seen[0] == 0).any())
    for skip in ("0", "1"):
        monkeypatch.setenv("CTDB_GROUPED_SKIP_PAD", skip)
        want = jgg.grouped_expert_ffn_pallas(
            jnp.asarray(x), jnp.asarray(probs), jnp.asarray(idx),
            *[jnp.asarray(w) for w in ws], tile_m=16,
            layer_index=None if li is None else jnp.int32(li))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GROUPED_TOL)


def test_bf16_unaligned_expert_ffn_hands_tile_valid(monkeypatch):
    """D and F not multiples of 128: the reference takes its padded kernels
    with no ``tile_valid``; the port hands the pair the vector all the same,
    and the FFN output (the combine reads only real rows) matches."""
    x, probs, idx, ws = _inputs(7, 40, 2, 6, 64, 32)
    seen = []
    gateup = tgg.grouped_gateup
    monkeypatch.setattr(tgg, "grouped_gateup",
                        lambda *a: seen.append(a[-1]) or gateup(*a))
    got = tgg.grouped_expert_ffn_cuda(_t(x), _t(probs), _t(idx), *[_t(w) for w in ws],
                                      tile_m=8)
    assert len(seen) == 1 and seen[0] is not None and bool((seen[0] == 0).any())
    want = jgg.grouped_expert_ffn_pallas(
        jnp.asarray(x), jnp.asarray(probs), jnp.asarray(idx),
        *[jnp.asarray(w) for w in ws], tile_m=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GROUPED_TOL)

