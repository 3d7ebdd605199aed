"""The port's sequence parallelism (ring attention over the ``seq`` axis)
against the JAX package, on the CPU.

Mirrors ``tests/test_ring_attention.py``.  Four ``gloo`` ranks
(``tests/torch_port_dist.py``) run only the port; this process computes
the JAX side: its ``ring_attention`` on the same mesh shape over the
virtual CPU devices, its dense reference, and its single-device forward.
The JAX cases on 8 devices run here on four ranks: seq 8 is cut to 4, the
2×2×2 mesh to 1×2×2 and 2×2×1.  Tolerances: attention and its gradients
2e-5 relative and absolute (f32, chunked against one softmax: the
summation order differs); logits 2e-4 and aux 1e-4 / 1e-5, the
reference's own for its sharded forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_forward_fn
from ct_diffusionmodelbench_tpu.ops.attention import attention_reference as j_ref
from ct_diffusionmodelbench_tpu.ops.ring_attention import ring_attention as j_ring
from ct_diffusionmodelbench_tpu.parallel.mesh import make_mesh as j_make_mesh
from tests.torch_port_dist import RankPool
from tests.torch_port_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
AUX_TOL = dict(rtol=1e-4, atol=1e-5)
MESHES = [(1, 4, 1), (2, 2, 1), (1, 2, 2)]   # (dp, sp, tp)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _qkv(seed, b=2, s=64, h=4, kv=2, dh=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)))


def _assemble(pieces, shape, dp, sp, tp, key="out", index=None):
    """The whole [B, S, H, Dh] tensor from the ranks' (rows, positions,
    heads) pieces."""
    out = np.zeros(shape, np.float32)
    b, s, h = shape[:3]
    for p in pieces:
        d, q, m = p["coords"]
        t = p[key] if index is None else p[key][index]
        rb, rs, rh = b // dp, s // sp, h // tp
        out[d * rb:(d + 1) * rb, q * rs:(q + 1) * rs, m * rh:(m + 1) * rh] = t
    return out


def _jax_ring(q, k, v, mask, dp, sp, tp):
    mesh = j_make_mesh(data=dp, seq=sp, model=tp)
    ring = jax.jit(lambda *a: j_ring(*a[:3], mask=None if len(a) == 3 else a[3],
                                     mesh=mesh))
    return np.asarray(ring(*map(jnp.asarray, (q, k, v) + (() if mask is None else (mask,)))))


@pytest.mark.parametrize("dp,sp,tp", MESHES)
def test_ring_matches_jax_ring_and_reference(pool, dp, sp, tp):
    q, k, v = _qkv(0)
    pieces = pool.run("ring_piece", q, k, v, None, dp, sp, tp)
    got = _assemble(pieces, q.shape, dp, sp, tp)
    np.testing.assert_allclose(got, _jax_ring(q, k, v, None, dp, sp, tp), **ATTN_TOL)
    np.testing.assert_allclose(got, np.asarray(j_ref(q, k, v)), **ATTN_TOL)


def test_ring_with_padding_mask_and_a_padded_chunk(pool):
    """Left-padded rows at seq 4: row 0's first two chunks (40 of 64 keys)
    are all padding, so their lse is about -1e30 and their weight in the
    combine 0.  Padded query rows are garbage in every implementation;
    only real rows are compared."""
    q, k, v = _qkv(1)
    mask = (np.arange(64)[None, :] >= np.array([40, 5])[:, None]).astype(np.int32)
    pieces = pool.run("ring_piece", q, k, v, mask, 1, 4, 1)
    got = _assemble(pieces, q.shape, 1, 4, 1)
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], _jax_ring(q, k, v, mask, 1, 4, 1)[real],
                               **ATTN_TOL)
    np.testing.assert_allclose(got[real], np.asarray(j_ref(q, k, v, mask=mask))[real],
                               **ATTN_TOL)


@pytest.mark.parametrize("dp,sp,tp", [(1, 4, 1), (1, 2, 2)])
def test_ring_grad_matches_jax(pool, dp, sp, tp):
    """The gradient of Σ tanh(ring attention) through the port's autograd
    Function (the flash backward chunk by chunk with the final o / lse)
    against ``jax.grad`` of the JAX ring's."""
    q, k, v = _qkv(2, s=64, dh=16)
    mesh = j_make_mesh(data=dp, seq=sp, model=tp)

    def loss(q_, k_, v_):
        return jnp.sum(jnp.tanh(j_ring(q_, k_, v_, mesh=mesh)))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    want_ref = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.tanh(j_ref(*a))),
                                argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    pieces = pool.run("ring_piece", q, k, v, None, dp, sp, tp, grad=True)
    for i, t in enumerate((q, k, v)):
        got = _assemble(pieces, t.shape, dp, sp, tp, key="grads", index=i)
        np.testing.assert_allclose(got, np.asarray(want[i]), **ATTN_TOL)
        np.testing.assert_allclose(got, np.asarray(want_ref[i]), **ATTN_TOL)


def test_dispatcher_takes_ring_path_under_seq_mesh(pool):
    """``impl="auto"`` on a split sequence takes the ring: one rotation of
    (k, v) at seq 2, no gather."""
    q, k, v = _qkv(3)
    pieces = pool.run("ring_piece", q, k, v, None, 2, 2, 1)
    np.testing.assert_allclose(_assemble(pieces, q.shape, 2, 2, 1),
                               np.asarray(j_ref(q, k, v)), **ATTN_TOL)
    for p in pieces:
        assert p["counts"]["p2p"] == 2 and p["counts"]["all_gather"] == 0


def test_dispatcher_whole_sequence_fallback(pool):
    """A sequence that does not divide by seq (100 at seq 4) stays whole on
    every seq rank: attention runs over all of it, with no transfer."""
    q, k, v = _qkv(4, s=100)
    pieces = pool.run("ring_piece", q, k, v, None, 1, 4, 1, split=False)
    want = np.asarray(j_ref(q, k, v))
    for p in pieces:
        np.testing.assert_allclose(p["out"], want, **ATTN_TOL)
        assert p["counts"]["p2p"] == 0


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_explicit_impl_wins_under_seq_mesh(pool, impl):
    """An explicit impl is not replaced by the ring: q / k / v gather over
    seq, the impl runs on the whole sequence and each rank keeps its
    rows."""
    q, k, v = _qkv(6)
    pieces = pool.run("ring_piece", q, k, v, None, 2, 2, 1, impl=impl)
    np.testing.assert_allclose(_assemble(pieces, q.shape, 2, 2, 1),
                               np.asarray(j_ref(q, k, v)), **ATTN_TOL)
    for p in pieces:
        assert p["counts"]["p2p"] == 0 and p["counts"]["all_gather"] == 3


def _weights(preset, seed):
    cfg = j_get_config(preset, dtype="float32")
    params = j_init(cfg, jax.random.key(seed))
    return cfg, params, jax.tree.map(np.asarray, params)


FORWARD_CASES = [("llada-tiny", 1, 2, 2), ("llada-tiny", 2, 2, 1),
                 ("llada-moe-tiny", 2, 2, 1), ("llada-moe-tiny", 1, 4, 1),
                 ("dream-tiny", 1, 2, 2)]


@pytest.mark.parametrize("preset,dp,sp,tp", FORWARD_CASES)
def test_full_forward_under_seq_mesh(pool, preset, dp, sp, tp):
    """The sharded forward with the sequence over seq (ring attention, the
    MoE statistics summed over seq, Dream's shift across slices) against
    the JAX single-device forward."""
    cfg, params, params_np = _weights(preset, 0)
    ids = np.asarray(jax.random.randint(jax.random.key(5), (2, 64), 0, cfg.vocab_size))
    want, aux = j_forward_fn(cfg)(params, jnp.asarray(ids))
    for logits, got_aux, _ in pool.run("sharded_forward", preset, params_np, ids,
                                       dp, tp, seq=sp):
        np.testing.assert_allclose(logits, np.asarray(want), **LOGITS_TOL)
        np.testing.assert_allclose(got_aux, float(aux), **AUX_TOL)


@pytest.mark.parametrize("preset,sp,tp", [("dream-tiny", 4, 1), ("llada-moe-tiny", 2, 2)])
def test_masked_forward_and_logit_range_under_seq_mesh(pool, preset, sp, tp):
    """Left-padded rows (RoPE positions restart per row: the real tokens
    of the earlier slices are counted over seq) and a logit range that
    crosses slices (the hidden states gathered over seq first)."""
    cfg, params, params_np = _weights(preset, 1)
    ids = np.asarray(jax.random.randint(jax.random.key(6), (2, 64), 0, cfg.vocab_size))
    mask = (np.arange(64)[None, :] >= np.array([21, 3])[:, None]).astype(np.int32)
    fwd = j_forward_fn(cfg)
    want, _ = fwd(params, jnp.asarray(ids), jnp.asarray(mask))
    want_r, _ = fwd(params, jnp.asarray(ids), jnp.asarray(mask), logit_start=24,
                    logit_length=16)
    real = mask.astype(bool)
    for logits, _, _ in pool.run("sharded_forward", preset, params_np, ids, 1, tp,
                                 mask=mask, seq=sp):
        np.testing.assert_allclose(logits[real], np.asarray(want)[real], **LOGITS_TOL)
    for logits, _, _ in pool.run("sharded_forward", preset, params_np, ids, 1, tp,
                                 mask=mask, seq=sp, logit_start=24, logit_length=16):
        np.testing.assert_allclose(logits, np.asarray(want_r), **LOGITS_TOL)


def test_indivisible_sequence_runs_whole(pool):
    """S 30 at seq 4: every seq rank runs the whole sequence (the
    reference's seq_ax = None) and the logits match."""
    cfg, params, params_np = _weights("llada-tiny", 2)
    ids = np.asarray(jax.random.randint(jax.random.key(7), (2, 30), 3, cfg.vocab_size - 2))
    want, _ = j_forward_fn(cfg)(params, jnp.asarray(ids))
    for logits, _, _ in pool.run("sharded_forward", "llada-tiny", params_np, ids, 1, 1,
                                 seq=4):
        np.testing.assert_allclose(logits, np.asarray(want), **LOGITS_TOL)


def test_tail_batch_under_dp_sp_mesh(pool):
    """Mirrors ``test_sharding.py::test_tail_batch_under_dp_sp_mesh``: 3
    rows at dp 2 × sp 2 stay whole over data (every rank runs all rows)
    while the sequence splits, and the logits match the single device."""
    cfg, params, params_np = _weights("llada-tiny", 0)
    ids = np.asarray(jax.random.randint(jax.random.key(7), (3, 16), 3, cfg.vocab_size - 2))
    want, _ = j_forward_fn(cfg)(params, jnp.asarray(ids))
    for logits, _, _ in pool.run("sharded_forward", "llada-tiny", params_np, ids, 2, 1,
                                 seq=2):
        assert logits.shape[0] == 3
        np.testing.assert_allclose(logits, np.asarray(want), **LOGITS_TOL)
