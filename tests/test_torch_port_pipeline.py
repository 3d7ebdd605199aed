"""The port's pipeline parallelism (GPipe over the ``stage`` axis) against
the JAX package, on the CPU.

Mirrors ``tests/test_pipeline.py``'s sixteen cases.  Two or four ``gloo``
ranks (``tests/torch_port_dist.py``) run only the port; this process
computes the JAX side on the same weights (JAX ``init_params``): its dense
forward, its gradients and, for the MoE aux loss (the reference's GPipe
approximation), its own pipeline on the virtual CPU devices.  The JAX
meshes of 8 devices are cut to four ranks: 4 stages × dp 2 to 2 × 2, tp 4
within 2 stages to tp 4 within one stage, dp 2 × pp 2 × tp 2 to dp 2 × pp
2 on Dream.  Tolerances are the reference's: logits 2e-5, gradients rtol
5e-5 / atol 5e-6 (f32); the aux loss 1e-5 against JAX's pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_forward_fn
from ct_diffusionmodelbench_tpu.parallel import pipeline as jpp
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import init_params as t_init
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import Mesh
from ct_diffusionmodelbench_tpu_torch.parallel.pipeline import make_pp_forward
from tests.torch_port_dist import RankPool
from tests.torch_port_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

LOGITS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-6)
AUX_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = RankPool(world)
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _setup(name="llada-tiny", layers=4, seed=0):
    cfg = j_get_config(name, dtype="float32").replace(num_layers=layers)
    params = j_init(cfg, jax.random.key(seed))
    ids = np.asarray(jax.random.randint(jax.random.key(seed + 1), (4, 32), 3,
                                        cfg.vocab_size - 2))
    return cfg, params, jax.tree.map(np.asarray, params), ids


def _run(pools, name, stages, micro, dp=1, tp=1, mask=None, grad=False, seed=0):
    cfg, params, params_np, ids = _setup(name, seed=seed)
    out = pools(dp * stages * tp).run("pp_forward", name, params_np, ids, stages, micro,
                                      dp=dp, tp=tp, mask=mask, grad=grad, num_layers=4)
    return cfg, params, ids, out


def _dense(cfg, params, ids, mask=None):
    logits, _ = j_forward_fn(cfg)(params, jnp.asarray(ids),
                                  None if mask is None else jnp.asarray(mask))
    return np.asarray(logits)


@pytest.mark.parametrize("stages,micro", [(2, 2), (4, 4), (4, 1)])
def test_pp_logits_match_dense(pools, stages, micro):
    cfg, params, ids, out = _run(pools, "llada-tiny", stages, micro)
    want = _dense(cfg, params, ids)
    for logits, _, _, _ in out:
        np.testing.assert_allclose(logits, want, **LOGITS_TOL)


def test_pp_composes_with_dp(pools):
    cfg, params, ids, out = _run(pools, "llada-tiny", 2, 2, dp=2)
    want = _dense(cfg, params, ids)
    for logits, _, _, _ in out:
        np.testing.assert_allclose(logits, want, **LOGITS_TOL)


def test_pp_moe_stage_runs_and_matches(pools):
    """MoE stages (the grouped experts inside each stage): the logits equal
    the dense forward's, the aux loss is JAX's pipeline's (per microbatch,
    averaged: the reference's GPipe approximation)."""
    cfg, params, ids, out = _run(pools, "llada-moe-tiny", 2, 2, seed=2)
    want = _dense(cfg, params, ids)
    mesh = jpp.make_pp_mesh(stages=2)
    _, want_aux = jax.jit(jpp.make_pp_forward(cfg, mesh, num_microbatches=2))(
        jpp.shard_params_pp(cfg, params, mesh), jnp.asarray(ids))
    for logits, aux, _, _ in out:
        np.testing.assert_allclose(logits, want, **LOGITS_TOL)
        assert np.isfinite(aux) and aux > 0
        np.testing.assert_allclose(aux, float(want_aux), **AUX_TOL)


def _dense_grads(cfg, params, ids):
    fwd = j_forward_fn(cfg)

    def loss(p):
        logits, _ = fwd(p, jnp.asarray(ids))
        return jnp.mean(jnp.tanh(logits[..., :64]))

    g = jax.grad(loss)(params)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]}


_COL = ("wq", "wk", "wv", "w_gate", "w_up")


def _check_grads(out, want, stages, tp):
    """Every rank's gradient shard against its slice of the dense one: its
    stage's layers, and under tp its columns (QKV, gate / up) or rows
    (wo, down) or heads (QKV biases)."""
    for _, _, (st, m), grads in out:
        for k, g in grads.items():
            w = want[k]
            if k.startswith("blocks/"):
                n = w.shape[0] // stages
                w = w[st * n:(st + 1) * n]
                leaf = k.split("/")[1]
                dim = 2 if leaf in _COL else 1 if leaf in ("wo", "w_down", "bq", "bk", "bv") else None
                if tp > 1 and dim is not None:
                    c = w.shape[dim] // tp
                    w = np.take(w, np.arange(m * c, (m + 1) * c), axis=dim)
            np.testing.assert_allclose(g, w, err_msg=k, **GRAD_TOL)


def test_pp_gradients_match_dense(pools):
    """The explicit reverse schedule: every layer's gradient on its stage,
    the embedding's, final norm's and head's on every stage, equal the
    dense forward's."""
    cfg, params, ids, out = _run(pools, "llada-tiny", 4, 2, grad=True)
    _check_grads(out, _dense_grads(cfg, params, ids), 4, 1)


@pytest.mark.parametrize("name,stages,tp,data", [
    ("llada-tiny", 2, 2, 1),    # plain GQA dense
    ("llada-tiny", 1, 4, 1),    # tp 4: one head a model rank
    ("dream-tiny", 2, 1, 2),    # attention bias, shifted logits, dp x pp
    ("dream-tiny", 2, 2, 1),    # attention_bias + qk_norm param slicing
])
def test_pp_tp_logits_match_dense(pools, name, stages, tp, data):
    cfg, params, ids, out = _run(pools, name, stages, 2, dp=data, tp=tp)
    want = _dense(cfg, params, ids)
    for logits, _, _, _ in out:
        np.testing.assert_allclose(logits, want, **LOGITS_TOL)
        assert (np.argmax(logits, -1) == np.argmax(want, -1)).all()


def test_pp_tp_gradients_match_dense(pools):
    """The reverse schedule through the TP collectives: column / row shards
    receive exactly their slice of the dense gradient."""
    cfg, params, ids, out = _run(pools, "llada-tiny", 2, 2, tp=2, grad=True)
    _check_grads(out, _dense_grads(cfg, params, ids), 2, 2)


@pytest.mark.parametrize("name,tp", [
    ("llada-tiny", 1), ("llada-tiny", 2), ("llada-moe-tiny", 1)])
def test_pp_masked_batch_matches_dense(pools, name, tp):
    """Left-padded prompts: each stage takes the RoPE tables and the mask
    of the microbatch it holds that tick."""
    mask = np.ones((4, 32), np.int32)
    mask[0, :7] = 0
    mask[2, :3] = 0
    cfg, params, ids, out = _run(pools, name, 2, 2, tp=tp, mask=mask)
    want = _dense(cfg, params, ids, mask)
    for logits, _, _, _ in out:
        np.testing.assert_allclose(logits, want, **LOGITS_TOL)


def _fake_mesh(stages, model=1):
    """A mesh of the given shape for the checks that run before any
    collective."""
    return Mesh(1, model, 0, None, None, "gloo", torch.device("cpu"), stage=stages)


def test_pp_tp_validates():
    cfg = t_get_config("llada-moe-tiny", dtype="float32").replace(num_layers=4)
    with pytest.raises(ValueError, match="dense blocks only"):
        make_pp_forward(cfg, _fake_mesh(2, 2), num_microbatches=2)
    bad = t_get_config("llada-tiny", dtype="float32").replace(
        num_layers=4, num_heads=3, num_kv_heads=3)
    with pytest.raises(ValueError, match="must divide"):
        make_pp_forward(bad, _fake_mesh(2, 2), num_microbatches=2)


def test_pp_validates_divisibility():
    cfg = t_get_config("llada-tiny", dtype="float32").replace(num_layers=4)
    with pytest.raises(ValueError, match="num_layers=3"):
        make_pp_forward(cfg.replace(num_layers=3), _fake_mesh(4), num_microbatches=2)
    pp = make_pp_forward(cfg, _fake_mesh(4), num_microbatches=3)
    params = t_init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="must divide by microbatches=3"):
        pp(params, torch.zeros((4, 32), dtype=torch.long))   # 4 % 3 != 0
