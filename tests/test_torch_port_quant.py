"""int8 weight-only serving in the port against the JAX package, on the CPU.

Inputs come from numpy seeds or from the JAX ``init_params`` (bridged to
torch); the JAX grouped kernels run in interpret mode and the port's kernels
take their plain versions on CPU tensors.  Everything is f32 apart from the
int8 ``q``.  Tolerances, stated per check:

- ``quantize_tensor``: bit for bit (the same f32 reciprocal product and
  division, round half to even).
- ``Q_TOL``: one f32 product ``(x @ q) * s`` in different summation orders
  (the reference's ``qdot`` casts q to bf16, exact for |q| <= 127): 1e-5.
- ``GROUPED_TOL``: the grouped FFN, two products and a SiLU in f32, as
  ``tests/test_torch_port_ops.py``: 1e-4 relative, 1e-5 absolute.
- ``LOGITS_TOL``: a 2-layer forward.  The JAX forward on the CPU runs its
  experts dense on dequantized weights, ``x @ (q * s)``, where the port's
  int8 path computes ``(x @ q) * s``: the same function, whose f32 rounding
  differs by about one f32 ulp per product; two layers of norms and
  residual sums keep that below 2e-4 of the logits (as
  ``tests/test_torch_port_model.py``).
- Greedy decoding: equal tokens.
"""

import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.io import checkpoint as jck
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_make_fwd
from ct_diffusionmodelbench_tpu.models import moe as jmoe
from ct_diffusionmodelbench_tpu.ops import grouped_gemm_pallas as jgg
from ct_diffusionmodelbench_tpu.ops import quant as jq
from ct_diffusionmodelbench_tpu_torch import quantize_ckpt
from ct_diffusionmodelbench_tpu_torch.io import checkpoint as tck
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.io.safetensors_io import save_safetensors
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import init_params as t_init
from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn as t_make_fwd
from ct_diffusionmodelbench_tpu_torch.models import moe as tmoe
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as tgg
from ct_diffusionmodelbench_tpu_torch.ops import quant as tq
from tests.torch_port_threads import one_torch_thread  # noqa: F401

Q_TOL = dict(rtol=1e-5, atol=1e-5)
GROUPED_TOL = dict(rtol=1e-4, atol=1e-5)
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
ALIGNED = dict(hidden_size=128, moe_intermediate_size=128, head_dim=32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


def _assert_trees_equal(got, want):
    """Same nesting, same leaves bit for bit (torch ``got``, numpy ``want``)."""
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w)
        elif w.dtype.name == "bfloat16":
            assert got[k].dtype == torch.bfloat16, k
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=k)
        else:
            g = got[k]
            assert g.dtype == torch.from_numpy(np.zeros(0, w.dtype)).dtype, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48), (2, 4, 128, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_bit_equal_to_jax(shape, dtype):
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32) * 0.3
    w[..., 0, 5] = 0.0                      # a column's absmax from one value
    if len(shape) > 2:
        w[..., 7] = 0.0                     # an all-zero column: the 1e-12 floor
    wj = jnp.asarray(w, dtype)
    want = jq.quantize_tensor(wj)
    got = tq.quantize_tensor(_bridge({"w": wj})["w"])
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(
        tq.dequantize_tensor(got, torch.float32).numpy(),
        np.asarray(jq.dequantize_tensor(want, jnp.float32)))
    assert tq.is_quantized(got) and not tq.is_quantized(got["q"])


def test_qdot_int8_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = jq.quantize_tensor(jnp.asarray(rng.standard_normal((64, 32)) * 0.1, jnp.float32))
    want = jq.qdot(jnp.asarray(x), w)
    got = tq.qdot(_t(x), _bridge(w))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **Q_TOL)


def test_quantize_params_and_leaf_transform_match_jax():
    """The same leaves are quantized, bit for bit, whether after the init or
    as each leaf is built."""
    cfg_j = j_get_config("llada-moe-tiny", dtype="float32")
    params_j = j_init(cfg_j, jax.random.key(5))
    want = _np_tree(jq.quantize_params(params_j))
    _assert_trees_equal(tq.quantize_params(_bridge(params_j)), want)
    want_dense = _np_tree(jq.quantize_params(params_j, experts=False))
    _assert_trees_equal(tq.quantize_params(_bridge(params_j), experts=False),
                        want_dense)
    cfg_t = t_get_config("llada-moe-tiny", dtype="float32")
    built = t_init(cfg_t, seed=2, device="cpu",
                   leaf_transform=tq.quantized_leaf_transform)
    after = tq.quantize_params(t_init(cfg_t, seed=2, device="cpu"))
    for k in ("wq", "wo", "we_gate", "ws_down"):
        assert tq.is_quantized(built["blocks"][k]), k
        assert torch.equal(built["blocks"][k]["q"], after["blocks"][k]["q"])
    assert not tq.is_quantized(built["blocks"]["router"])
    assert not tq.is_quantized(built["embed"]) and tq.is_quantized(built["lm_head"])


def test_bridge_carries_quantized_tree_bit_for_bit():
    cfg_j = j_get_config("llada-moe-tiny", dtype="bfloat16")
    qparams = j_init(cfg_j, jax.random.key(3), leaf_transform=jq.quantized_leaf_transform)
    tree = _np_tree(qparams)
    got = params_from_numpy(tree, device="cpu")
    assert got["blocks"]["we_gate"]["q"].dtype == torch.int8
    assert got["embed"].dtype == torch.bfloat16
    _assert_trees_equal(got, tree)


# ---------------------------------------------------------------------------
# grouped int8 kernels (plain versions) and the MoE block
# ---------------------------------------------------------------------------

def _moe_inputs(seed, n, k, e, d, f, layers=None):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    x = (rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    logits = rng.standard_normal((n, k))
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    idx = rng.integers(0, e, (n, k)).astype(np.int32)
    ws = [jq.quantize_tensor(jnp.asarray(rng.standard_normal(lead + shape) * 0.05,
                                         jnp.float32))
          for shape in ((e, d, f), (e, d, f), (e, f, d))]
    return x, probs, idx, ws


@pytest.mark.parametrize("layers", [None, 2])
def test_int8_grouped_kernels_plain_match_jax(layers):
    """The plain versions of K6/K7 against JAX's manual int8 kernels on the
    same padded rows (interpret mode)."""
    x, probs, idx, (qg, qu, qd) = _moe_inputs(3, 48, 2, 4, 128, 128, layers)
    li = None if layers is None else 1
    jli = None if li is None else jnp.int32(li)
    n, k = idx.shape
    tile = 16
    dest_t, te_t, _, m_pad = tgg.counting_layout(_t(idx), 4, tile)
    xs_t = tgg.gather_rows(_t(x), dest_t, k, m_pad)
    xs_j, te_j = jnp.asarray(xs_t.numpy()), jnp.asarray(te_t.numpy())
    h_t = tgg.grouped_gateup_q(xs_t, _bridge(qg), _bridge(qu), te_t, tile, li)
    h_j = jgg.grouped_gateup_manual_q(xs_j, qg, qu, te_j, tile, layer_index=jli)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **GROUPED_TOL)
    o_t = tgg.grouped_down_q(h_t, _bridge(qd), te_t, tile, li)
    o_j = jgg.grouped_matmul_manual_q(jnp.asarray(h_t.numpy()), qd, te_j, tile,
                                      layer_index=jli)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **GROUPED_TOL)


@pytest.mark.parametrize("layers", [None, 2])
def test_int8_grouped_expert_ffn_matches_jax(layers):
    """``grouped_expert_ffn_cuda`` with quantized dicts (CPU plain path)
    against JAX's ``grouped_expert_ffn_pallas`` in interpret mode, flat and
    layer-stacked (``tests/test_quant.py``'s shapes)."""
    x, probs, idx, ws = _moe_inputs(0, 48, 2, 4, 128, 128, layers)
    li = None if layers is None else 1
    want = jgg.grouped_expert_ffn_pallas(
        jnp.asarray(x), jnp.asarray(probs), jnp.asarray(idx), *ws,
        layer_index=None if li is None else jnp.int32(li))
    got = tgg.grouped_expert_ffn_cuda(_t(x), _t(probs), _t(idx),
                                      *[_bridge(w) for w in ws], layer_index=li)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GROUPED_TOL)


def _reference_tile_valid(sizes, tile_expert, tile_m, m_pad):
    """``tile_valid`` as ``grouped_expert_ffn_pallas`` builds it under
    ``CTDB_GROUPED_SKIP_PAD=1``."""
    padded = jgg._round_up_arr(sizes, tile_m)
    pend_real = jnp.cumsum(padded) - padded + sizes
    tile_start = jnp.arange(m_pad // tile_m, dtype=jnp.int32) * tile_m
    return (tile_start < jnp.take(pend_real, tile_expert)).astype(jnp.int32)


@pytest.mark.parametrize("layers,last_empty", [(None, False), (2, True)])
def test_int8_grouped_kernels_plain_pad_skip_match_jax(layers, last_empty):
    """The plain versions of K6/K7 with ``tile_valid`` against JAX's manual
    int8 kernels with it (interpret mode).  The reference zero-fills a tile
    marked 0 unless it starts an expert run: that one it still multiplies,
    to keep its weight-DMA semaphores balanced.  No real row lies there, the
    combine reads none of it, and the port zero-fills it too.  With the last
    expert empty, the trailing padding tiles form such a run."""
    x, probs, idx, (qg, qu, qd) = _moe_inputs(3, 48, 2, 4, 128, 128, layers)
    if last_empty:
        idx = np.where(idx == 3, 2, idx)
    li = None if layers is None else 1
    jli = None if li is None else jnp.int32(li)
    n, k = idx.shape
    tile = 16
    dest_t, te_t, sizes_t, m_pad = tgg.counting_layout(_t(idx), 4, tile)
    valid_t = tgg.valid_tiles(sizes_t, te_t, tile, m_pad)
    te_j = jnp.asarray(te_t.numpy())
    valid_j = _reference_tile_valid(jnp.asarray(sizes_t.numpy()), te_j, tile, m_pad)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert int((valid_t == 0).sum()) > 0
    starts = np.r_[True, te_t.numpy()[1:] != te_t.numpy()[:-1]]
    skipped = (valid_t.numpy() == 0) & ~starts          # the reference's zero tiles
    run_start = (valid_t.numpy() == 0) & starts
    assert run_start.any() == last_empty
    rows = lambda m: np.repeat(m, tile)                  # noqa: E731
    xs_t = tgg.gather_rows(_t(x), dest_t, k, m_pad)
    xs_j = jnp.asarray(xs_t.numpy())

    def check(got, want):
        got, want = got.numpy(), np.asarray(want)
        real = rows(valid_t.numpy() == 1)
        np.testing.assert_allclose(got[real], want[real], **GROUPED_TOL)
        assert not got[~real].any() and not want[rows(skipped)].any()
        return want[rows(run_start)]

    h_t = tgg.grouped_gateup_q(xs_t, _bridge(qg), _bridge(qu), te_t, tile, li, valid_t)
    h_run_start = check(h_t, jgg.grouped_gateup_manual_q(
        xs_j, qg, qu, te_j, tile, layer_index=jli, tile_valid=valid_j))
    assert h_run_start.any() == last_empty              # multiplied there
    o_t = tgg.grouped_down_q(h_t, _bridge(qd), te_t, tile, li, valid_t)
    check(o_t, jgg.grouped_matmul_manual_q(jnp.asarray(h_t.numpy()), qd, te_j, tile,
                                           layer_index=jli, tile_valid=valid_j))


@pytest.mark.parametrize("layers", [None, 2])
def test_int8_grouped_expert_ffn_skip_pad_matches_jax(monkeypatch, layers):
    """``grouped_expert_ffn_cuda`` hands both int8 kernels the reference's
    ``tile_valid`` on every call; its output matches
    ``grouped_expert_ffn_pallas`` with ``CTDB_GROUPED_SKIP_PAD=1`` and
    without it."""
    x, probs, idx, ws = _moe_inputs(0, 48, 2, 4, 128, 128, layers)
    li = None if layers is None else 1
    seen = []

    def recording(kernel):
        def run(*args):
            seen.append(args[-1])
            return kernel(*args)
        return run

    monkeypatch.setattr(tgg, "grouped_gateup_q", recording(tgg.grouped_gateup_q))
    monkeypatch.setattr(tgg, "grouped_down_q", recording(tgg.grouped_down_q))
    got = tgg.grouped_expert_ffn_cuda(_t(x), _t(probs), _t(idx),
                                      *[_bridge(w) for w in ws], layer_index=li)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert bool((seen[0] == 0).any())
    for skip in ("0", "1"):
        monkeypatch.setenv("CTDB_GROUPED_SKIP_PAD", skip)
        want = jgg.grouped_expert_ffn_pallas(
            jnp.asarray(x), jnp.asarray(probs), jnp.asarray(idx), *ws,
            layer_index=None if li is None else jnp.int32(li))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GROUPED_TOL)


def test_int8_grouped_expert_ffn_refuses_unaligned():
    x, probs, idx, ws = _moe_inputs(1, 8, 2, 4, 64, 32)
    with pytest.raises(ValueError, match="% 128"):
        tgg.grouped_expert_ffn_cuda(_t(x), _t(probs), _t(idx),
                                    *[_bridge(w) for w in ws])


@pytest.mark.parametrize("d,f,layers,int8_path", [
    (128, 128, None, True), (128, 128, 2, True), (64, 32, 2, False)])
def test_moe_block_int8_matches_jax(monkeypatch, d, f, layers, int8_path):
    """Aligned experts go to the int8 grouped pair; unaligned ones are
    dequantized and take the plain-weight pair, in both packages."""
    monkeypatch.setenv("CTDB_GROUPED_GEMM", "pallas")
    rng = np.random.default_rng(d + f)
    lead = () if layers is None else (layers,)

    def w(shape, fan):
        return jnp.asarray(rng.standard_normal(shape) / math.sqrt(fan), jnp.float32)

    e = 8
    p = {"router": w((d, e), d),
         "we_gate": jq.quantize_tensor(w(lead + (e, d, f), d)),
         "we_up": jq.quantize_tensor(w(lead + (e, d, f), d)),
         "we_down": jq.quantize_tensor(w(lead + (e, f, d), f)),
         "ws_gate": jq.quantize_tensor(w((d, f), d)),
         "ws_up": jq.quantize_tensor(w((d, f), d)),
         "ws_down": jq.quantize_tensor(w((f, d), f))}
    x = rng.standard_normal((24, d)).astype(np.float32)
    li = None if layers is None else 1
    want, aux_j = jmoe.moe_block(jnp.asarray(x), p, top_k=2, norm_topk=True,
                                 impl="grouped",
                                 layer_index=None if li is None else jnp.int32(li))
    calls = []
    real = tgg.grouped_gateup_q
    monkeypatch.setattr(tgg, "grouped_gateup_q",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got, aux_t = tmoe.moe_block(_t(x), _bridge(p), top_k=2, norm_topk=True,
                                layer_index=li)
    assert bool(calls) == int8_path
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GROUPED_TOL)
    np.testing.assert_allclose(aux_t.numpy(), np.asarray(aux_j), **GROUPED_TOL)
    dense, _ = tmoe.moe_block(_t(x), _bridge(p), top_k=2, norm_topk=True,
                              impl="dense", layer_index=li)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), **GROUPED_TOL)


# ---------------------------------------------------------------------------
# the int8 forward
# ---------------------------------------------------------------------------

def _qpair(name, seed, **overrides):
    cfg_j = j_get_config(name, dtype="float32", **overrides)
    cfg_t = t_get_config(name, dtype="float32", **overrides)
    qparams = jq.quantize_params(j_init(cfg_j, jax.random.key(seed)))
    return cfg_j, qparams, cfg_t, _bridge(qparams)


@pytest.mark.parametrize("name,over", [("llada-moe-tiny", ALIGNED),
                                       ("llada-moe-tiny", {}),
                                       ("llada-tiny", {})])
def test_int8_forward_matches_jax(name, over):
    cfg_j, qj, cfg_t, qt = _qpair(name, 4, **over)
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 480, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.int32)
    mask[1, :3] = 0
    want, aux_j = j_make_fwd(cfg_j)(qj, jnp.asarray(ids), jnp.asarray(mask),
                                    jnp.int32(8), 16)
    got, aux_t = t_make_fwd(cfg_t, device="cpu")(qt, _t(ids), _t(mask),
                                                 logit_start=8, logit_length=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **LOGITS_TOL)


# ---------------------------------------------------------------------------
# checkpoints and the quantize tool
# ---------------------------------------------------------------------------

def test_int8_checkpoint_round_trip_and_jax_interop(tmp_path):
    cfg_j, qj, cfg_t, qt = _qpair("llada-moe-tiny", 8)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    tck.save_quantized_checkpoint(port_dir, cfg_t, qt, max_shard_size=1 << 16)
    assert (port_dir / tck.WEIGHTS_INDEX).exists()       # sharded
    assert tck.is_quantized_checkpoint(port_dir) and jck.is_quantized_checkpoint(port_dir)
    cfg2, back = tck.load_quantized_checkpoint(port_dir, device="cpu")
    assert cfg2.is_moe and cfg2.num_layers == cfg_t.num_layers
    _assert_trees_equal(back, _np_tree(qj))
    _, j_back = jck.load_quantized_checkpoint(port_dir)    # JAX reads the port's
    _assert_trees_equal(qt, _np_tree(j_back))
    jck.save_quantized_checkpoint(jax_dir, cfg_j, qj)      # the port reads JAX's
    _, t_back = tck.load_quantized_checkpoint(jax_dir, device="cpu")
    _assert_trees_equal(t_back, _np_tree(qj))
    assert not tck.is_quantized_checkpoint(tmp_path)


@pytest.mark.parametrize("name,dtype", [("llada-moe-tiny", "float32"),
                                        ("llada-tiny", "bfloat16")])
def test_load_checkpoint_reads_jax_hf_dir(tmp_path, name, dtype):
    cfg_j = j_get_config(name, dtype=dtype)
    params_j = j_init(cfg_j, jax.random.key(9))
    jck.save_checkpoint(tmp_path, cfg_j, params_j, max_shard_size=1 << 16)
    cfg_t, got = tck.load_checkpoint(tmp_path, device="cpu", dtype=dtype)
    cfg_w, want = jck.load_checkpoint(tmp_path, dtype=dtype)
    assert cfg_t.dtype == cfg_w.dtype == dtype
    assert cfg_t.num_layers == cfg_j.num_layers and cfg_t.is_moe == cfg_j.is_moe
    _assert_trees_equal(got, _np_tree(want))
    _assert_trees_equal(got, _np_tree(params_j))
    # config.json names no dtype the loaders read: both default to bf16
    cfg_d, got_d = tck.load_checkpoint(tmp_path, device="cpu")
    assert cfg_d.dtype == jck.load_checkpoint(tmp_path)[0].dtype == "bfloat16"
    assert got_d["embed"].dtype == torch.bfloat16


def test_load_checkpoint_aliases_and_stacked_experts(tmp_path):
    """OLMo/LLaDA-style attention names and per-layer stacked [E, out, in]
    (gate, down) or fused [E·out, in] (up) expert tensors load to the same
    tree as the canonical per-expert layout."""
    cfg_j = j_get_config("llada-moe-tiny", dtype="float32")
    params_j = j_init(cfg_j, jax.random.key(10))
    flat = {k: torch.from_numpy(np.array(v))
            for k, v in jck.flatten_to_hf(cfg_j, params_j).items()}
    e = cfg_j.num_experts
    out = {}
    for name, t in flat.items():
        if ".mlp.experts." in name:
            continue
        name = name.replace("model.layers.", "model.transformer.blocks.") \
            if ".self_attn.q_proj" in name or ".self_attn.o_proj" in name else name
        name = name.replace("self_attn.o_proj", "attn_out").replace(
            "self_attn.q_proj", "q_proj")
        out[name] = t
    for i in range(cfg_j.num_layers):
        for proj in ("gate_proj", "up_proj", "down_proj"):
            st = torch.stack([flat[f"model.layers.{i}.mlp.experts.{x}.{proj}.weight"]
                              for x in range(e)])
            if proj == "up_proj":
                out[f"model.layers.{i}.mlp.experts.up_proj"] = st.reshape(-1, st.shape[-1])
            else:
                out[f"model.layers.{i}.mlp.experts.{proj}.weight"] = st
    save_safetensors(tmp_path / "model.safetensors", out)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(jck._hf_config_dict(cfg_j), f)
    _, got = tck.load_checkpoint(tmp_path, dtype="float32", device="cpu")
    _, want = jck.load_checkpoint(tmp_path, dtype="float32")
    _assert_trees_equal(got, _np_tree(want))
    _assert_trees_equal(got, _np_tree(params_j))


def test_quantize_ckpt_tool(tmp_path):
    cfg_j = j_get_config("llada-moe-tiny", dtype="float32")
    params_j = j_init(cfg_j, jax.random.key(11))
    src, dst = tmp_path / "bf16", tmp_path / "int8"
    jck.save_checkpoint(src, cfg_j, params_j)
    (src / "tokenizer_config.json").write_text("{}")
    (src / "special_tokens_map.json").write_text("{}")
    assert quantize_ckpt.main(["--in", str(src), "--out", str(dst),
                               "--device", "cpu"]) == 0
    assert tck.is_quantized_checkpoint(dst)
    assert (dst / "tokenizer_config.json").exists()
    assert (dst / "special_tokens_map.json").exists()
    _, want = jck.load_checkpoint(src)
    _, got = tck.load_quantized_checkpoint(dst, device="cpu")
    _assert_trees_equal(got, _np_tree(jq.quantize_params(want)))
    shutil.rmtree(src)
