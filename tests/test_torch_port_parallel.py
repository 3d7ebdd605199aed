"""The port's tensor- and data-parallel serving against the JAX package's
sharded path, on the CPU.

Four ``gloo`` ranks (``tests/torch_port_dist.py``, one group for the
module) run only the port; this process computes the JAX side: its
``make_sharded_forward`` / runner on the same dp×tp mesh over the virtual
CPU devices, and its unsharded forward, on the same weights (JAX
``init_params``, handed to the ranks as numpy and sliced there).  The JAX
cases at tp 8 run at tp 4 here (four ranks); llada-moe-tiny and dream-tiny,
whose 2 kv heads do not divide 4, take the replicated-attention fallback.
Tolerances are the reference's own: f32 logits rtol = atol = 2e-4, aux
rtol 1e-4 / atol 1e-5, attention 2e-5; tokens and text exact.
"""

import json

import jax
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu import parallel as jpar
from ct_diffusionmodelbench_tpu.eval.runner import ModelRunner as JRunner
from ct_diffusionmodelbench_tpu.io import tokenizer as jtok
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_forward_fn
from ct_diffusionmodelbench_tpu.ops.attention import attention_reference as j_attn
from ct_diffusionmodelbench_tpu.sampling import llada_generate as j_llada
from ct_diffusionmodelbench_tpu_torch import parallel as tpar
from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.io import tokenizer as ttok
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import init_params as t_init
from ct_diffusionmodelbench_tpu_torch.parallel.sharding import local_specs
from tests.torch_port_dist import RankPool
from tests.torch_port_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
AUX_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _weights(preset, seed):
    cfg = j_get_config(preset, dtype="float32")
    params = j_init(cfg, jax.random.key(seed))
    return cfg, params, _np_tree(params)


def _model_dim(spec):
    return next((i for i, a in enumerate(spec) if a == "model"), None)


def test_mesh_shapes(pool):
    info = pool.run("rank_info", 2, 2)
    assert [i["shape"] for i in info] == [{"data": 2, "model": 2}] * 4
    assert [(i["data_rank"], i["model_rank"]) for i in info] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]          # model innermost, as jax.make_mesh
    assert {i["backend"] for i in info} == {"gloo"}
    assert pool.run("rank_info", 1, None)[3]["shape"] == {"data": 1, "model": 4}
    kind, msg = pool.run("mesh_error", 3, None)[0]
    assert kind == "ValueError"
    kind, msg = pool.run("mesh_error", 1, 1, seq=2)[0]
    assert kind == "ValueError" and "needs WORLD_SIZE 2, have 4" in msg
    # The seq axis sits between data and model, as jax.make_mesh lays out
    # (data, seq, model): rank = seq_rank * model + model_rank; each seq
    # group holds the ranks of one model coordinate, in seq order.
    info = pool.run("rank_info", 1, 2, seq=2)
    assert [i["shape"] for i in info] == [{"data": 1, "seq": 2, "model": 2}] * 4
    assert [(i["seq_rank"], i["model_rank"]) for i in info] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert [i["mid_group"] for i in info] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    info = pool.run("rank_info", 2, None, seq=2)
    assert [(i["data_rank"], i["seq_rank"]) for i in info] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert info[0]["shape"] == {"data": 2, "seq": 2, "model": 1}
    info = pool.run("rank_info", 2, 1, stages=2)
    assert [(i["data_rank"], i["stage_rank"]) for i in info] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [i["mid_group"] for i in info] == [[0, 1], [0, 1], [2, 3], [2, 3]]


@pytest.mark.parametrize("preset", ["llada-tiny", "llada-moe-tiny"])
def test_param_specs_cover_tree(preset):
    """The port's spec tree has the params' structure, and each leaf names
    the dimension the reference's PartitionSpec puts on 'model'."""
    cfg_t = t_get_config(preset, dtype="float32")
    params = t_init(cfg_t, seed=0, device="cpu")
    specs = tpar.param_specs(cfg_t)
    j_specs = jpar.param_specs(j_get_config(preset, dtype="float32"))
    assert specs.keys() == params.keys() == j_specs.keys()
    assert specs["blocks"].keys() == params["blocks"].keys() == j_specs["blocks"].keys()
    for k, v in specs["blocks"].items():
        assert v == _model_dim(j_specs["blocks"][k]), k
    for k in ("embed", "final_norm", "lm_head"):
        assert specs[k] == _model_dim(j_specs[k]), k
    assert tpar.data_spec() == tuple(jpar.data_spec())
    # tp 4: the 2 kv heads of the MoE preset do not divide, so attention
    # stays whole; its experts, shared expert and vocab split.
    eff = local_specs(cfg_t, 4)["blocks"]
    assert eff["wq"] == (2 if preset == "llada-tiny" else None)
    assert eff.get("we_gate", 1) == 1 and local_specs(cfg_t, 4)["embed"] == 0


FORWARD_CASES = [(p, dp, tp) for p in ("llada-tiny", "llada-moe-tiny", "dream-tiny")
                 for dp, tp in ((2, 2), (1, 4))]


@pytest.mark.parametrize("preset,dp,tp", FORWARD_CASES)
def test_sharded_forward_matches_single_device(pool, preset, dp, tp):
    """The port's dp×tp logits equal the JAX package's sharded forward on the
    same mesh shape and its single-device forward (reference attention)."""
    cfg, params, params_np = _weights(preset, 0)
    ids = np.asarray(jax.random.randint(jax.random.key(1), (4, 16), 3,
                                        cfg.vocab_size - 2))
    ref, aux_ref = j_forward_fn(cfg.replace(attn_impl="reference"))(params, ids)
    mesh = jpar.make_mesh(data=dp, model=tp)
    j_out, j_aux = jpar.make_sharded_forward(cfg, mesh)(
        jpar.shard_params(cfg, params, mesh), ids)
    for logits, aux, _ in pool.run("sharded_forward", preset, params_np, ids, dp, tp):
        np.testing.assert_allclose(logits, np.asarray(ref), **LOGITS_TOL)
        np.testing.assert_allclose(logits, np.asarray(j_out), **LOGITS_TOL)
        np.testing.assert_allclose(aux, float(aux_ref), **AUX_TOL)
        np.testing.assert_allclose(aux, float(j_aux), **AUX_TOL)


def test_sharded_params_are_distributed(pool):
    """Column-parallel wq: each model rank holds 1/tp of its last dim."""
    _, _, params_np = _weights("llada-tiny", 0)
    ids = np.full((4, 8), 7)
    full = params_np["blocks"]["wq"].shape
    for dp, tp in ((2, 2), (1, 4)):
        shapes = {r[2] for r in pool.run("sharded_forward", "llada-tiny", params_np,
                                         ids, dp, tp)}
        assert shapes == {full[:-1] + (full[-1] // tp,)}


def test_tail_batch_under_dp_mesh(pool):
    """A batch that does not divide by dp replicates over 'data' (TP stays
    on) and still matches the single-device forward."""
    cfg, params, params_np = _weights("llada-tiny", 0)
    ids = np.asarray(jax.random.randint(jax.random.key(7), (3, 16), 3,
                                        cfg.vocab_size - 2))
    ref, _ = j_forward_fn(cfg.replace(attn_impl="reference"))(params, ids)
    for logits, _, _ in pool.run("sharded_forward", "llada-tiny", params_np, ids, 2, 2):
        np.testing.assert_allclose(logits, np.asarray(ref), **LOGITS_TOL)


def test_sharded_sampler_end_to_end(pool):
    """The block sampler over the sharded forward decodes what the JAX
    single-device sampler decodes, token for token."""
    cfg, params, params_np = _weights("llada-tiny", 0)
    prompts = np.asarray(jax.random.randint(jax.random.key(2), (4, 8), 3,
                                            cfg.vocab_size - 2))
    kw = dict(steps=8, gen_length=8, block_length=4)
    want = np.asarray(j_llada(j_forward_fn(cfg.replace(attn_impl="reference")),
                              params, prompts, mask_id=cfg.mask_token_id, **kw))
    for got in pool.run("sharded_generate", "llada-tiny", params_np, prompts, 2, 2, **kw):
        np.testing.assert_array_equal(got, want)


# -- attention (tests/test_sharded_attention.py) ------------------------------

def _qkv(h, kv):
    ks = jax.random.split(jax.random.key(0), 3)
    return tuple(np.asarray(jax.random.normal(k, (2, 96, n, 32)))
                 for k, n in zip(ks, (h, kv, kv)))


def _assemble(pieces, dp, tp, split_heads):
    rows = [np.concatenate(pieces[d * tp:(d + 1) * tp], axis=2) if split_heads
            else pieces[d * tp] for d in range(dp)]
    return np.concatenate(rows, axis=0)


def test_sharded_flash_matches_reference(pool):
    """The flash path under the mesh (its plain version here) on each
    rank's rows and heads, assembled, equals the reference attention."""
    q, k, v = _qkv(8, 4)
    mask = np.ones((2, 96), np.int32)
    mask[0, :10] = 0
    want = np.asarray(j_attn(q, k, v, mask))
    got = _assemble(pool.run("attention_piece", q, k, v, mask, 2, 2, True), 2, 2, True)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_indivisible_heads_fall_back(pool):
    """kv = 2 does not divide tp 4: every rank holds all heads, and the
    flash path runs them whole."""
    q, k, v = _qkv(8, 2)
    mask = np.ones((2, 96), np.int32)
    want = np.asarray(j_attn(q, k, v, None))
    pieces = pool.run("attention_piece", q, k, v, mask, 1, 4, False)
    for piece in pieces:
        np.testing.assert_allclose(piece, want, rtol=2e-5, atol=2e-5)


def test_sharded_forward_flash_matches_reference_forward(pool):
    """The whole forward with the flash path forced, over the mesh, equals
    the single-device reference forward."""
    cfg, params, params_np = _weights("llada-tiny", 0)
    ids = np.asarray(jax.random.randint(jax.random.key(1), (2, 24), 3,
                                        cfg.vocab_size - 2))
    ref, _ = j_forward_fn(cfg.replace(attn_impl="reference"))(params, ids)
    for logits, _, _ in pool.run("sharded_forward", "llada-tiny", params_np, ids, 2, 2,
                                 attn_impl="flash"):
        np.testing.assert_allclose(logits, np.asarray(ref), **LOGITS_TOL)


# -- runner and CLIs (tests/test_runner_sharded.py) ----------------------------

GEN = dict(gen_length=8, steps=4, block_length=4)


def _runners(preset, seed):
    """(JAX runner, the port's unsharded runner, the weights as numpy)."""
    cfg_j, params_j, params_np = _weights(preset, seed)
    cfg_t = t_get_config(preset, dtype="float32")
    tok_j = jtok.Tokenizer.byte_fallback(vocab_size=cfg_j.vocab_size, eos_token_id=2)
    tok_t = ttok.Tokenizer.byte_fallback(vocab_size=cfg_t.vocab_size, eos_token_id=2)
    return (JRunner(cfg_j, params_j, tok_j),
            ModelRunner(cfg_t, params_from_numpy(params_np, device="cpu"), tok_t,
                        device="cpu"),
            params_np)


def _check_single(pool, preset, seed, text, dp, tp, **kw):
    jr, tr, params_np = _runners(preset, seed)
    want, plain = jr.generate(text, **kw), tr.generate(text, **kw)
    np.testing.assert_array_equal(plain.token_ids, want.token_ids)
    for ids, txt in (r[0] for r in pool.run("runner_generate", preset, params_np,
                                            dp, tp, texts=text, **kw)):
        np.testing.assert_array_equal(ids, want.token_ids)
        assert txt == want.text == plain.text


def test_runner_tp_generate_token_identical(pool):
    _check_single(pool, "llada-tiny", 7, "prove n + 0 = n", 1, 4,
                  gen_length=16, steps=8, block_length=8)


def test_runner_dp_tp_generate_batch_token_identical(pool):
    """Rows split over 'data' (2 each), gathered back on every rank."""
    jr, tr, params_np = _runners("llada-tiny", 8)
    prompts = ["theorem a", "lemma two plus two", "prove x", "def y"]
    want = jr.generate_batch(prompts, **GEN)
    plain = tr.generate_batch(prompts, **GEN)
    for res in pool.run("runner_generate", "llada-tiny", params_np, 2, 2,
                        texts=prompts, **GEN):
        for (ids, txt), w, p in zip(res, want, plain):
            np.testing.assert_array_equal(ids, w.token_ids)
            np.testing.assert_array_equal(p.token_ids, w.token_ids)
            assert txt == w.text == p.text


def test_runner_tp_moe_generate(pool):
    """Expert parallelism (2 of 8 experts a rank) through the runner."""
    _check_single(pool, "llada-moe-tiny", 9, "prove n + 0 = n", 1, 4, **GEN)


def test_runner_tp_dream_generate(pool):
    _check_single(pool, "dream-tiny", 10, "write code", 1, 4, gen_length=8,
                  steps=4, temperature=0.0, alg="entropy")


def test_runner_dp_single_prompt_generate(pool):
    """Batches that do not divide by dp (one prompt, three) run whole on
    every rank."""
    _check_single(pool, "llada-tiny", 11, "prove 1 + 1 = 2", 2, 2, **GEN)
    jr, _, params_np = _runners("llada-tiny", 11)
    want = jr.generate_batch(["a", "bb", "ccc"], **GEN)
    for res in pool.run("runner_generate", "llada-tiny", params_np, 2, 2,
                        texts=["a", "bb", "ccc"], **GEN):
        assert len(res) == 3
        for (ids, _), w in zip(res, want):
            np.testing.assert_array_equal(ids, w.token_ids)


def test_runner_sampled_draws_follow_the_batch(pool):
    """At T > 0 a data rank's rows draw the noise the one-process run
    draws for them (drawn for the whole batch, then sliced), so sampled
    tokens match the port's unsharded runner."""
    _, tr, params_np = _runners("llada-tiny", 12)
    ids = np.random.default_rng(0).integers(3, 480, (4, 8))
    kw = dict(temperature=1.0, remasking="random", seed=3, **GEN)
    want = tr.generate_ids(ids, **kw)
    for res in pool.run("runner_generate", "llada-tiny", params_np, 2, 2, ids=ids, **kw):
        np.testing.assert_array_equal(np.stack([r[0] for r in res]), want)


CLI_GEN = ["--gen-length", "8", "--steps", "4", "--block-length", "4", "--device", "cpu"]


def test_cli_chat_tp_one_shot(pool, capsys):
    """``cli.chat --tp 4`` on four ranks: rank 0 prints the one-process
    run's answer, the other ranks print nothing."""
    from ct_diffusionmodelbench_tpu_torch.cli import chat

    argv = ["--preset", "llada-tiny", "--prompt", "prove it"] + CLI_GEN
    chat.main(argv)
    want = capsys.readouterr().out.split("Generated continuation:")[1]
    outs = pool.run("cli_main", "chat", argv + ["--tp", "4"])
    assert "Generation Result" in outs[0]
    assert outs[0].split("Generated continuation:")[1] == want
    assert outs[1:] == ["", "", ""]


def test_cli_minif2f_tp(pool, tmp_path):
    """``cli.minif2f --dp 2 --tp 2``: one result file, written by rank 0,
    with the one-process run's generations."""
    from ct_diffusionmodelbench_tpu_torch.cli import minif2f

    problems = [{"name": f"p{i}", "split": "test", "informal_statement": "informal",
                 "formal_statement": f"theorem p{i} : True := by",
                 "header": "import Mathlib\n"} for i in range(2)]
    jp = tmp_path / "minif2f.json"
    jp.write_text(json.dumps(problems))

    def argv(out):
        return ["--preset", "llada-tiny", "--json-path", str(jp), "--output-dir",
                str(tmp_path / out), "--batch-size", "2", "--fake-lean"] + CLI_GEN

    minif2f.main(argv("one"))
    pool.run("cli_main", "minif2f", argv("sharded") + ["--dp", "2", "--tp", "2"])
    got, want = ([json.loads(f.read_text())
                  for f in (tmp_path / d).glob("minif2f_lean4_results_*.json")]
                 for d in ("sharded", "one"))
    assert len(got) == 1 and got[0]["stats"]["total"] == 2
    assert [r["generated_proof"] for r in got[0]["results"]] == \
        [r["generated_proof"] for r in want[0]["results"]]


# -- refusals, launch errors, counts -----------------------------------------

def test_mesh_scope_reaches_other_threads():
    """The active mesh is visible from any thread of the process: on the
    card the autograd engine runs the backward, and the recomputation of
    checkpointed blocks and CE chunks in it, on threads of its own."""
    import threading

    from ct_diffusionmodelbench_tpu_torch.parallel.mesh import Mesh, current_mesh

    mesh = Mesh(2, 2, 0, None, None, "gloo", torch.device("cpu"))
    seen = []
    with tpar.use_mesh(mesh, batch=4):
        t = threading.Thread(target=lambda: seen.append(current_mesh()))
        t.start()
        t.join()
    assert seen == [mesh] and current_mesh() is None


def test_world_size_mismatch_raises(pool, monkeypatch):
    """dp·tp must equal WORLD_SIZE; without a process group the runner and
    trainer say how to launch."""
    kind, msg = pool.run("mesh_error", 1, 2)[0]
    assert kind == "ValueError" and "WORLD_SIZE 2, have 4" in msg and "torchrun" in msg
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        ModelRunner.random_init("llada-tiny", dp=2, tp=2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is 2"):
        ModelRunner.random_init("llada-tiny", tp=4, device="cpu")


def test_nccl_on_a_shared_card_raises(monkeypatch):
    """Two ranks on one card: nccl is refused, asked for or not; gloo is the
    explicit choice there.  nccl on CPU ranks is refused too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    for backend in ("nccl", None):
        with pytest.raises(RuntimeError, match="gloo"):
            tpar.init_distributed("localhost:1", 2, 0, backend=backend)
    with pytest.raises(ValueError, match="only gloo"):
        tpar.init_distributed("localhost:1", 2, 0, backend="nccl", device="cpu")


def test_serving_refusals_under_a_mesh(pool):
    """int8 and the block cache stay single-device, as in the reference."""
    for kw, match in ((dict(quant="int8"), "single-chip alternative"),
                      (dict(accel="block-cache"), "single-chip only")):
        errs = pool.run("runner_error", "llada-tiny", 2, 2, **kw)
        assert all(e[0] == "NotImplementedError" and match in e[1] for e in errs)


def test_collective_counts(pool):
    """One sharded MoE forward at dp2×tp2: per layer one all-reduce after
    the attention and one after the FFN, one for the embedding, one gather
    of the vocab shards and one of the rows over 'data'; the aux loss's
    statistics add two all-reduces a layer over 'data'.  Nothing is staged
    through the host on CPU ranks."""
    cfg, _, params_np = _weights("llada-moe-tiny", 0)
    counts = pool.run("forward_counts", "llada-moe-tiny", params_np, 2, 2)
    layers = cfg.num_layers
    for c in counts:
        assert c == {"all_reduce": 2 * layers + 1 + 2 * layers, "all_gather": 2,
                     "p2p": 0, "host_staged": 0}
