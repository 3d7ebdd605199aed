"""The single-prompt serving path against the JAX package, on the CPU: the
fused expert FFN (K3) and direct flash attention (K9) paths, the chat CLIs
and one end-to-end decode through both opt-in kernels.

On the CPU the port's wrappers take their plain versions; the JAX side runs
its Pallas kernels in interpret mode under the same switches
(``CTDB_GROUPED_FUSED=1``, ``CTDB_FLASH_DIRECT=1``).  Tolerances:
- the fused FFN: rtol 1e-4, atol 1e-5 (``tests/test_grouped_gemm_pallas.py``'s,
  f32 products summed in another order);
- direct flash attention: rtol = atol = 2e-5, 2e-4 with RoPE
  (``tests/test_flash_attention.py``'s), lse 1e-5, gradients 2e-4;
- tokens and chat text: equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_diffusionmodelbench_tpu.cli import chat as jchat
from ct_diffusionmodelbench_tpu.cli import chat_base as jchat_base
from ct_diffusionmodelbench_tpu.eval.runner import ModelRunner as JRunner
from ct_diffusionmodelbench_tpu.io import tokenizer as jtok
from ct_diffusionmodelbench_tpu.models import get_config as j_get_config
from ct_diffusionmodelbench_tpu.models import init_params as j_init_params
from ct_diffusionmodelbench_tpu.models import make_forward_fn as j_make_forward_fn
from ct_diffusionmodelbench_tpu.models import moe as jmoe
from ct_diffusionmodelbench_tpu.models import transformer as jtransformer
from ct_diffusionmodelbench_tpu.models.layers import rope_angles as j_rope_angles
from ct_diffusionmodelbench_tpu.models.moe import router_probs as j_router_probs
from ct_diffusionmodelbench_tpu.ops import flash_attention as jfa
from ct_diffusionmodelbench_tpu.ops import grouped_gemm_pallas as jgg
from ct_diffusionmodelbench_tpu.sampling import llada_generate as j_generate
from ct_diffusionmodelbench_tpu_torch.cli import chat as tchat
from ct_diffusionmodelbench_tpu_torch.cli import chat_base as tchat_base
from ct_diffusionmodelbench_tpu_torch.eval import ModelRunner
from ct_diffusionmodelbench_tpu_torch.io import tokenizer as ttok
from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy
from ct_diffusionmodelbench_tpu_torch.models import get_config as t_get_config
from ct_diffusionmodelbench_tpu_torch.models import make_forward_fn as t_make_forward_fn
from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as tfa
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as tgg
from ct_diffusionmodelbench_tpu_torch.sampling import llada_generate as t_generate

GROUPED_TOL = dict(rtol=1e-4, atol=1e-5)
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
FLASH_ROPE_TOL = dict(rtol=2e-4, atol=2e-4)
ALIGNED = dict(hidden_size=128, moe_intermediate_size=128, head_dim=32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def switches(monkeypatch):
    monkeypatch.setenv("CTDB_GROUPED_FUSED", "1")
    monkeypatch.setenv("CTDB_FLASH_DIRECT", "1")


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (still calling it)."""
    calls = []
    real = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


# ---------------------------------------------------------------------------
# K3: the fused expert FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [None, 2])
def test_fused_ffn_plain_matches_jax_megakernel(switches, monkeypatch, layers):
    """``grouped_expert_ffn_cuda`` under the switch (the fused plain version
    here) against ``grouped_expert_ffn_pallas(..., tile_m=8)``, whose
    ``grouped_ffn_fused_padded`` runs in interpret mode; 3-D and stacked."""
    n, d, e, f, k = 40, 128, 6, 128, 2
    ks = jax.random.split(jax.random.key(layers or 0), 5)
    lead = () if layers is None else (layers,)
    x = jax.random.normal(ks[0], (n, d))
    wg = jax.random.normal(ks[1], lead + (e, d, f)) / np.sqrt(d)
    wu = jax.random.normal(ks[2], lead + (e, d, f)) / np.sqrt(d)
    wd = jax.random.normal(ks[3], lead + (e, f, d)) / np.sqrt(f)
    probs, idx, _ = j_router_probs(x, jax.random.normal(ks[4], (d, e)) / np.sqrt(d),
                                   k, True)
    li = None if layers is None else 1
    j_calls = _spy(monkeypatch, jgg, "grouped_ffn_fused_padded")
    t_calls = _spy(monkeypatch, tgg, "grouped_ffn_fused")
    want = jgg.grouped_expert_ffn_pallas(
        x, probs, idx, wg, wu, wd, tile_m=8,
        layer_index=None if li is None else jnp.int32(li))
    got = tgg.grouped_expert_ffn_cuda(_t(x), _t(probs), _t(idx), _t(wg), _t(wu),
                                      _t(wd), tile_m=8, layer_index=li)
    assert len(j_calls) == len(t_calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GROUPED_TOL)


@pytest.mark.parametrize("layers", [None, 2])
def test_fused_ffn_plain_pad_skip_matches_jax(switches, monkeypatch, layers):
    """The fused plain version with ``tile_valid`` against the reference's
    fused kernel under ``CTDB_GROUPED_SKIP_PAD=1`` (interpret mode), on the
    layout and pad-skip vector ``grouped_expert_ffn_pallas`` builds: equal on
    the real tiles, zero on the tiles marked 0 (the reference zero-fills them
    too, except a run's first tile, whose weight copy it still waits for);
    and the port's FFN, which always hands K3 the vector, against the
    reference's; 3-D and stacked."""
    monkeypatch.setenv("CTDB_GROUPED_SKIP_PAD", "1")
    n, d, e, f, k = 40, 128, 6, 128, 2
    ks = jax.random.split(jax.random.key(7 + (layers or 0)), 5)
    lead = () if layers is None else (layers,)
    x = jax.random.normal(ks[0], (n, d))
    wg = jax.random.normal(ks[1], lead + (e, d, f)) / np.sqrt(d)
    wu = jax.random.normal(ks[2], lead + (e, d, f)) / np.sqrt(d)
    wd = jax.random.normal(ks[3], lead + (e, f, d)) / np.sqrt(f)
    probs, idx, _ = j_router_probs(x, jax.random.normal(ks[4], (d, e)) / np.sqrt(d),
                                   k, True)
    li = None if layers is None else 1
    seen = {}
    fused = jgg.grouped_ffn_fused_padded

    def recording(xs, we_gate, we_up, we_down, te, tile_m, layer_index=None,
                  tile_valid=None):
        out = fused(xs, we_gate, we_up, we_down, te, tile_m, layer_index=layer_index,
                    tile_valid=tile_valid)
        seen.update(xs=xs, te=te, valid=tile_valid, out=out)
        return out

    monkeypatch.setattr(jgg, "grouped_ffn_fused_padded", recording)
    want = jgg.grouped_expert_ffn_pallas(
        x, probs, idx, wg, wu, wd, tile_m=8,
        layer_index=None if li is None else jnp.int32(li))
    valid = np.asarray(seen["valid"])
    assert (valid == 0).any() and (valid == 1).any()
    got = tgg.grouped_ffn_fused_plain(_t(seen["xs"]), _t(wg), _t(wu), _t(wd),
                                      _t(seen["te"]), 8, li, _t(valid))
    real = np.repeat(valid, 8) == 1
    np.testing.assert_allclose(got.numpy()[real], np.asarray(seen["out"])[real],
                               **GROUPED_TOL)
    assert not got.numpy()[~real].any()
    np.testing.assert_allclose(
        tgg.grouped_expert_ffn_cuda(_t(x), _t(probs), _t(idx), _t(wg), _t(wu), _t(wd),
                                    tile_m=8, layer_index=li).numpy(),
        np.asarray(want), **GROUPED_TOL)


def test_fused_ffn_plain_is_the_pair():
    """The fused plain version is the pair's plain versions with h rounded
    to x's dtype between them (bf16 here)."""
    g = torch.Generator().manual_seed(0)
    xs = torch.randn((128, 128), generator=g).to(torch.bfloat16)
    wg, wu = (torch.randn((2, 3, 128, 256), generator=g).to(torch.bfloat16)
              for _ in range(2))
    wd = torch.randn((2, 3, 256, 128), generator=g).to(torch.bfloat16)
    te = torch.tensor([2, 0], dtype=torch.int32)
    h = tgg.grouped_gateup_plain(xs, wg, wu, te, 64, 1)
    assert h.dtype == torch.bfloat16
    want = tgg.grouped_down_plain(h, wd, te, 64, 1)
    got = tgg.grouped_ffn_fused_plain(xs, wg, wu, wd, te, 64, 1)
    assert torch.equal(got, want) and got.dtype == torch.bfloat16
    # The kernel reaches F 1024, a cluster of 8 CTAs of 128 columns of h:
    # llada-moe-7b's 896 fits, 1408 does not.
    assert 896 <= tgg.FUSED_MAX_F == 8 * 128 < 1408


def test_fused_switch_takes_only_aligned_plain_weights(monkeypatch):
    x = torch.randn((10, 64))
    probs = torch.full((10, 2), 0.5)
    idx = torch.randint(0, 4, (10, 2))
    w = [torch.randn((4, 64, 32)), torch.randn((4, 64, 32)), torch.randn((4, 32, 64))]
    calls = _spy(monkeypatch, tgg, "grouped_ffn_fused")
    monkeypatch.setenv("CTDB_GROUPED_FUSED", "1")
    tgg.grouped_expert_ffn_cuda(x, probs, idx, *w)            # D, F not % 128
    assert not calls
    wide = [torch.randn((4, 128, 1152)), torch.randn((4, 128, 1152)),
            torch.randn((4, 1152, 128))]
    tgg.grouped_expert_ffn_cuda(torch.randn((10, 128)), probs, idx, *wide)
    assert not calls                                          # F past a cluster of 8
    monkeypatch.setenv("CTDB_GROUPED_FUSED", "0")
    a = [torch.randn((4, 128, 128)), torch.randn((4, 128, 128)), torch.randn((4, 128, 128))]
    tgg.grouped_expert_ffn_cuda(torch.randn((10, 128)), probs, idx, *a)
    assert not calls


# ---------------------------------------------------------------------------
# K9: direct flash attention
# ---------------------------------------------------------------------------

def _qkv(b, s, h, kv, dh, seed):
    ks = jax.random.split(jax.random.key(seed), 3)
    return (jax.random.normal(ks[0], (b, s, h, dh)),
            jax.random.normal(ks[1], (b, s, kv, dh)),
            jax.random.normal(ks[2], (b, s, kv, dh)))


def _rope(b, s, dh, mask=None):
    pos = np.broadcast_to(np.arange(s), (b, s)) if mask is None else \
        np.maximum(np.cumsum(mask, -1) - 1, 0)
    return j_rope_angles(jnp.asarray(pos), dh, 10000.0)


@pytest.mark.parametrize("b,s,h,kv,dh", [
    (1, 320, 8, 8, 64),   # the B = 1 serving shape
    (2, 200, 8, 2, 64),   # GQA and batch
    (1, 24, 4, 4, 32),    # tiny
])
def test_direct_flash_matches_jax(switches, monkeypatch, b, s, h, kv, dh):
    """The port's flash attention (its plain version here) against JAX's
    under CTDB_FLASH_DIRECT=1, whose ``_flash_kernel_direct`` runs in
    interpret mode: masks, RoPE and lse."""
    calls = _spy(monkeypatch, jfa, "_flash_kernel_direct")
    q, k, v = _qkv(b, s, h, kv, dh, 21)
    mask = (jax.random.uniform(jax.random.key(22), (b, s)) > 0.2).astype(jnp.int32)
    for m in (None, mask):
        want = jfa.flash_attention(q, k, v, m)
        got = tfa.flash_attention(_t(q), _t(k), _t(v), None if m is None else _t(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    assert calls        # the reference really took its direct kernel
    cos, sin = _rope(b, s, dh, np.asarray(mask))
    want = jfa.flash_attention(q, k, v, mask=mask, rope=(cos, sin))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), _t(mask), rope=(_t(cos), _t(sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_ROPE_TOL)
    # lse, against the reference's forward with lse (flat layout, one kv tile)
    tq, tk, sq_pad, sk_pad = jfa._tiles(s, jfa.DEFAULT_TQ, jfa.DEFAULT_TK)
    assert sk_pad == tk
    pad_q = ((0, 0), (0, sq_pad - s), (0, 0))
    pad_k = ((0, 0), (0, sk_pad - s), (0, 0))
    bias = jnp.where(jnp.pad(mask, ((0, 0), (0, sk_pad - s))) > 0, 0.0,
                     jfa.NEG_INF).astype(jnp.float32)[:, None, :]
    _, lse_j = jfa._run_forward(
        h, kv, dh, tq, tk, jnp.pad(q.reshape(b, s, h * dh), pad_q),
        jnp.pad(k.reshape(b, s, kv * dh), pad_k), jnp.pad(v.reshape(b, s, kv * dh), pad_k),
        bias, with_lse=True)
    _, lse_t = tfa.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask), with_lse=True)
    np.testing.assert_allclose(lse_t.numpy(),
                               np.asarray(lse_j).reshape(b, h, sq_pad)[:, :, :s],
                               rtol=1e-5, atol=1e-5)


def test_direct_flash_gradient_matches_jax(switches):
    """The gradient through ``FlashAttention`` (its forward takes the direct
    path under the switch) against ``jax.grad`` of the reference's, whose
    backward reads the direct kernel's lse."""
    q, k, v = _qkv(1, 96, 4, 2, 32, 23)
    cos, sin = _rope(1, 96, 32)

    def loss_j(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, rope=(cos, sin)) ** 2)

    want = jax.grad(loss_j, argnums=(0, 1, 2))(q, k, v)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    loss = (tfa.flash_attention(*leaves, rope=(_t(cos), _t(sin))) ** 2).sum()
    got = torch.autograd.grad(loss, leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_direct_mode_reads_the_switch(monkeypatch):
    monkeypatch.delenv("CTDB_FLASH_DIRECT", raising=False)
    assert not tfa.direct_mode()
    for val, want in (("1", True), (" 1 ", True), ("0", False), ("auto", False)):
        monkeypatch.setenv("CTDB_FLASH_DIRECT", val)
        assert tfa.direct_mode() is want
    assert tfa.single_kv_tile(1024) and not tfa.single_kv_tile(1025)
    for s in (24, 200, 448, 512, 1024):
        assert tfa.kv_tile_len(s) == jfa._tiles(s, jfa.DEFAULT_TQ, jfa.DEFAULT_TK)[1]


# ---------------------------------------------------------------------------
# the chat CLIs
# ---------------------------------------------------------------------------

def _runners(name, seed, **over):
    jcfg = j_get_config(name, dtype="float32", **over)
    tcfg = t_get_config(name, dtype="float32", **over)
    jparams = j_init_params(jcfg, jax.random.key(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tok_j = jtok.Tokenizer.byte_fallback(vocab_size=512, eos_token_id=2)
    tok_t = ttok.Tokenizer.byte_fallback(vocab_size=512, eos_token_id=2)
    return (JRunner(jcfg, jparams, tok_j), ModelRunner(tcfg, tparams, tok_t, device="cpu"))


CHAT_ARGS = ["--prompt", "Prove that 1 + 1 = 2.", "--gen-length", "16", "--steps", "8",
             "--block-length", "8"]


@pytest.mark.parametrize("name,extra", [
    ("llada-moe-tiny", []),
    ("llada-tiny", ["--no-lean-only", "--no-avoid-eos", "--cfg-scale", "1.0"]),
    ("dream-tiny", ["--system-message", "Be brief."]),
])
def test_run_chat_matches_jax(name, extra):
    jr, tr = _runners(name, 3)
    args_j = jchat.build_parser().parse_args(CHAT_ARGS + extra)
    args_t = tchat.build_parser().parse_args(CHAT_ARGS + extra + ["--device", "cpu"])
    want, got = jchat.run_chat(jr, args_j.prompt, args_j), tchat.run_chat(tr, args_t.prompt, args_t)
    assert got["prompt"] == want["prompt"]
    assert got["generated"] == want["generated"]
    assert got["mask_id"] == want["mask_id"]


@pytest.mark.parametrize("name", ["llada-tiny", "dream-tiny"])
def test_chat_base_respond_matches_jax(name):
    """The AR baseline: causal and unshifted forward, greedy decoding."""
    jr, tr = _runners(name, 4)
    jr.cfg = jr.cfg.replace(causal=True, logit_shift=False)
    jr.forward_fn = j_make_forward_fn(jr.cfg)
    tchat_base.as_causal(tr)
    assert tr.cfg.causal and not tr.cfg.logit_shift
    argv = ["--max-new-tokens", "8", "--temperature", "0"]
    args_j = jchat_base.build_parser().parse_args(argv)
    args_t = tchat_base.build_parser().parse_args(argv + ["--device", "cpu"])
    msgs = [{"role": "system", "content": "sys"}, {"role": "user", "content": "hi there"}]
    assert tchat_base._respond(tr, msgs, args_t) == jchat_base._respond(jr, msgs, args_j)
    sampled = tchat_base.build_parser().parse_args(["--max-new-tokens", "4", "--seed", "3"])
    first = tchat_base._respond(tr, msgs, sampled)
    assert first == tchat_base._respond(tr, msgs, sampled)   # seeded


def _interactive(module, runner, args, inputs, monkeypatch, capsys):
    feed = iter(inputs)

    def fake_input(prompt=""):
        try:
            return next(feed)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", fake_input)
    module.interactive_chat(runner, args)
    return capsys.readouterr().out


def test_interactive_chat_matches_jax(monkeypatch, capsys):
    """`/reset` clears the history, `/exit` ends; the transcript equals the
    reference's, reply for reply."""
    jr, tr = _runners("llada-tiny", 5)
    argv = CHAT_ARGS[2:]
    inputs = ["hello", "", "and again", "/reset", "hello", "/exit", "never read"]
    want = _interactive(jchat, jr, jchat.build_parser().parse_args(argv), inputs,
                        monkeypatch, capsys)
    got = _interactive(tchat, tr, tchat.build_parser().parse_args(argv + ["--device", "cpu"]),
                       inputs, monkeypatch, capsys)
    assert got == want
    assert got.count("Assistant:") == 3 and "History cleared." in got and "Goodbye." in got
    replies = got.split("Assistant:\n")
    assert replies[1].split("\n")[0] == replies[3].split("\n")[0]  # after /reset
    out = _interactive(tchat, tr, tchat.build_parser().parse_args(argv + ["--device", "cpu"]),
                       [], monkeypatch, capsys)  # EOF on the first read
    assert "Exiting." in out


def test_chat_main_and_flags(monkeypatch, capsys):
    tchat.main(["--preset", "llada-moe-tiny", "--device", "cpu"] + CHAT_ARGS)
    out = capsys.readouterr().out
    assert "=== Generation Result ===" in out and "mask_id=500" in out
    parser = tchat.build_parser()
    with pytest.raises(NotImplementedError, match="Queue 1 #7"):
        tchat._load_runner(parser.parse_args(["--preset", "llada-tiny", "--tp", "2",
                                              "--device", "cpu"]))
    with pytest.raises(NotImplementedError, match="block-cache"):
        tchat._load_runner(parser.parse_args(["--preset", "llada-tiny", "--accel",
                                              "block-cache", "--device", "cpu"]))
    r = tchat._load_runner(parser.parse_args(["--preset", "llada-tiny", "--quant", "int8",
                                              "--parallel-threshold", "0.9",
                                              "--mask-id", "7", "--device", "cpu"]))
    assert r.quant == "int8" and r.parallel_threshold == 0.9 and r.mask_id == 7
    with pytest.raises(NotImplementedError, match="parallel_threshold"):
        tchat.run_chat(r, "x", parser.parse_args(CHAT_ARGS))
    tchat_base.main(["--preset", "llada-tiny", "--device", "cpu", "--prompt", "hi",
                     "--max-new-tokens", "3"])
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchat.main(["--preset", "llada-tiny"] + CHAT_ARGS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchat_base.main(["--preset", "llada-tiny", "--prompt", "hi"])


# ---------------------------------------------------------------------------
# end to end: one decode through both opt-in kernels
# ---------------------------------------------------------------------------

def test_generate_through_k3_k9_matches_jax_interpret(switches, monkeypatch):
    """Greedy B = 1 decoding of a 128-aligned llada-moe-tiny: the JAX side
    runs ``attn_impl="pallas"`` and its grouped MoE path, so its K3 and K9 run
    in interpret mode; token for token with the port."""
    monkeypatch.setenv("CTDB_GROUPED_GEMM", "pallas")
    monkeypatch.setattr(jtransformer, "moe_block",
                        functools.partial(jmoe.moe_block, impl="grouped"))
    j_k3 = _spy(monkeypatch, jgg, "grouped_ffn_fused_padded")
    j_k9 = _spy(monkeypatch, jfa, "_flash_kernel_direct")
    t_k3 = _spy(monkeypatch, tgg, "grouped_ffn_fused")
    jcfg = j_get_config("llada-moe-tiny", dtype="float32", attn_impl="pallas", **ALIGNED)
    tcfg = t_get_config("llada-moe-tiny", dtype="float32", **ALIGNED)
    jp = j_init_params(jcfg, jax.random.key(17))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompt = np.random.default_rng(18).integers(3, 480, (1, 8)).astype(np.int32)
    kw = dict(steps=4, gen_length=8, block_length=8, mask_id=jcfg.mask_token_id)
    want = j_generate(j_make_forward_fn(jcfg), jp, jnp.asarray(prompt), **kw)
    got = t_generate(t_make_forward_fn(tcfg, device="cpu"), tp, _t(prompt),
                     device="cpu", **kw)
    assert j_k3 and j_k9           # traced into the reference's decode
    assert len(t_k3) == tcfg.num_layers * 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got[:, 8:] == jcfg.mask_token_id).any()
