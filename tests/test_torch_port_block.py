"""Every pass of the port runs one layer body, ``models/transformer.py::block``.

The full forward (dense and MoE), the dual cache's refresh and cached step
(``models/block_cache.py``) and SDAR's prefill, step and commit
(``models/sdar_cache.py``) each bring only their attention.  A counting
wrapper put in place of ``block`` in each of those modules must see every
pass call it once a layer, in layer order, and the wrapped pass must give
the very tensors of the unwrapped one.
"""

import pytest
import torch

from ct_diffusionmodelbench_tpu_torch.models import (
    block_cache, get_config, init_params, sdar_cache, transformer)
from tests.torch_port_threads import one_torch_thread  # noqa: F401

B, S, BL = 2, 16, 4


def _inputs():
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(10, 200, (B, S), generator=g)
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[0, :5] = 0
    return ids, mask, torch.randint(10, 200, (B, BL), generator=g)


def _model(preset):
    cfg = get_config(preset)
    return cfg, init_params(cfg, seed=1, device="cpu")


def forward_pass(preset):
    def make():
        cfg, params = _model(preset)
        ids, mask, _ = _inputs()
        return cfg, lambda: transformer.forward(cfg, params, ids, attn_mask=mask)
    return make


def refresh_pass():
    cfg, params = _model("llada-moe-tiny")
    ids, mask, _ = _inputs()
    return cfg, lambda: block_cache.forward_refresh(cfg, params, ids, mask, 8, BL)


def cached_step_pass():
    cfg, params = _model("llada-moe-tiny")
    ids, mask, blk = _inputs()
    _, kc, vc = block_cache.forward_refresh(cfg, params, ids, mask, 8, BL)
    return cfg, lambda: (block_cache.forward_cached_step(cfg, params, blk, 8, kc, vc, mask),)


def sdar_pass(kind):
    def make():
        cfg, params = _model("sdar-tiny")
        ids, mask, blk = _inputs()
        prefill, step, commit = sdar_cache.make_sdar_fns(cfg)
        P = 8

        def run_prefill():
            cache = prefill(params, ids[:, :P], mask[:, :P], S, int(mask[:, :P].sum()))
            return cache.k[:, :, :P].clone(), cache.v[:, :, :P].clone()

        if kind == "prefill":
            return cfg, run_prefill
        cache = prefill(params, ids[:, :P], mask[:, :P], S, int(mask[:, :P].sum()))
        if kind == "step":
            return cfg, lambda: (step(params, cache, blk, P).clone(),)

        def run_commit():
            commit(params, cache, blk, P)
            return cache.k[:, :, :P + BL].clone(), cache.v[:, :, :P + BL].clone()
        return cfg, run_commit
    return make


PASSES = {
    "forward-llada-tiny": forward_pass("llada-tiny"),
    "forward-llada-moe-tiny": forward_pass("llada-moe-tiny"),
    "block-cache-refresh": refresh_pass,
    "block-cache-step": cached_step_pass,
    "sdar-prefill": sdar_pass("prefill"),
    "sdar-step": sdar_pass("step"),
    "sdar-commit": sdar_pass("commit"),
}


@pytest.mark.parametrize("name", list(PASSES))
@torch.inference_mode()
def test_every_pass_runs_the_one_block_body(name, monkeypatch):
    cfg, run = PASSES[name]()
    plain = [t.clone() for t in run()]
    inner, layers = transformer.block, []

    def counting(cfg_, x, lp, li, *a, **k):
        layers.append(li)
        return inner(cfg_, x, lp, li, *a, **k)

    for module in (transformer, block_cache, sdar_cache):
        monkeypatch.setattr(module, "block", counting)
    wrapped = run()
    assert layers == list(range(cfg.num_layers))
    assert len(wrapped) == len(plain)
    for got, want in zip(wrapped, plain):
        assert got.dtype == want.dtype and torch.equal(got, want)
