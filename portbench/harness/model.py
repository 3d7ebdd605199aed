"""A configuration file's sizes, and the weights drawn from the seed.

:func:`sizes` reads a configuration file (the published ``config.json``'s
keys, in either of LLaDA's two vocabularies) into one plain dict that both
the program's ``ModelConfig`` and the plain reference are built from.
:func:`draw_weights` draws a model's weights on the device from a seeded
``torch.Generator``, one call per layer stack, in the layout the port
takes (``params["blocks"][name]`` stacked over layers); :func:`iter_weights`
gives them one at a time, in the order drawn.  The program and
the reference each get a draw of their own from the same seed: the draws
are equal bit for bit, and neither sees what the other did to its copy.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.harness import seeds

# sizes key -> the configuration file's keys, first present wins.
_KEYS = {
    "vocab_size": ("vocab_size", "embedding_size"),
    "hidden_size": ("hidden_size", "d_model"),
    "num_layers": ("num_hidden_layers", "n_layers"),
    "num_heads": ("num_attention_heads", "n_heads"),
    "num_kv_heads": ("num_key_value_heads", "n_kv_heads"),
    "head_dim": ("head_dim",),
    "intermediate_size": ("intermediate_size", "mlp_hidden_size"),
    "num_experts": ("num_experts",),
    "num_experts_per_tok": ("num_experts_per_tok",),
    "moe_intermediate_size": ("moe_intermediate_size",),
    "num_shared_experts": ("num_shared_experts",),
    "norm_topk_prob": ("norm_topk_prob",),
    "norm_eps": ("rms_norm_eps",),
    "rope_theta": ("rope_theta",),
    "qk_norm": ("use_qk_norm",),
    "attention_bias": ("attention_bias", "include_bias"),
    "mask_token_id": ("mask_token_id",),
    "eos_token_id": ("eos_token_id",),
    "dtype": ("torch_dtype",),
}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sizes(conf: dict) -> Dict:
    """The configuration as one flat dict of the keys above."""
    out = {}
    for key, names in _KEYS.items():
        out[key] = next((conf[n] for n in names if n in conf), None)
    out["num_experts"] = out["num_experts"] or 0
    out["num_experts_per_tok"] = out["num_experts_per_tok"] or 0
    out["moe_intermediate_size"] = out["moe_intermediate_size"] or 0
    out["num_shared_experts"] = out["num_shared_experts"] or 0
    out["norm_topk_prob"] = True if out["norm_topk_prob"] is None else bool(out["norm_topk_prob"])
    out["qk_norm"] = bool(out["qk_norm"])
    out["attention_bias"] = bool(out["attention_bias"])
    if out["head_dim"] is None:
        out["head_dim"] = out["hidden_size"] // out["num_heads"]
    if out["num_kv_heads"] is None:
        out["num_kv_heads"] = out["num_heads"]
    out["name"] = conf["name"]
    return out


def port_config(s: Dict, device: torch.device):
    """The program's ``ModelConfig`` of these sizes.  Off the card a bf16
    model runs in f32, as the program's own entry points do there."""
    from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig

    dtype = s["dtype"]
    if device.type != "cuda":
        dtype = "float32"
    return ModelConfig(
        name=s["name"], family="llada-moe" if s["num_experts"] else "llada",
        vocab_size=s["vocab_size"], hidden_size=s["hidden_size"],
        num_layers=s["num_layers"], num_heads=s["num_heads"],
        num_kv_heads=s["num_kv_heads"], head_dim=s["head_dim"],
        intermediate_size=s["intermediate_size"] or 0, norm_eps=s["norm_eps"],
        rope_theta=s["rope_theta"], attention_bias=s["attention_bias"],
        qk_norm=s["qk_norm"], num_experts=s["num_experts"],
        num_experts_per_tok=s["num_experts_per_tok"],
        moe_intermediate_size=s["moe_intermediate_size"],
        num_shared_experts=s["num_shared_experts"], norm_topk_prob=s["norm_topk_prob"],
        mask_token_id=s["mask_token_id"], eos_token_id=s["eos_token_id"],
        dtype=dtype)


def weight_dtype(s: Dict, device: torch.device) -> torch.dtype:
    return DTYPES[s["dtype"]] if device.type == "cuda" else torch.float32


def iter_weights(s: Dict, seed: int, device: torch.device):
    """(flat name, tensor) of each leaf, in the order it is drawn: normals
    over the square root of the fan-in, norm gains 1 + 0.1·normal, zero
    biases.  The LM head's column of the mask id is zero, so no position
    ever predicts the mask itself, as a trained model does not; without it
    a random head makes the mask the greedy token once in ``vocab_size``
    picks, which leaves that position masked."""
    gen = seeds.device_generator(seed, seeds.WEIGHTS, device)
    dt = weight_dtype(s, device)

    def dense(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def gain(shape):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return t.mul_(0.1).add_(1.0)

    L, D, V = s["num_layers"], s["hidden_size"], s["vocab_size"]
    Dh = s["head_dim"]
    Hq, Hkv = s["num_heads"] * Dh, s["num_kv_heads"] * Dh
    yield "blocks/attn_norm", gain((L, D))
    yield "blocks/wq", dense((L, D, Hq), D)
    yield "blocks/wk", dense((L, D, Hkv), D)
    yield "blocks/wv", dense((L, D, Hkv), D)
    yield "blocks/wo", dense((L, Hq, D), Hq)
    yield "blocks/ffn_norm", gain((L, D))
    if s["attention_bias"]:
        for k, n in (("bq", Hq), ("bk", Hkv), ("bv", Hkv)):
            yield f"blocks/{k}", torch.zeros((L, n), dtype=dt, device=device)
    if s["qk_norm"]:
        yield "blocks/q_norm", gain((L, Dh))
        yield "blocks/k_norm", gain((L, Dh))
    if s["num_experts"]:
        E, Fm = s["num_experts"], s["moe_intermediate_size"]
        yield "blocks/router", dense((L, D, E), D)
        yield "blocks/we_gate", dense((L, E, D, Fm), D)
        yield "blocks/we_up", dense((L, E, D, Fm), D)
        yield "blocks/we_down", dense((L, E, Fm, D), Fm)
        if s["num_shared_experts"]:
            Fs = Fm * s["num_shared_experts"]
            yield "blocks/ws_gate", dense((L, D, Fs), D)
            yield "blocks/ws_up", dense((L, D, Fs), D)
            yield "blocks/ws_down", dense((L, Fs, D), Fs)
    else:
        F = s["intermediate_size"]
        yield "blocks/w_gate", dense((L, D, F), D)
        yield "blocks/w_up", dense((L, D, F), D)
        yield "blocks/w_down", dense((L, F, D), F)
    head = dense((D, V), D)
    head[:, s["mask_token_id"]] = 0
    yield "lm_head", head
    yield "embed", dense((V, D), D)
    yield "final_norm", gain((D,))


def draw_weights(s: Dict, seed: int, device: torch.device) -> dict:
    """Seeded weights in the port's layout (:func:`iter_weights`), drawn on
    ``device`` in the model's dtype."""
    out: dict = {"blocks": {}}
    for name, t in iter_weights(s, seed, device):
        if name.startswith("blocks/"):
            out["blocks"][name[len("blocks/"):]] = t
        else:
            out[name] = t
    return out
