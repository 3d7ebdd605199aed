"""Export the port's parameters as an HF-layout checkpoint.

Counterpart of the save half of ``io/checkpoint.py`` (``flatten_to_hf``,
``_hf_config_dict``, ``save_checkpoint``): ``config.json`` plus sharded
safetensors (1 GB shards and ``model.safetensors.index.json``, or one
``model.safetensors``), canonical HF names, 2-D projection weights
transposed back to HF's ``[out, in]``, layer stacks split per layer.  The
reference's ``load_checkpoint`` reads the result; loading into the port
belongs to the runner slice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

from ct_diffusionmodelbench_tpu_torch.io.safetensors_io import (
    save_safetensors, shard_tensors)
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig

WEIGHTS_INDEX = "model.safetensors.index.json"
WEIGHTS_SINGLE = "model.safetensors"


# (our key, canonical HF name template, transpose 2-D [in,out]→[out,in]).
def _global_specs(cfg: ModelConfig):
    specs = [
        ("embed", "model.embed_tokens.weight", False),
        ("final_norm", "model.norm.weight", False),
    ]
    if not cfg.tie_embeddings:
        specs.append(("lm_head", "lm_head.weight", True))
    return specs


def _layer_specs(cfg: ModelConfig):
    a = "model.layers.{i}.self_attn."
    m = "model.layers.{i}.mlp."
    specs = [
        ("attn_norm", "model.layers.{i}.input_layernorm.weight", False),
        ("wq", a + "q_proj.weight", True),
        ("wk", a + "k_proj.weight", True),
        ("wv", a + "v_proj.weight", True),
        ("wo", a + "o_proj.weight", True),
        ("ffn_norm", "model.layers.{i}.post_attention_layernorm.weight", False),
    ]
    if cfg.attention_bias:
        specs += [("bq", a + "q_proj.bias", False),
                  ("bk", a + "k_proj.bias", False),
                  ("bv", a + "v_proj.bias", False)]
    if cfg.qk_norm:
        specs += [("q_norm", a + "q_norm.weight", False),
                  ("k_norm", a + "k_norm.weight", False)]
    if cfg.is_moe:
        specs += [("router", m + "gate.weight", True)]
        if cfg.num_shared_experts:
            specs += [("ws_gate", m + "shared_experts.gate_proj.weight", True),
                      ("ws_up", m + "shared_experts.up_proj.weight", True),
                      ("ws_down", m + "shared_experts.down_proj.weight", True)]
    else:
        specs += [("w_gate", m + "gate_proj.weight", True),
                  ("w_up", m + "up_proj.weight", True),
                  ("w_down", m + "down_proj.weight", True)]
    return specs


def _expert_specs():
    m = "model.layers.{i}.mlp.experts.{e}."
    return [("we_gate", m + "gate_proj.weight", True),
            ("we_up", m + "up_proj.weight", True),
            ("we_down", m + "down_proj.weight", True)]


def flatten_to_hf(cfg: ModelConfig, params: dict) -> Dict[str, torch.Tensor]:
    """Our params → flat {canonical HF name: [out, in] tensor} (views on the
    params' device; the writer copies each to the host)."""
    def conv(t, transpose):
        return t.T if transpose and t.ndim == 2 else t

    out: Dict[str, torch.Tensor] = {}
    for key, name, tp in _global_specs(cfg):
        out[name] = conv(params[key], tp)
    for key, name, tp in _layer_specs(cfg):
        stacked = params["blocks"][key]
        for i in range(cfg.num_layers):
            out[name.format(i=i)] = conv(stacked[i], tp)
    if cfg.is_moe:
        for key, name, tp in _expert_specs():
            stacked = params["blocks"][key]
            for i in range(cfg.num_layers):
                for e in range(cfg.num_experts):
                    out[name.format(i=i, e=e)] = conv(stacked[i, e], tp)
    return out


def _hf_config_dict(cfg: ModelConfig) -> dict:
    d = {
        "model_type": cfg.name,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_size,
        "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_seq_len,
        "attention_bias": cfg.attention_bias,
        "use_qk_norm": cfg.qk_norm,
        "tie_word_embeddings": cfg.tie_embeddings,
        "mask_token_id": cfg.mask_token_id,
        "eos_token_id": cfg.eos_token_id,
        "pad_token_id": cfg.pad_token_id,
        "torch_dtype": "bfloat16" if cfg.dtype == "bfloat16" else cfg.dtype,
    }
    if cfg.logit_shift:
        d["logit_shift"] = True
    if cfg.is_moe:
        d.update(
            num_experts=cfg.num_experts,
            num_experts_per_tok=cfg.num_experts_per_tok,
            moe_intermediate_size=cfg.moe_intermediate_size,
            num_shared_experts=cfg.num_shared_experts,
            norm_topk_prob=cfg.norm_topk_prob,
        )
    return d


def save_checkpoint(model_dir: str | Path, cfg: ModelConfig, params: dict,
                    max_shard_size: int = 1 << 30) -> None:
    """Export to HF layout: config.json + sharded safetensors + index."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    shards = list(shard_tensors(flatten_to_hf(cfg, params), max_shard_size))
    if len(shards) == 1:
        save_safetensors(model_dir / WEIGHTS_SINGLE, shards[0],
                         metadata={"format": "pt"})
    else:
        weight_map = {}
        total = 0
        for n, shard in enumerate(shards, start=1):
            shard_name = f"model-{n:05d}-of-{len(shards):05d}.safetensors"
            save_safetensors(model_dir / shard_name, shard, metadata={"format": "pt"})
            for name, t in shard.items():
                weight_map[name] = shard_name
                total += t.numel() * t.element_size()
        with open(model_dir / WEIGHTS_INDEX, "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f, indent=2)
    with open(model_dir / "config.json", "w") as f:
        json.dump(_hf_config_dict(cfg), f, indent=2)
