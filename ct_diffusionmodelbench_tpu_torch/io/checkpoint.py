"""HF-layout checkpoints and the int8 serving checkpoints, to and from the
port's parameter dicts.

Counterpart of ``io/checkpoint.py``, read and written through the port's own
``io/safetensors_io.py``:

- :func:`load_checkpoint` reads an HF directory (``model.safetensors`` or
  an index and shards): each leaf takes the first of its candidate names
  present (LLaMA/Qwen ``model.layers.{i}.self_attn.q_proj.weight`` first,
  OLMo/LLaDA ``model.transformer.blocks.{i}.q_proj.weight`` as alias), 2-D
  projection weights transpose from HF's ``[out, in]`` to ``[in, out]``,
  layers stack along a leading axis, experts come per expert or as stacked
  ``[E, out, in]`` / fused ``[E·out, in]`` tensors.
- :func:`save_checkpoint` writes ``config.json`` plus sharded safetensors
  (1 GB shards and ``model.safetensors.index.json``, or one
  ``model.safetensors``) under the canonical names.
- The int8 serving format (``ops/quant.py`` trees) has no HF equivalent:
  safetensors keyed by dotted tree path (``blocks.wq.q`` int8,
  ``blocks.wq.s`` f32) and a ``ctdb_quant: "int8"`` marker in
  ``config.json`` (:func:`save_quantized_checkpoint`,
  :func:`is_quantized_checkpoint`, :func:`load_quantized_checkpoint`).

The JAX package reads what this module writes, and the reverse.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import torch

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device
from ct_diffusionmodelbench_tpu_torch.io.safetensors_io import (
    load_safetensors, save_safetensors, shard_tensors)
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig, config_from_hf
from ct_diffusionmodelbench_tpu_torch.models.transformer import DTYPES

WEIGHTS_INDEX = "model.safetensors.index.json"
WEIGHTS_SINGLE = "model.safetensors"


# (our key, [HF name templates, canonical first], transpose 2-D [out,in]↔[in,out])
def _global_specs(cfg: ModelConfig):
    specs = [
        ("embed", ["model.embed_tokens.weight", "model.transformer.wte.weight",
                   "transformer.wte.weight", "embed_tokens.weight"], False),
        ("final_norm", ["model.norm.weight", "model.transformer.ln_f.weight",
                        "model.final_layernorm.weight"], False),
    ]
    if not cfg.tie_embeddings:
        specs.append(("lm_head", ["lm_head.weight", "model.transformer.ff_out.weight",
                                  "model.lm_head.weight"], True))
    return specs


def _layer_specs(cfg: ModelConfig):
    a = "model.layers.{i}.self_attn."
    o = "model.transformer.blocks.{i}."
    m = "model.layers.{i}.mlp."
    specs = [
        ("attn_norm", ["model.layers.{i}.input_layernorm.weight", o + "attn_norm.weight"], False),
        ("wq", [a + "q_proj.weight", o + "q_proj.weight"], True),
        ("wk", [a + "k_proj.weight", o + "k_proj.weight"], True),
        ("wv", [a + "v_proj.weight", o + "v_proj.weight"], True),
        ("wo", [a + "o_proj.weight", o + "attn_out.weight"], True),
        ("ffn_norm", ["model.layers.{i}.post_attention_layernorm.weight", o + "ff_norm.weight"], False),
    ]
    if cfg.attention_bias:
        specs += [("bq", [a + "q_proj.bias"], False),
                  ("bk", [a + "k_proj.bias"], False),
                  ("bv", [a + "v_proj.bias"], False)]
    if cfg.qk_norm:
        specs += [("q_norm", [a + "q_norm.weight", o + "q_norm.weight"], False),
                  ("k_norm", [a + "k_norm.weight", o + "k_norm.weight"], False)]
    if cfg.is_moe:
        specs += [("router", [m + "gate.weight", m + "router.weight",
                              "model.layers.{i}.block_sparse_moe.gate.weight"], True)]
        if cfg.num_shared_experts:
            specs += [
                ("ws_gate", [m + "shared_experts.gate_proj.weight",
                             m + "shared_expert.gate_proj.weight"], True),
                ("ws_up", [m + "shared_experts.up_proj.weight",
                           m + "shared_expert.up_proj.weight"], True),
                ("ws_down", [m + "shared_experts.down_proj.weight",
                             m + "shared_expert.down_proj.weight"], True),
            ]
    else:
        specs += [("w_gate", [m + "gate_proj.weight", o + "ff_proj.weight"], True),
                  ("w_up", [m + "up_proj.weight", o + "up_proj.weight"], True),
                  ("w_down", [m + "down_proj.weight", o + "ff_out.weight"], True)]
    return specs


# (our key, [per-expert templates], [stacked templates], transpose).
# Per-expert: one [out, in] matrix per expert (Bailing/Qwen-MoE; Mixtral's
# block_sparse_moe.{e}.w1/w3/w2 as aliases).  Stacked: one [E, out, in] (or
# fused [E·out, in]) tensor per layer.
def _expert_specs():
    m = "model.layers.{i}.mlp.experts.{e}."
    bs = "model.layers.{i}.block_sparse_moe.experts.{e}."
    st = "model.layers.{i}.mlp.experts."
    return [
        ("we_gate", [m + "gate_proj.weight", bs + "w1.weight"],
         [st + "gate_proj.weight", st + "gate_proj"], True),
        ("we_up", [m + "up_proj.weight", bs + "w3.weight"],
         [st + "up_proj.weight", st + "up_proj"], True),
        ("we_down", [m + "down_proj.weight", bs + "w2.weight"],
         [st + "down_proj.weight", st + "down_proj"], True),
    ]


def _normalize_stacked_experts(key: str, t: torch.Tensor,
                               cfg: ModelConfig) -> torch.Tensor:
    """Stacked [E, out, in] or fused [E·out, in] experts → [E, in, out]."""
    E, D, Fm = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    out_dim, in_dim = (Fm, D) if key in ("we_gate", "we_up") else (D, Fm)
    if t.ndim == 2:
        if tuple(t.shape) != (E * out_dim, in_dim):
            raise ValueError(f"fused expert tensor {key}: got {tuple(t.shape)}, "
                             f"expected ({E * out_dim}, {in_dim})")
        t = t.reshape(E, out_dim, in_dim)
    if tuple(t.shape) != (E, out_dim, in_dim):
        raise ValueError(f"stacked expert tensor {key}: got {tuple(t.shape)}, "
                         f"expected ({E}, {out_dim}, {in_dim})")
    return t.transpose(1, 2)


def _read_all_tensors(model_dir: Path) -> Dict[str, torch.Tensor]:
    index_path = model_dir / WEIGHTS_INDEX
    if index_path.exists():
        with open(index_path) as f:
            index = json.load(f)
        tensors: Dict[str, torch.Tensor] = {}
        for shard_name in sorted(set(index["weight_map"].values())):
            tensors.update(load_safetensors(model_dir / shard_name))
        return tensors
    single = model_dir / WEIGHTS_SINGLE
    if single.exists():
        return load_safetensors(single)
    raise FileNotFoundError(f"No {WEIGHTS_INDEX} or {WEIGHTS_SINGLE} in {model_dir}")


def _find(tensors, templates, **fmt):
    for t in templates:
        name = t.format(**fmt)
        if name in tensors:
            return tensors[name]
    return None


def load_checkpoint(model_dir: str | Path, dtype: Optional[str] = None,
                    device: DeviceLike = None) -> tuple[ModelConfig, dict]:
    """(config, params) from an HF-layout checkpoint directory, on
    ``device`` in ``dtype`` (default: the config's)."""
    model_dir = Path(model_dir)
    dev = resolve_device(device)
    cfg = config_from_hf(model_dir / "config.json", name=model_dir.name)
    target = dtype or cfg.dtype
    dt = DTYPES[target]
    cfg = cfg.replace(dtype=target)  # the config names the loaded dtype
    tensors = _read_all_tensors(model_dir)

    def fetch(key, templates, transpose, **fmt):
        t = _find(tensors, templates, **fmt)
        if t is None:
            raise KeyError(f"checkpoint missing {key} {fmt or ''} (tried {templates})")
        return t.T if transpose and t.ndim == 2 else t

    def stack(parts):
        return torch.stack(list(parts)).to(device=dev, dtype=dt).contiguous()

    params: dict = {"blocks": {}}
    for key, templates, tp in _global_specs(cfg):
        params[key] = fetch(key, templates, tp).to(device=dev, dtype=dt).contiguous()
    blocks = params["blocks"]
    for key, templates, tp in _layer_specs(cfg):
        blocks[key] = stack(fetch(key, templates, tp, i=i)
                            for i in range(cfg.num_layers))
    if cfg.is_moe:
        for key, templates, stacked_templates, tp in _expert_specs():
            if _find(tensors, templates, i=0, e=0) is not None:
                blocks[key] = stack(
                    torch.stack([fetch(key, templates, tp, i=i, e=e)
                                 for e in range(cfg.num_experts)])
                    for i in range(cfg.num_layers))
                continue
            layers = []
            for i in range(cfg.num_layers):
                t = _find(tensors, stacked_templates, i=i)
                if t is None:
                    raise KeyError(
                        f"checkpoint missing {key} layer {i} in any layout "
                        f"(per-expert {templates}, stacked {stacked_templates})")
                layers.append(_normalize_stacked_experts(key, t, cfg))
            blocks[key] = stack(layers)
    return cfg, params


def flatten_to_hf(cfg: ModelConfig, params: dict) -> Dict[str, torch.Tensor]:
    """Our params → flat {canonical HF name: [out, in] tensor} (views on the
    params' device; the writer copies each to the host)."""
    def conv(t, transpose):
        return t.T if transpose and t.ndim == 2 else t

    out: Dict[str, torch.Tensor] = {}
    for key, templates, tp in _global_specs(cfg):
        out[templates[0]] = conv(params[key], tp)
    for key, templates, tp in _layer_specs(cfg):
        stacked = params["blocks"][key]
        for i in range(cfg.num_layers):
            out[templates[0].format(i=i)] = conv(stacked[i], tp)
    if cfg.is_moe:
        for key, templates, _stacked, tp in _expert_specs():
            stacked = params["blocks"][key]
            for i in range(cfg.num_layers):
                for e in range(cfg.num_experts):
                    out[templates[0].format(i=i, e=e)] = conv(stacked[i, e], tp)
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


def _write_shards(model_dir: Path, flat: Dict[str, torch.Tensor],
                  max_shard_size: int, fmt: str) -> None:
    shards = list(shard_tensors(flat, max_shard_size))
    if len(shards) == 1:
        save_safetensors(model_dir / WEIGHTS_SINGLE, shards[0],
                         metadata={"format": fmt})
        return
    weight_map = {}
    total = 0
    for n, shard in enumerate(shards, start=1):
        shard_name = f"model-{n:05d}-of-{len(shards):05d}.safetensors"
        save_safetensors(model_dir / shard_name, shard, metadata={"format": fmt})
        for name, t in shard.items():
            weight_map[name] = shard_name
            total += t.numel() * t.element_size()
    with open(model_dir / WEIGHTS_INDEX, "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)


def save_checkpoint(model_dir: str | Path, cfg: ModelConfig, params: dict,
                    max_shard_size: int = 1 << 30) -> None:
    """Export to HF layout: config.json + sharded safetensors + index."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    _write_shards(model_dir, flatten_to_hf(cfg, params), max_shard_size, "pt")
    with open(model_dir / "config.json", "w") as f:
        json.dump(_hf_config_dict(cfg), f, indent=2)


_QUANT_MARKER = "ctdb_quant"


def save_quantized_checkpoint(model_dir: str | Path, cfg: ModelConfig,
                              qparams: dict, max_shard_size: int = 1 << 30) -> None:
    """Write a quantized parameter tree as an int8 serving checkpoint."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    flat: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            flat[prefix] = node

    walk("", qparams)
    _write_shards(model_dir, flat, max_shard_size, "ctdb-int8")
    d = _hf_config_dict(cfg)
    d[_QUANT_MARKER] = "int8"
    with open(model_dir / "config.json", "w") as f:
        json.dump(d, f, indent=2)


def is_quantized_checkpoint(model_dir: str | Path) -> bool:
    cfg_path = Path(model_dir) / "config.json"
    if not cfg_path.exists():
        return False
    with open(cfg_path) as f:
        return json.load(f).get(_QUANT_MARKER) == "int8"


def load_quantized_checkpoint(model_dir: str | Path,
                              device: DeviceLike = None) -> tuple[ModelConfig, dict]:
    """An int8 serving checkpoint back into its ``{q, s}`` tree on ``device``."""
    model_dir = Path(model_dir)
    dev = resolve_device(device)
    cfg = config_from_hf(model_dir / "config.json", name=model_dir.name)
    params: dict = {}
    for name, t in _read_all_tensors(model_dir).items():
        node = params
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.to(dev)
    return cfg, params
