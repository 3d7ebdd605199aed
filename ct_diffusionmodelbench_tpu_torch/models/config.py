"""Model configuration for the masked-diffusion transformer family.

One config-driven module family covers every checkpoint the reference loads
(SURVEY.md §2.5):

- ``GSAI-ML/LLaDA-8B-Instruct``       — dense, LLaMA-style, bidirectional.
- ``inclusionAI/LLaDA-MoE-7B-A1B``    — sparse MoE, bidirectional.
- ``Dream-org/Dream-Coder-v0-7B``     — Qwen2.5-derived (GQA + QKV bias),
                                        bidirectional, *shifted* logits.
- ``apple/DiffuCoder-7B-Instruct``    — Qwen2.5-derived like Dream.
- ``JetLM/SDAR-30B-A3B-Chat``         — Qwen3-MoE (128 experts top-8, no
                                        shared expert, qk-norm), decoded by
                                        block diffusion: block-causal
                                        attention over an exact KV cache
                                        (port only: the JAX package has no
                                        such family).
- ``kakaocorp/kanana-2-30b-a3b-instruct-2601`` — DeepSeek-V3 layers
                                        (model_type ``deepseek_v3``):
                                        multi-head latent attention,
                                        a dense first layer, then 128
                                        sigmoid-routed experts top-6 with
                                        two shared; decoded by the SDAR
                                        family's block diffusion over a
                                        latent cache (port only).

PyTorch port's own copy of ``ct_diffusionmodelbench_tpu/models/config.py``
(the port imports nothing of the JAX package).  Fields, presets and the
analytic counts are kept identical to the JAX module, which the port's tests
check field by field, but for what the SDAR family adds: the
``block_length`` field (0 for every other family), the latent-attention
and sigmoid-router fields of :data:`PORT_ONLY_FIELDS` (their defaults for
every other model) and the presets of :data:`PORT_ONLY_PRESETS`.  Real
checkpoints carry their own ``config.json``, parsed by
:func:`config_from_hf`; preset dims only matter when initializing from
scratch.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str = "llada-tiny"
    vocab_size: int = 126464
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    intermediate_size: int = 12288
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_seq_len: int = 4096
    attention_bias: bool = False      # Qwen-style bias on Q/K/V projections
    qk_norm: bool = False             # per-head RMSNorm on q and k
    tie_embeddings: bool = False
    logit_shift: bool = False         # Dream/DiffuCoder: logits shifted right by
                                      # one (AR-initialized diffusion models
                                      # predict token i from position i-1)
    causal: bool = False              # autoregressive baseline models (the
                                      # reference's LLaDOU / chat_base_model
                                      # path uses plain HF generate; diffusion
                                      # models are always bidirectional)
    family: str = ""                  # explicit sampler-family dispatch:
                                      # llada | llada-moe | dream | diffucoder
                                      # | sdar
                                      # ("" = infer from is_moe/logit_shift —
                                      # the dream-vs-diffucoder split then
                                      # falls back to a name heuristic)
    # MoE (0 experts = dense FFN)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0
    norm_topk_prob: bool = True
    router_aux_coef: float = 0.01     # aux-loss weight used by the trainer
                                      # (Training/Training_0to1k/train.py:310)
    # Special ids (mask-id resolution chain lives in io/tokenizer.py)
    mask_token_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    pad_token_id: Optional[int] = None
    # Compute policy
    dtype: str = "bfloat16"           # parameter/activation dtype
    attn_impl: str = "auto"           # auto | flash | reference
    block_length: int = 0             # sdar: attention is block-causal over
                                      # blocks of this many positions (0:
                                      # every other family, bidirectional)
    # Multi-head latent attention (DeepSeek-V3's; kv_lora_rank 0 = off):
    # q = x Wq split into qk_nope_head_dim + qk_rope_head_dim per head; one
    # latent c = RMSNorm(x Wkv_a[:rank]) of kv_lora_rank and one rope key of
    # qk_rope_head_dim shared by every head; c Wkv_b gives each head's
    # nope key and v_head_dim value.  rope_interleave: the published rope
    # dims pair (2i, 2i + 1) (the loader permutes them into halves,
    # models/mla.py).  A low-rank q (config.json's q_lora_rank) is refused.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_interleave: bool = False
    # Router: "softmax" (top-k of the softmax) or "sigmoid" (top-k of the
    # sigmoid scores plus a per-expert selection bias, weights the chosen
    # unbiased scores, renormalized, times routed_scaling_factor:
    # DeepSeek-V3's topk_method "noaux_tc" with one group).
    scoring_func: str = "softmax"
    routed_scaling_factor: float = 1.0
    first_k_dense_replace: int = 0    # MoE models: the first k layers dense

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def rope_dim(self) -> int:
        """The rotated dims of a head: the rope part under MLA."""
        return self.qk_rope_head_dim if self.is_mla else self.head_dim

    @property
    def dense_layers(self) -> int:
        """Leading layers with a dense FFN in an MoE model."""
        return self.first_k_dense_replace if self.is_moe else 0

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def _mla_attn_params(self) -> int:
        d, h, r = self.hidden_size, self.num_heads, self.kv_lora_rank
        return (d * h * self.qk_head_dim + d * (r + self.qk_rope_head_dim) + r
                + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                + h * self.v_head_dim * d)

    def param_count(self) -> int:
        """Analytic parameter count (for logging / memory planning)."""
        d, f = self.hidden_size, self.intermediate_size
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_mla:
            k = self.dense_layers
            moe = (self.num_experts + self.num_shared_experts) * 3 * d * self.moe_intermediate_size
            moe += d * self.num_experts
            moe += self.num_experts if self.scoring_func == "sigmoid" else 0   # the bias
            per_layer = self._mla_attn_params() + 2 * d
            return (embed + self.num_layers * per_layer + k * 3 * d * f
                    + (self.num_layers - k) * moe + d)
        attn = d * self.q_size + 2 * d * self.kv_size + self.q_size * d
        if self.attention_bias:
            attn += self.q_size + 2 * self.kv_size
        if self.qk_norm:
            attn += 2 * self.head_dim
        if self.is_moe:
            fm = self.moe_intermediate_size
            ffn = self.num_experts * 3 * d * fm + d * self.num_experts
            if self.num_shared_experts:
                ffn += self.num_shared_experts * 3 * d * fm
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return embed + self.num_layers * per_layer + d

    def active_param_count(self) -> int:
        """Parameters touched per token: MoE counts only the top-k routed +
        shared experts (the reference's "A1B" figure); dense = param_count."""
        if not self.is_moe:
            return self.param_count()
        d, fm = self.hidden_size, self.moe_intermediate_size
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.is_mla:
            k = self.dense_layers
            moe = (self.num_experts_per_tok + self.num_shared_experts) * 3 * d * fm
            moe += d * self.num_experts
            return (embed + self.num_layers * (self._mla_attn_params() + 2 * d)
                    + k * 3 * d * self.intermediate_size + (self.num_layers - k) * moe + d)
        attn = d * self.q_size + 2 * d * self.kv_size + self.q_size * d
        if self.attention_bias:
            attn += self.q_size + 2 * self.kv_size
        if self.qk_norm:
            attn += 2 * self.head_dim
        ffn = (self.num_experts_per_tok + self.num_shared_experts) * 3 * d * fm
        ffn += d * self.num_experts  # router
        return embed + self.num_layers * (attn + ffn + 2 * d) + d

    def forward_flops(self, seq_len: int, lm_head_width: Optional[int] = None) -> float:
        """Analytic FLOPs of ONE forward pass over ``seq_len`` tokens
        (matmuls only, 2·m·n·k convention), for MFU reporting.

        ``lm_head_width``: tokens whose logits are actually computed — the
        LLaDA sampler's block-sliced head evaluates only the active block
        (sampling/llada.py), so pass ``block_length`` there; None = full
        width (Dream/training)."""
        d, S = self.hidden_size, seq_len
        head_w = lm_head_width if lm_head_width is not None else S
        lm_head = 2 * head_w * d * self.vocab_size
        if self.is_mla:
            # The up-projected form; the leading dense layers' FFN apart.
            h, qk, v = self.num_heads, self.qk_head_dim, self.v_head_dim
            attn = 2 * S * self._mla_attn_params() + 2 * S * S * h * (qk + v)
            fm, k = self.moe_intermediate_size, self.dense_layers
            moe = 2 * S * (3 * d * fm * (self.num_experts_per_tok + self.num_shared_experts)
                           + d * self.num_experts)
            dense = 2 * S * 3 * d * self.intermediate_size
            return float(self.num_layers * attn + k * dense + (self.num_layers - k) * moe
                         + lm_head)
        attn_proj = 2 * S * (d * self.q_size + 2 * d * self.kv_size
                             + self.q_size * d)
        attn_mix = 4 * S * S * self.q_size  # scores + weighted sum
        if self.is_moe:
            fm = self.moe_intermediate_size
            ffn = 2 * S * 3 * d * fm * (self.num_experts_per_tok
                                        + self.num_shared_experts)
            ffn += 2 * S * d * self.num_experts  # router
        else:
            ffn = 2 * S * 3 * d * self.intermediate_size
        return float(self.num_layers * (attn_proj + attn_mix + ffn) + lm_head)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------
# Full-size dims follow the published checkpoint configs; presets are only the
# from-scratch defaults.

PRESETS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    PRESETS[cfg.name] = cfg
    return cfg


# GSAI-ML/LLaDA-8B-Instruct: 32L/32H, d=4096, ffn=12288, vocab=126464,
# mask id 126336 (Training/Training_0to1k/Llada_MoE/train_fast_save.py:75).
_register(ModelConfig(
    name="llada-8b", family="llada",
    vocab_size=126464, hidden_size=4096, num_layers=32, num_heads=32,
    num_kv_heads=32, head_dim=128, intermediate_size=12288,
    rope_theta=500000.0, mask_token_id=126336, eos_token_id=126081,
))

# inclusionAI/LLaDA-MoE-7B-A1B-Instruct: 64 routed experts top-8 + one shared
# expert; mask id 156895.  18 layers x moe_intermediate 896 gives 7.27B total /
# 1.08B active non-embedding parameters (13.7 GiB in bf16).  A real
# config.json wins at load time.
_register(ModelConfig(
    name="llada-moe-7b", family="llada-moe",
    vocab_size=157184, hidden_size=2048, num_layers=18, num_heads=16,
    num_kv_heads=4, head_dim=128, intermediate_size=5632,
    num_experts=64, num_experts_per_tok=8, moe_intermediate_size=896,
    num_shared_experts=1, rope_theta=600000.0, mask_token_id=156895,
    attention_bias=False, qk_norm=True,
))

# Dream-org/Dream-Coder-v0-Instruct-7B: Qwen2.5-7B-derived — 28L, 28 q heads,
# 4 kv heads, d=3584, ffn=18944, QKV bias, shifted logits
# (sampler wrapper: Pre-Trained/bench_models/dream.py:70-110).
_register(ModelConfig(
    name="dream-7b", family="dream",
    vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
    num_kv_heads=4, head_dim=128, intermediate_size=18944,
    attention_bias=True, rope_theta=1000000.0, logit_shift=True,
    mask_token_id=151666, eos_token_id=151643,
))

# apple/DiffuCoder-7B-Instruct / -cpGRPO: same Qwen2.5-7B-derived skeleton as
# Dream (Pre-Trained/bench_models/diffucoder.py:68-102 uses the identical
# diffusion_generate interface and `<|dlm_pad|>` padding token).
_register(PRESETS["dream-7b"].replace(name="diffucoder-7b", family="diffucoder"))

# Scale-down of llada-moe-7b: same D/heads/top-8-of-64/shared expert, with
# 16 layers x Fm=768 (5.72B total / 1.49B active).
_register(ModelConfig(
    name="llada-moe-bench1chip", family="llada-moe",
    vocab_size=157184, hidden_size=2048, num_layers=16, num_heads=16,
    num_kv_heads=4, head_dim=128, intermediate_size=5632,
    num_experts=64, num_experts_per_tok=8, moe_intermediate_size=768,
    num_shared_experts=1, rope_theta=600000.0, mask_token_id=156895,
    attention_bias=False, qk_norm=True,
))

# Scale-down of the 8B dense model: same architecture at D=2048, 22 layers.
_register(ModelConfig(
    name="llada-2b", family="llada",
    vocab_size=126464, hidden_size=2048, num_layers=22, num_heads=16,
    num_kv_heads=16, head_dim=128, intermediate_size=5632,
    rope_theta=500000.0, mask_token_id=126336, eos_token_id=126081,
))

# Tiny configs for tests / CI (CPU-friendly).
_register(ModelConfig(
    name="llada-tiny", family="llada",
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=4, head_dim=16, intermediate_size=128,
    rope_theta=10000.0, mask_token_id=500, eos_token_id=2, max_seq_len=512,
))
_register(ModelConfig(
    name="llada-moe-tiny", family="llada-moe",
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=128,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
    num_shared_experts=1, qk_norm=True,
    rope_theta=10000.0, mask_token_id=500, eos_token_id=2, max_seq_len=512,
))
_register(ModelConfig(
    name="dream-tiny", family="dream",
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=128,
    attention_bias=True, logit_shift=True,
    rope_theta=10000.0, mask_token_id=500, eos_token_id=2, max_seq_len=512,
))

SDAR_BLOCK_LENGTH = 4   # SDAR's inference block length; config.json gives none

# JetLM/SDAR-30B-A3B-Chat (config.json: model_type sdar_moe): a Qwen3-MoE
# decoder, 48 layers, D 2048, 32 query / 4 kv heads of 128 with per-head
# RMSNorm on q and k, 128 routed experts top-8 of width 768 with
# norm_topk_prob and no shared expert, vocab 151936, untied head, theta 1e6.
# The config gives no block length: 4 is SDAR's own inference setting.  The
# mask id is SDAR's added <|MASK|> token, the EOS Qwen3's <|im_end|>.
_register(ModelConfig(
    name="sdar-30b-a3b", family="sdar",
    vocab_size=151936, hidden_size=2048, num_layers=48, num_heads=32,
    num_kv_heads=4, head_dim=128, intermediate_size=6144,
    num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
    num_shared_experts=0, norm_eps=1e-6, rope_theta=1000000.0,
    max_seq_len=32768, qk_norm=True, block_length=SDAR_BLOCK_LENGTH,
    mask_token_id=151669, eos_token_id=151645,
))
_register(ModelConfig(
    name="sdar-tiny", family="sdar",
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=128,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
    num_shared_experts=0, norm_eps=1e-6, qk_norm=True, block_length=SDAR_BLOCK_LENGTH,
    rope_theta=10000.0, mask_token_id=500, eos_token_id=2, max_seq_len=512,
))

# kakaocorp/kanana-2-30b-a3b-instruct-2601 (config.json: model_type
# deepseek_v3): 48 layers, D 2048, vocab 128256, multi-head latent attention
# over 32 heads with no q_lora (q 128 nope + 64 rope dims, latent 512, one
# interleaved rope key of 64, v 128), layer 0 a dense SwiGLU of 6144, layers
# 1-47 128 routed experts of 768, top-6 by sigmoid scores plus a selection
# bias (noaux_tc, one group), renormalized, times 2.448, and two shared
# experts (one SwiGLU of 1536); theta 1e6, no rope scaling.  Published as an
# autoregressive model, it runs here through the SDAR family's block
# diffusion (block length 4); the tokenizer names no mask token, so the
# mask and EOS ids are assumed (portbench/configs/kanana-2-30b-a3b.json).
_register(ModelConfig(
    name="kanana-2-30b-a3b", family="sdar",
    vocab_size=128256, hidden_size=2048, num_layers=48, num_heads=32,
    num_kv_heads=32, head_dim=64, intermediate_size=6144,
    num_experts=128, num_experts_per_tok=6, moe_intermediate_size=768,
    num_shared_experts=2, norm_eps=1e-6, rope_theta=1000000.0,
    max_seq_len=32768, block_length=SDAR_BLOCK_LENGTH,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    rope_interleave=True, scoring_func="sigmoid",
    routed_scaling_factor=2.448, first_k_dense_replace=1,
    mask_token_id=128255, eos_token_id=128001,
))
_register(ModelConfig(
    name="mla-tiny", family="sdar",
    vocab_size=512, hidden_size=64, num_layers=3, num_heads=4,
    num_kv_heads=4, head_dim=16, intermediate_size=128,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
    num_shared_experts=1, norm_eps=1e-6, block_length=SDAR_BLOCK_LENGTH,
    kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
    rope_interleave=True, scoring_func="sigmoid",
    routed_scaling_factor=2.448, first_k_dense_replace=1,
    rope_theta=10000.0, mask_token_id=500, eos_token_id=2, max_seq_len=512,
))

# The presets that only the port has (the JAX package has no SDAR family).
PORT_ONLY_PRESETS = ("sdar-30b-a3b", "sdar-tiny", "kanana-2-30b-a3b", "mla-tiny")
# The fields that only the port has, beside block_length: latent attention
# and the sigmoid router.  Every config the JAX package can make keeps
# their defaults.
PORT_ONLY_FIELDS = ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                    "v_head_dim", "rope_interleave", "scoring_func",
                    "routed_scaling_factor", "first_k_dense_replace")


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"Unknown model preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg


# ---------------------------------------------------------------------------
# HF config.json interop
# ---------------------------------------------------------------------------

def config_from_hf(config: dict[str, Any] | str | Path, name: str = "") -> ModelConfig:
    """Build a :class:`ModelConfig` from an HF ``config.json``.

    Covers the config vocabularies of the four checkpoint families the
    reference loads (SURVEY.md §2.5): LLaMA/LLaDA-style keys
    (``num_hidden_layers``, ``num_attention_heads``, ...), Qwen2/Dream keys,
    and Bailing/LLaDA-MoE keys (``num_experts``, ``moe_intermediate_size``).
    ``model_type`` ``sdar_moe`` (SDAR, Qwen3-MoE keys) gives family ``sdar``:
    qk-norm on (Qwen3's, which no key names), no shared expert (the config
    has none), and ``block_length`` from the config or SDAR's 4.
    ``model_type`` ``deepseek_v3`` with a ``block_length`` key (a port-only
    key: the published config has none) gives family ``sdar`` too, with
    DeepSeek-V3's latent attention, sigmoid router and leading dense
    layers; without ``block_length`` it is refused (the port decodes it by
    block diffusion alone), as is a ``q_lora_rank``.
    """
    if not isinstance(config, dict):
        with open(config) as f:
            config = json.load(f)

    def pick(*keys, default=None):
        for k in keys:
            if k in config and config[k] is not None:
                return config[k]
        return default

    hidden = pick("hidden_size", "d_model", default=4096)
    n_heads = pick("num_attention_heads", "n_heads", default=32)
    head_dim = pick("head_dim", default=hidden // n_heads)
    model_type = str(pick("model_type", default="")).lower()
    logit_shift = model_type in ("dream", "diffucoder") or bool(pick("logit_shift", default=False))
    n_experts = pick("num_experts", "n_routed_experts", default=0) or 0
    mla = model_type == "deepseek_v3"
    if mla and pick("block_length") is None:
        raise NotImplementedError("deepseek_v3 runs in the port as a block-diffusion "
                                  "(SDAR family) model: give a block_length")
    if mla and pick("q_lora_rank"):
        raise NotImplementedError("latent attention with a low-rank q (q_lora_rank) "
                                  "is not supported")
    if mla and (pick("n_group", default=1) > 1 or pick("topk_group", default=1) > 1):
        raise NotImplementedError("group-limited routing (n_group > 1) is not supported")
    sdar = model_type.startswith("sdar") or mla
    # Explicit family dispatch from model_type (falls back to "" → the
    # is_moe/logit_shift inference in eval/runner.py::infer_family).
    if sdar:
        family = "sdar"
    elif "diffucoder" in model_type:
        family = "diffucoder"
    elif "dream" in model_type:
        family = "dream"
    elif logit_shift:
        family = ""  # shifted-logit model of unknown type: let name decide
    elif model_type:
        family = "llada-moe" if n_experts else "llada"
    else:
        family = ""

    return ModelConfig(
        name=name or model_type or "hf-model",
        vocab_size=pick("vocab_size", default=126464),
        hidden_size=hidden,
        num_layers=pick("num_hidden_layers", "n_layers", default=32),
        num_heads=n_heads,
        num_kv_heads=pick("num_key_value_heads", "n_kv_heads", default=n_heads),
        head_dim=head_dim,
        intermediate_size=pick("intermediate_size", "mlp_hidden_size", default=4 * hidden),
        norm_eps=pick("rms_norm_eps", "layer_norm_eps", "rms_norm_epsilon", default=1e-5),
        rope_theta=pick("rope_theta", "rotary_emb_base", default=10000.0),
        max_seq_len=pick("max_position_embeddings", "max_sequence_length", default=4096),
        attention_bias=bool(pick("attention_bias", "qkv_bias", "use_bias",
                                 default=model_type in ("dream", "qwen2", "diffucoder"))),
        qk_norm=(sdar and not mla) or bool(pick("use_qk_norm", "qk_layernorm", "use_qkv_norm",
                                  default=False)),
        tie_embeddings=bool(pick("tie_word_embeddings", "weight_tying", default=False)),
        logit_shift=logit_shift,
        family=family,
        num_experts=n_experts,
        num_experts_per_tok=pick("num_experts_per_tok", "num_experts_per_token", default=0) or 0,
        moe_intermediate_size=pick("moe_intermediate_size", default=0) or 0,
        num_shared_experts=pick("num_shared_experts", "n_shared_experts", default=0) or 0,
        norm_topk_prob=bool(pick("norm_topk_prob", default=True)),
        mask_token_id=pick("mask_token_id"),
        eos_token_id=_scalar(pick("eos_token_id")),
        pad_token_id=_scalar(pick("pad_token_id")),
        block_length=int(pick("block_length", default=SDAR_BLOCK_LENGTH)) if sdar else 0,
        **(_mla_fields(pick) if mla else {}),
    )


def _mla_fields(pick) -> dict:
    """The port-only fields of a deepseek_v3 ``config.json``."""
    return dict(
        kv_lora_rank=pick("kv_lora_rank"),
        qk_nope_head_dim=pick("qk_nope_head_dim"), qk_rope_head_dim=pick("qk_rope_head_dim"),
        v_head_dim=pick("v_head_dim"), rope_interleave=bool(pick("rope_interleave",
                                                                 default=False)),
        scoring_func=pick("scoring_func", default="softmax"),
        routed_scaling_factor=float(pick("routed_scaling_factor", default=1.0)),
        first_k_dense_replace=pick("first_k_dense_replace", default=0) or 0)


def _scalar(v):
    if isinstance(v, (list, tuple)):
        return v[0] if v else None
    return v
