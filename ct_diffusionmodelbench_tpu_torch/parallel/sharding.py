"""Parameter sharding rules (megatron tensor parallelism + data-parallel
batches + sequence-parallel slices) and the sharded forward.

Counterpart of ``parallel/sharding.py``.  :func:`param_specs` is the
reference's tree, each leaf the dimension that shards over ``model`` (None:
replicated):

- Q/K/V projections column-parallel over attention heads, the output
  projection row-parallel: one all-reduce per attention block.
- MLP gate/up column-parallel over the hidden, down row-parallel: one
  all-reduce per FFN.
- MoE: the routed experts shard over ``model`` (expert parallelism); the
  router replicates; the shared expert splits column / row.
- Embedding and LM head shard over the vocabulary; norms replicate.

GSPMD may split a dimension mid-head; the port cannot.  Where a group of
dimensions does not divide the model axis (:func:`tp_plan`: the tiny
presets' 2 kv heads at tp 4, Dream's 28 heads at tp 8), that part runs
replicated on every rank of the model group: the same numbers, and the
same choice on every rank, so no rank skips a collective another takes.
:func:`local_specs` is that effective tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import numpy as np

from ct_diffusionmodelbench_tpu_torch.parallel.comm import all_gather
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, use_mesh

if TYPE_CHECKING:
    from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig


@dataclass(frozen=True)
class TPPlan:
    """Which parts of the model split over ``model`` at this tp."""
    tp: int
    attn: bool
    ffn: bool
    experts: bool
    shared: bool
    vocab: bool


def tp_plan(cfg: "ModelConfig", tp: int) -> TPPlan:
    fs = cfg.moe_intermediate_size * cfg.num_shared_experts
    return TPPlan(
        tp=tp,
        attn=tp > 1 and cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0,
        ffn=tp > 1 and not cfg.is_moe and cfg.intermediate_size % tp == 0,
        experts=tp > 1 and cfg.is_moe and cfg.num_experts % tp == 0,
        shared=tp > 1 and cfg.is_moe and fs > 0 and fs % tp == 0,
        vocab=tp > 1 and cfg.vocab_size % tp == 0)


def param_specs(cfg: "ModelConfig") -> dict:
    """The reference's tree: per leaf, the dimension sharded over
    ``model``, or None."""
    blocks = {"attn_norm": None, "wq": 2, "wk": 2, "wv": 2, "wo": 1,
              "ffn_norm": None}
    if cfg.attention_bias:
        blocks.update(bq=1, bk=1, bv=1)
    if cfg.qk_norm:
        blocks.update(q_norm=None, k_norm=None)
    if cfg.is_moe:
        blocks.update(router=None, we_gate=1, we_up=1, we_down=1)
        if cfg.num_shared_experts:
            blocks.update(ws_gate=2, ws_up=2, ws_down=1)
    else:
        blocks.update(w_gate=2, w_up=2, w_down=1)
    specs = {"embed": 0, "blocks": blocks, "final_norm": None}
    if not cfg.tie_embeddings:
        specs["lm_head"] = 1
    return specs


_GROUP = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn", "bq": "attn",
          "bk": "attn", "bv": "attn", "w_gate": "ffn", "w_up": "ffn",
          "w_down": "ffn", "we_gate": "experts", "we_up": "experts",
          "we_down": "experts", "ws_gate": "shared", "ws_up": "shared",
          "ws_down": "shared", "embed": "vocab", "lm_head": "vocab"}


def local_specs(cfg: "ModelConfig", tp: int) -> dict:
    """:func:`param_specs` with the parts :func:`tp_plan` replicates at
    ``tp`` set to None."""
    plan = tp_plan(cfg, tp)

    def eff(name, dim):
        return dim if dim is not None and getattr(plan, _GROUP[name]) else None

    specs = param_specs(cfg)
    out = {k: eff(k, v) for k, v in specs.items() if k != "blocks"}
    out["blocks"] = {k: eff(k, v) for k, v in specs["blocks"].items()}
    return out


def leaf_dims(cfg: "ModelConfig", tp: int) -> dict:
    """{leaf name: sharded dim} of the leaves that shard at ``tp``, by the
    bare name (``wq``, ``embed``), as ``init_params``' leaf transform names
    them."""
    specs = local_specs(cfg, tp)
    flat = {k: v for k, v in specs["blocks"].items()}
    flat.update({k: v for k, v in specs.items() if k != "blocks"})
    return {k: v for k, v in flat.items() if v is not None}


def data_spec() -> tuple:
    """The batch's layout: its first dimension over ``data``."""
    return (DATA_AXIS,)


def shard_leaf(t, dim: Optional[int], mesh: Mesh):
    """This rank's slice of a full leaf (numpy or tensor) along ``dim``."""
    if dim is None or mesh.model == 1:
        return t
    n = t.shape[dim] // mesh.model
    lo = mesh.model_rank * n
    if isinstance(t, np.ndarray):
        return np.take(t, np.arange(lo, lo + n), axis=dim)
    return t.narrow(dim, lo, n).clone()


def _map_specs(fn, params: dict, specs: dict) -> dict:
    out = {}
    for k, v in params.items():
        out[k] = (_map_specs(fn, v, specs[k]) if isinstance(v, dict)
                  else fn(v, specs[k]))
    return out


def shard_params(cfg: "ModelConfig", params: dict, mesh: Mesh) -> dict:
    """This rank's shard of a full parameter tree, on its device: each leaf
    sliced along its :func:`local_specs` dimension, then moved (a leaf on
    the host is sliced before it moves)."""
    specs = local_specs(cfg, mesh.model)
    return _map_specs(lambda t, d: shard_leaf(t, d, mesh).to(mesh.device),
                      params, specs)


def init_sharded_params(cfg: "ModelConfig", seed: int, mesh: Mesh) -> dict:
    """``init_params(cfg, seed)`` sliced to this rank, drawn leaf by leaf on
    its device: each full leaf is drawn (the same draws as the one-rank
    init), sliced and freed before the next, so a rank never holds the full
    model."""
    from ct_diffusionmodelbench_tpu_torch.models.transformer import init_params

    dims = leaf_dims(cfg, mesh.model)
    params = init_params(cfg, seed=seed, device=mesh.device,
                         leaf_transform=lambda n, t: shard_leaf(t, dims.get(n), mesh))
    blocks = params["blocks"]
    for k in ("bq", "bk", "bv"):   # zeros, not drawn by the transform
        if k in blocks:
            blocks[k] = shard_leaf(blocks[k], dims.get(k), mesh)
    return params


def gather_params(cfg: "ModelConfig", params: dict, mesh: Mesh) -> dict:
    """The full tree from the model group's shards (a collective over the
    model group: every rank of it must call it)."""
    specs = local_specs(cfg, mesh.model)
    return _map_specs(
        lambda t, d: t if d is None else all_gather(t, mesh.model_group, mesh, d),
        params, specs)


def make_sharded_forward(cfg: "ModelConfig", mesh: Mesh, remat=False,
                         attn_impl: str = "auto"):
    """``f(params, input_ids, attn_mask=None, logit_start=None,
    logit_length=None) -> (logits, aux)`` on this rank's shard of the
    parameters (:func:`shard_params`; replicated over ``seq``).

    ``input_ids`` is the whole batch, on every rank.  When B divides by
    ``data``, each data rank runs its own rows and the logits are gathered
    over ``data``; otherwise every rank runs the whole batch (TP stays on,
    DP idles), as the reference's wrapper.  Under a ``seq`` axis each seq
    rank runs its slice of the sequence (ring attention) and the logits are
    gathered over ``seq``, unless the length does not divide by ``seq``:
    then every seq rank runs the whole sequence, as the reference's
    ``seq_ax = None``.  Every rank returns the whole batch's full-vocab
    logits and the aux loss of the whole batch."""
    from ct_diffusionmodelbench_tpu_torch.models.transformer import forward

    cfg = cfg.replace(attn_impl=attn_impl)

    def fn(params, input_ids, attn_mask=None, logit_start=None, logit_length=None):
        b, s = input_ids.shape
        rows = mesh.rows(b)
        split = rows is not None
        seq_split = mesh.seq > 1 and s % mesh.seq == 0
        ids = input_ids.to(mesh.device)
        mask = None if attn_mask is None else attn_mask.to(mesh.device)
        if split:
            ids = ids[rows]
            mask = None if mask is None else mask[rows]
        if seq_split:
            pos = mesh.seq_slice(s)
            ids = ids[:, pos]
            mask = None if mask is None else mask[:, pos]
        with use_mesh(mesh, batch=b if split else None, global_aux=split or seq_split,
                      seq_len=s if seq_split else None):
            logits, aux = forward(cfg, params, ids, attn_mask=mask,
                                  logit_start=logit_start,
                                  logit_length=logit_length, remat=remat)
        if seq_split and logit_start is None:
            logits = all_gather(logits, mesh.seq_group, mesh, dim=1)
        if split:
            logits = all_gather(logits, mesh.data_group, mesh, dim=0)
        return logits, aux

    return fn
