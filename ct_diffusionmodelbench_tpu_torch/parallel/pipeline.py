"""Pipeline parallelism: GPipe microbatches through stages over a ``stage``
mesh axis.

Counterpart of ``parallel/pipeline.py``.  The leading ``[L, ...]`` layer
axis of every block leaf splits over ``stage``: stage ``st`` holds layers
[st·L/S, (st+1)·L/S).  ``M`` microbatches flow through the ``S`` stages in
``M + S - 1`` ticks; each tick a stage runs its layers on the microbatch it
holds and hands the result to the next stage (``parallel/comm.py::
exchange``, one batch of sends and receives a tick on every stage, each
send paired with the next stage's receive).  Unlike the reference's
``scan``, a stage idles through the fill and drain ticks instead of
computing masked garbage.  The mesh is (data, stage, model): the batch
splits over ``data`` inside each microbatch, as the reference's
``P(None, DATA_AXIS)`` on the [M, mb, ...] stack, and ``model > 1`` adds
megatron tensor parallelism within a stage for dense blocks (the port's
``models/transformer.py::block`` with a column / row plan).

The embedding, the final norm and the LM head are replicated on every
stage (the reference's ``pp_param_specs``): every stage embeds the tokens,
the last stage's hidden states are shared over ``stage`` (the reference's
``psum``), and every stage computes the norm, the head and the loss.

The backward is an explicit reverse schedule (:class:`_GPipe`), not
autograd's own order over the transfers: stages that issued their sends
and receives in different orders would deadlock.  Each stage keeps each
tick's (input, output) pair, receives its output's gradient from the next
stage, runs ``torch.autograd.backward`` on that tick's graph (the layer
parameters' gradients accumulate as it goes) and sends the input's
gradient to the previous stage.  The first stage's input gradient is
shared over ``stage`` too, so every stage backpropagates it into its own
embedding lookup: the embedding's, the final norm's and the head's
gradients are then the same on every stage and are not summed over it.
(Summing stage 0's lookup gradient over ``stage`` would move a V × D f32
tensor where this moves the [B, S, D] activations' gradient.)

The MoE load-balancing loss is computed per microbatch and stage, summed,
divided by L and M and averaged over ``data``: the reference's GPipe
approximation, copied as it is.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.parallel.comm import (
    all_gather, all_reduce_, exchange)
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import (
    STAGE_AXIS, Mesh, build_mesh, use_mesh)
from ct_diffusionmodelbench_tpu_torch.parallel.sharding import TPPlan, shard_leaf

__all__ = ["STAGE_AXIS", "make_pp_mesh", "pp_param_specs", "shard_params_pp",
           "init_pp_params", "gather_params_pp", "make_pp_forward",
           "PipelineForward"]

_COL = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW = ("wo", "w_down")
_VEC = ("bq", "bk", "bv")
_UNDRAWN = ("attn_norm", "ffn_norm", "q_norm", "k_norm") + _VEC


def make_pp_mesh(stages: int, data: int = 1, model: int = 1, device=None) -> Mesh:
    """This rank's (data, stage, model) mesh: rank = (d·stages + st)·model
    + m.  ``model > 1`` turns on TP within a stage (dense blocks only)."""
    return build_mesh(data, model, stage=stages, device=device)


def pp_param_specs(cfg: ModelConfig, tp: int = 1) -> dict:
    """Per leaf, (the dimension split over ``stage``, the dimension split
    over ``model``), None for replicated: every block leaf splits its layer
    axis over ``stage``; at ``tp > 1`` the QKV and FFN up-projections also
    split their output over ``model`` (column-parallel), ``wo`` / ``w_down``
    their input (row-parallel) and the QKV biases their heads.  The
    embedding, the final norm and the head replicate."""
    from ct_diffusionmodelbench_tpu_torch.parallel.sharding import param_specs

    def model_dim(k):
        if tp == 1:
            return None
        return 2 if k in _COL else 1 if k in _ROW + _VEC else None

    blocks = {k: (0, model_dim(k)) for k in param_specs(cfg)["blocks"]}
    specs = {"embed": (None, None), "blocks": blocks, "final_norm": (None, None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, None)
    return specs


def stage_leaf(t, spec, mesh: Mesh):
    """This rank's slice of a full leaf (numpy or tensor) under a
    :func:`pp_param_specs` entry."""
    stage_dim, model_dim = spec
    if stage_dim is not None and mesh.stage > 1:
        n = t.shape[0] // mesh.stage
        lo = mesh.stage_rank * n
        t = t[lo:lo + n]
    return shard_leaf(t, model_dim, mesh)


def shard_params_pp(cfg: ModelConfig, params: dict, mesh: Mesh) -> dict:
    """This rank's shard of a full parameter tree, on its device (a leaf on
    the host is sliced before it moves)."""
    specs = pp_param_specs(cfg, mesh.model)
    out = {k: stage_leaf(v, specs[k], mesh).to(mesh.device)
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: stage_leaf(v, specs["blocks"][k], mesh).contiguous().to(mesh.device)
                     for k, v in params["blocks"].items()}
    return out


def init_pp_params(cfg: ModelConfig, seed: int, mesh: Mesh) -> dict:
    """``init_params(cfg, seed)`` cut to this rank's stage and model shard,
    drawn leaf by leaf on its device (the one-process draws, sliced), so a
    rank never holds the other stages' layers."""
    from ct_diffusionmodelbench_tpu_torch.models.transformer import init_params

    specs = pp_param_specs(cfg, mesh.model)["blocks"]

    def mine(name, t):
        return stage_leaf(t, specs[name], mesh).contiguous() if name in specs else t

    params = init_params(cfg, seed=seed, device=mesh.device, leaf_transform=mine)
    blocks = params["blocks"]
    for k in _UNDRAWN:   # ones and zeros, not drawn by the transform
        if k in blocks:
            blocks[k] = stage_leaf(blocks[k], specs[k], mesh).contiguous()
    return params


def gather_leaf(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The full leaf from the shards: gathered over ``model`` (every rank of
    the stage's model group calls it), then over ``stage``."""
    stage_dim, model_dim = spec
    if model_dim is not None and mesh.model > 1:
        t = all_gather(t, mesh.model_group, mesh, model_dim)
    if stage_dim is not None and mesh.stage > 1:
        t = all_gather(t, mesh.stage_group, mesh, stage_dim)
    return t


def gather_params_pp(cfg: ModelConfig, params: dict, mesh: Mesh) -> dict:
    """The full tree from the shards (collective over the data rank's
    stage and model groups)."""
    specs = pp_param_specs(cfg, mesh.model)
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: gather_leaf(v, specs["blocks"][k], mesh)
                     for k, v in params["blocks"].items()}
    return out


def validate(cfg: ModelConfig, stages: int, tp: int) -> None:
    """The reference's checks of a pipeline layout."""
    if cfg.num_layers % stages:
        raise ValueError(
            f"num_layers={cfg.num_layers} must divide by stages={stages}")
    if tp > 1:
        if cfg.is_moe:
            raise ValueError(
                "TP-within-stage supports dense blocks only — MoE expert "
                "parallelism lives on the sharded path (parallel/sharding.py)")
        if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
            raise ValueError(
                f"tp={tp} must divide num_heads={cfg.num_heads}, "
                f"num_kv_heads={cfg.num_kv_heads} and "
                f"intermediate_size={cfg.intermediate_size}")


class _GPipe(torch.autograd.Function):
    """The stage loop (forward schedule) and its reverse schedule."""

    @staticmethod
    def forward(ctx, x, pipe, params, cos, sin, mask):
        mesh, m = pipe.mesh, pipe.m
        stages, sid = mesh.stage, mesh.stage_rank
        grad = ctx.needs_input_grad[0]
        b, s, d = x.shape
        mb = b // m
        xs = x.detach().reshape(m, mb, s, d)
        pick = [(cos[i * mb:(i + 1) * mb], sin[i * mb:(i + 1) * mb],
                 None if mask is None else mask[i * mb:(i + 1) * mb]) for i in range(m)]
        last = sid == stages - 1
        ticks, outs = {}, [None] * m
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        recv = None
        for t in range(m + stages - 1):
            mi = t - sid
            y = None
            if 0 <= mi < m:
                x_in = xs[mi] if sid == 0 else recv
                if grad:
                    x_in = x_in.detach().requires_grad_(True)
                with torch.enable_grad() if grad else contextlib.nullcontext():
                    y, aux_t = pipe.stage(params, x_in, *pick[mi])
                if grad:
                    ticks[mi] = (x_in, y, aux_t)
                aux += aux_t.detach()
                if last:
                    outs[mi] = y.detach()
            recv = pipe.hand_on(t, None if y is None or last else y.detach(),
                                (mb, s, d), x.dtype, reverse=False)
        hidden = (torch.cat(outs) if last else torch.zeros_like(x)).float()
        if stages > 1:
            all_reduce_(hidden, mesh.stage_group, mesh)   # the reference's psum
            all_reduce_(aux, mesh.stage_group, mesh)
        if mesh.data > 1:
            all_reduce_(aux, mesh.data_group, mesh).div_(mesh.data)
        ctx.pipe, ctx.ticks, ctx.shape = pipe, ticks, (m, mb, s, d)
        return hidden.to(x.dtype), aux

    @staticmethod
    def backward(ctx, g_hidden, g_aux):
        pipe, ticks = ctx.pipe, ctx.ticks
        mesh, m = pipe.mesh, pipe.m
        stages, sid = mesh.stage, mesh.stage_rank
        _, mb, s, d = ctx.shape
        dys = g_hidden.reshape(m, mb, s, d)
        dx = torch.zeros((m, mb, s, d), dtype=torch.float32, device=g_hidden.device)
        recv = None
        for t in reversed(range(m + stages - 1)):
            mi = t - sid
            dx_t = None
            if 0 <= mi < m:
                x_in, y, aux_t = ticks.pop(mi)
                outs, grads = [y], [dys[mi] if sid == stages - 1 else recv]
                if aux_t.requires_grad:
                    outs.append(aux_t)
                    grads.append(g_aux)
                with use_mesh(mesh):
                    torch.autograd.backward(outs, grads)
                dx_t = x_in.grad
                if sid == 0:
                    dx[mi] = dx_t
            recv = pipe.hand_on(t, None if dx_t is None or sid == 0 else dx_t,
                                (mb, s, d), g_hidden.dtype, reverse=True)
        if stages > 1:
            all_reduce_(dx, mesh.stage_group, mesh)   # stage 0's, to every stage
        return (dx.reshape(m * mb, s, d).to(g_hidden.dtype), None, None, None,
                None, None)


class PipelineForward:
    """``f(params, input_ids, attn_mask=None) -> (logits, aux)`` over the
    whole batch (:meth:`__call__`), and :meth:`local` over this data rank's
    rows (:meth:`rows`), as the trainer calls it."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, num_microbatches: int,
                 remat: "bool | str" = False):
        validate(cfg, mesh.stage, mesh.model)
        self.cfg, self.mesh, self.m, self.remat = cfg, mesh, num_microbatches, remat
        self.stage_cfg = cfg.replace(num_layers=cfg.num_layers // mesh.stage)
        tp = mesh.model
        # The stage body's tensor-parallel plan: whole heads and FFN columns
        # a model rank (validated above), the vocabulary replicated.
        self.plan = (TPPlan(tp=tp, attn=True, ffn=True, experts=False, shared=False,
                            vocab=False) if tp > 1 else None)

    def stage(self, params, x, cos, sin, mask):
        """This stage's layers on one microbatch: (y, their aux sum)."""
        from ct_diffusionmodelbench_tpu_torch.models.transformer import run_blocks

        with use_mesh(self.mesh):
            return run_blocks(self.stage_cfg, params, x, cos, sin, mask, self.plan,
                              self.remat)

    def hand_on(self, t: int, out: Optional[torch.Tensor], shape, dtype, reverse: bool):
        """Tick ``t``'s transfer: ``out`` to the next stage (the previous
        one with ``reverse``) when this stage ran a microbatch, and what the
        other neighbour sends when it did."""
        mesh, sid = self.mesh, self.mesh.stage_rank
        src = sid + 1 if reverse else sid - 1       # who sends to this stage
        sends = [] if out is None else [(out, mesh.mid_peer(sid + (-1 if reverse else 1)))]
        recvs = ([(shape, dtype, mesh.mid_peer(src))]
                 if 0 <= src < mesh.stage and 0 <= t - src < self.m else [])
        got = exchange(mesh, sends, recvs, mesh.device)
        return got[0] if got else None

    def rows(self, b: int) -> Optional[torch.Tensor]:
        """This data rank's rows of a global batch of ``b``, microbatch by
        microbatch (None: all of them, in order)."""
        m, dp = self.m, self.mesh.data
        if b % m:
            raise ValueError(f"batch={b} must divide by microbatches={m}")
        if (b // m) % dp:
            raise ValueError(f"per-microbatch rows {b // m} must divide by dp={dp}")
        return None if dp == 1 else self._rows_of(b, self.mesh.data_rank)

    def local(self, params: dict, input_ids: torch.Tensor,
              attn_mask: Optional[torch.Tensor] = None):
        """(logits of these rows [b, S, V] f32, the aux loss): ``input_ids``
        are this data rank's rows, in :meth:`rows` order."""
        from ct_diffusionmodelbench_tpu_torch.models.layers import rms_norm, rope_angles
        from ct_diffusionmodelbench_tpu_torch.models.transformer import (
            embed_tokens, lm_head_logits, shift_right, token_positions)

        cfg = self.cfg
        b, s = input_ids.shape
        if b % self.m:
            raise ValueError(f"batch={b} must divide by microbatches={self.m}")
        x = embed_tokens(params, input_ids)
        if torch.is_grad_enabled() and not x.requires_grad:
            x = x.detach().requires_grad_(True)   # blocks may train alone
        cos, sin = rope_angles(token_positions(attn_mask, b, s, x.device),
                               cfg.head_dim, cfg.rope_theta)
        blocks = {"blocks": params["blocks"]}
        hidden, aux = _GPipe.apply(x, self, blocks, cos, sin, attn_mask)
        hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        if cfg.logit_shift:
            hidden = shift_right(hidden)
        logits = lm_head_logits(params, hidden)   # the head is replicated
        return logits, aux / max(cfg.num_layers, 1) / self.m

    def __call__(self, params: dict, input_ids: torch.Tensor,
                 attn_mask: Optional[torch.Tensor] = None):
        b = input_ids.shape[0]
        idx = self.rows(b)
        ids = input_ids.to(self.mesh.device)
        mask = None if attn_mask is None else attn_mask.to(self.mesh.device)
        if idx is None:
            return self.local(params, ids, mask)
        logits, aux = self.local(params, ids[idx], None if mask is None else mask[idx])
        mesh = self.mesh
        whole = all_gather(logits, mesh.data_group, mesh, dim=0)
        order = torch.cat([self._rows_of(b, d) for d in range(mesh.data)])
        out = torch.empty_like(whole)
        out[order.to(whole.device)] = whole
        return out, aux

    def _rows_of(self, b: int, d: int) -> torch.Tensor:
        mb = b // self.m
        n = mb // self.mesh.data
        return torch.cat([torch.arange(i * mb + d * n, i * mb + d * n + n)
                          for i in range(self.m)])


def make_pp_forward(cfg: ModelConfig, mesh: Mesh, num_microbatches: int,
                    remat: "bool | str" = False) -> PipelineForward:
    """The GPipe forward over ``mesh``'s ``stage`` axis.  Checked as the
    reference does: num_layers % stages, the TP-within-stage limits, and at
    the call batch % microbatches and per-microbatch rows % dp.  With
    ``attn_mask`` each stage takes the RoPE tables and the mask of the
    microbatch it holds that tick."""
    return PipelineForward(cfg, mesh, num_microbatches, remat)
