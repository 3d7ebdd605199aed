"""The SDAR family's exact prefix KV cache: prefill, cached step, commit.

SDAR decodes by blocks: attention is block-causal (``models/transformer.py``),
so a position's keys and values depend only on its own block and the
blocks before it.  Once the prompt and the blocks generated so far are
final, their K and V are final too, and a cache of them is exact (unlike
the LLaDA families' dual cache, ``models/block_cache.py``, an
approximation):

- :func:`forward_prefill`: the padded prompt's block-causal forward (the
  flash kernel's block-causal mode on the card), writing every layer's
  rotated K and V into a preallocated :class:`SdarCache` ``[L, B, S, KV,
  Dh]`` of the whole sequence; no LM head.
- :func:`forward_block`: a block of ``bl`` tokens at ``start``, each
  layer's rotated K and V written into the cache's slots of the block,
  then its queries against keys ``key_start[b] .. start + bl - 1`` (the
  row's real prompt, the committed blocks and the block itself) through K12
  (``ops/cache_attention.py``).  As a denoising step it returns the block's
  f32 logits; as the commit (SDAR's store pass over the finished block) it
  stops before the head, leaving the block's final K and V in the cache.
  The commit is a pass of its own: each step wrote K and V of a state that
  still held masks.

Under multi-head latent attention (``cfg.is_mla``, ``models/mla.py``) the
cache holds each layer's latent rows instead, ``[L, B, S, R + P]`` (the
normed latent c and the rotated rope key, 1152 B a token a layer at
kanana-2's widths against SDAR's 2048 of K and V): the prefill writes them
and attends in the up-projected form (the latent prefill kernel), runs its
rows in groups of :func:`prefill_rows`, and a step or commit writes its
block's rows and attends in the absorbed form (K13,
``ops/mla_attention.py``), never up-projecting the cache.

Under DeepSeek-V3's sigmoid router (``cfg.scoring_func == "sigmoid"``) the
cache also keeps each position's chosen experts in every expert layer,
``SdarCache.routes`` ``[L - dense_layers, B, S, K]`` uint8, as the last
pass over that position chose them: the prefill writes the prompt's, a
step or commit its block's.  Each chosen expert's weight there is about
``routed_scaling_factor / K`` (0.41 at kanana-2's 2.448 / 6), so where two
experts' scores nearly tie, a choice that rounding turns the other way
moves the token by a large step, and 47 expert layers carry it on; a
comparison with a reference has to follow the program's routes, and reads
them here (``portbench/harness/mla_check.py``).  The record costs three
launches a pass.

The passes run ``models/transformer.py``'s embedding, layer body
(:func:`~ct_diffusionmodelbench_tpu_torch.models.transformer.block`) and
head, so they and the full forward cannot drift apart; each brings only
its attention, which rotates q and k and writes the cache.
Positions restart at each row's first real token; a generated position i
sits at ``i - key_start``, the row's real prompt length plus ``i - P``.

A block pass reads its start from the device (``SdarCache.start``, set by
one fill before the pass): the cache writes go through ``index_copy_`` and
K12 reads its key end from memory, so one recording of a pass serves
every block.  On the card :func:`make_sdar_fns` runs a step or commit
eagerly the first time it meets a cache buffer, then records it as a CUDA
graph (:class:`GraphedPass`) and replays that: a pass launches some 5,800
kernels (48 layers of norms, projections, rotation, routing, the expert
kernels, the combine), and launched one by one from Python they took the
host ≈ 110 ms a pass against ≈ 37 ms of device work.  The cache's buffers
are kept per batch shape and reused by every batch of that shape, so the
recordings are too.

With the tracer on (``utils/profiling.py``), every pass is a
``model.forward`` span counted by ``count_pass`` (``model.attn`` and
``model.ffn`` a layer and ``model.head`` in a step where the pass runs
eagerly: the prefill, and a step or commit recorded as a graph only in
its eager and recorded runs); a step or commit also counts, summed over
rows, the keys its attention reads (``cache.keys``), its query positions
(``cache.queries``) and the query-key pairs (``cache.pairs``), host ints
known from the positions; over a latent cache the same counts are
``mla.keys``, ``mla.queries`` and ``mla.pairs``, and the prefill counts
its block-causal pairs over real queries and keys (``mla.prefill_pairs``,
the kernel skips the padding's tiles) and its real tokens
(``mla.prefill_queries``), from the mask, which it reads on the host only
under the tracer.  A graph's replay adds the kernel launches its
recording made to the launch counters (``ops/cuda_build.py``), so they
count the kernels that ran.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ct_diffusionmodelbench_tpu_torch.models import mla
from ct_diffusionmodelbench_tpu_torch.models.config import ModelConfig
from ct_diffusionmodelbench_tpu_torch.models.layers import apply_rope, rope_angles
from ct_diffusionmodelbench_tpu_torch.models.transformer import (
    block, count_pass, embed_tokens, final_logits, split_layers, token_positions)
from ct_diffusionmodelbench_tpu_torch.ops.attention import attention
from ct_diffusionmodelbench_tpu_torch.ops.cache_attention import cache_attention
from ct_diffusionmodelbench_tpu_torch.ops.cuda_build import KERNELS
from ct_diffusionmodelbench_tpu_torch.utils.profiling import count, span, tracing_on

# Positions a prefill group holds (prefill_rows).
PREFILL_TOKENS = 32768


@dataclass
class SdarCache:
    """Every layer's rotated K and V of one batch, ``[L, B, S, KV, Dh]``
    (under latent attention, ``lat``: every layer's latent rows ``[L, B,
    S, R + P]``, c then the rotated rope key, and no K or V), valid up to
    the last committed position; on the device ``key_start`` int32 [B],
    each row's first real key, and ``start`` int32 [1], the block the next
    pass runs; on the host ``prompt_len``, the padded prompt's length, and
    ``real_keys``, the batch's real prompt tokens; ``routes``, where the
    router is sigmoid, each position's chosen experts ``[L - dense_layers,
    B, S, K]`` uint8."""
    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    key_start: torch.Tensor
    start: torch.Tensor
    prompt_len: int = 0
    real_keys: int = 0
    lat: Optional[torch.Tensor] = None
    routes: Optional[torch.Tensor] = None

    @property
    def buffer(self) -> torch.Tensor:
        """The cache's first buffer, which names it (``make_sdar_fns``)."""
        return self.lat if self.lat is not None else self.k


def new_cache(cfg: ModelConfig, batch: int, total_len: int, dtype, device) -> SdarCache:
    ends = dict(key_start=torch.zeros((batch,), dtype=torch.int32, device=device),
                start=torch.zeros((1,), dtype=torch.int32, device=device))
    if cfg.is_moe and cfg.scoring_func == "sigmoid":
        ends["routes"] = torch.zeros((cfg.num_layers - cfg.dense_layers, batch, total_len,
                                      cfg.num_experts_per_tok), dtype=torch.uint8, device=device)
    if cfg.is_mla:
        shape = (cfg.num_layers, batch, total_len, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        return SdarCache(k=None, v=None, lat=torch.empty(shape, dtype=dtype, device=device),
                         **ends)
    shape = (cfg.num_layers, batch, total_len, cfg.num_kv_heads, cfg.head_dim)
    return SdarCache(k=torch.empty(shape, dtype=dtype, device=device),
                     v=torch.empty(shape, dtype=dtype, device=device), **ends)


def prefill_rows(cfg: ModelConfig, batch: int, prompt_len: int) -> int:
    """Rows a prefill group holds: as many as fit :data:`PREFILL_TOKENS`
    positions, at least one.  At kanana30b-ctx32k's 4 rows of 32512, a
    whole-batch prefill's transients (~3 GB a row) would not fit beside
    61.3 GB of weights and 7.25 GB of cache, so its prefill runs a row at a
    time; sdar30b-eval's 32 rows of 576 run as one group."""
    return max(1, min(batch, PREFILL_TOKENS // max(prompt_len, 1)))


def _check_supported(cfg: ModelConfig) -> None:
    if not cfg.block_length:
        raise NotImplementedError("the exact block cache needs a block-causal model "
                                  "(cfg.block_length > 0, the SDAR family)")
    if cfg.logit_shift or cfg.causal:
        raise NotImplementedError("SDAR's cache takes unshifted, block-causal models")


def forward_prefill(cfg: ModelConfig, params: dict, input_ids: torch.Tensor,
                    attn_mask: Optional[torch.Tensor], cache: SdarCache,
                    real_keys: int) -> SdarCache:
    """The prompt's block-causal forward into ``cache``: its first ``P``
    positions get the prompt's rotated K and V (latent rows under latent
    attention, whose attention is the up-projected form,
    ``models/mla.py``).  ``real_keys``: the real tokens of ``attn_mask`` (a
    host int).  The rows run in groups of :func:`prefill_rows`."""
    B, P = input_ids.shape
    if attn_mask is None:
        cache.key_start.zero_()
    else:
        cache.key_start.copy_(P - attn_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32))
    cache.prompt_len, cache.real_keys = P, real_keys
    layers, stacks = split_layers(cfg, params)
    step = prefill_rows(cfg, B, P)
    for r0 in range(0, B, step):
        rows = slice(r0, min(B, r0 + step))
        mask = None if attn_mask is None else attn_mask[rows]
        with span("model.embed"):
            x = embed_tokens(params, input_ids[rows])
            cos, sin = rope_angles(token_positions(mask, x.shape[0], P, x.device),
                                   cfg.rope_dim, cfg.rope_theta)

        def attend(li, q, k, v):
            if cfg.is_mla:
                q_pe, lat = mla.rotate(cfg, q, k, cos, sin)
                cache.lat[li, rows, :P] = lat
                return mla.up_attention(cfg, q, q_pe, lat, layers[li]["wkv_b"],
                                        cache.key_start[rows])
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            cache.k[li, rows, :P] = k
            cache.v[li, rows, :P] = v
            return attention(q, k, v, mask=mask, impl=cfg.attn_impl,
                             block_len=cfg.block_length)

        routes = [] if cache.routes is not None else None
        for li, lp in enumerate(layers):
            x, _ = block(cfg, x, lp, li, attend, stacks, routes=routes)
            if routes:
                cache.routes[li - cfg.dense_layers, rows, :P] = routes.pop().view(
                    x.shape[0], P, -1)
    return cache


def forward_block(cfg: ModelConfig, params: dict, block_ids: torch.Tensor,
                  cache: SdarCache, logits: bool = True,
                  absorbed: Optional[tuple] = None) -> Optional[torch.Tensor]:
    """The block ``block_ids`` [B, bl] at positions ``cache.start ..
    cache.start + bl`` against the cache, its K and V (latent rows) written
    into the cache: the block's logits [B, bl, V] f32, or None (the commit)
    without ``logits``.  Under latent attention the attention is the
    absorbed form (``models/mla.py``) with ``absorbed``, each layer's
    (W_UK, W_UV) (:class:`~ct_diffusionmodelbench_tpu_torch.models.mla.
    Absorbed`), which it then needs.  Reads nothing on the host."""
    bl = block_ids.shape[1]
    with span("model.embed"):
        x = embed_tokens(params, block_ids)
        slots = cache.start + torch.arange(bl, dtype=torch.int32, device=x.device)
        cos, sin = rope_angles(slots[None] - cache.key_start[:, None], cfg.rope_dim,
                               cfg.rope_theta)
        slots = slots.long()
        key_end = cache.start + bl
    if cfg.is_mla and absorbed is None:
        raise ValueError("a latent cache's pass needs the absorbed weights (mla.Absorbed)")

    def attend(li, q, k, v):
        if cfg.is_mla:
            q_pe, lat = mla.rotate(cfg, q, k, cos, sin)
            cache.lat[li].index_copy_(1, slots, lat)
            return mla.absorbed_attention(cfg, q, q_pe, cache.lat[li], cache.key_start,
                                          key_end, absorbed[0][li], absorbed[1][li])
        q = apply_rope(q, cos, sin)
        cache.k[li].index_copy_(1, slots, apply_rope(k, cos, sin))
        cache.v[li].index_copy_(1, slots, v)
        return cache_attention(q, cache.k[li], cache.v[li], cache.key_start, key_end)

    layers, stacks = split_layers(cfg, params)
    routes = [] if cache.routes is not None else None
    for li, lp in enumerate(layers):
        x, _ = block(cfg, x, lp, li, attend, stacks, routes=routes)
    if routes:
        cache.routes.index_copy_(2, slots, torch.stack(routes).view(
            len(routes), *block_ids.shape, -1).to(torch.uint8))
    return final_logits(cfg, params, x) if logits else None


def count_keys(cache: SdarCache, batch: int, bl: int, start: int) -> None:
    """The tracer's cache counters of one pass over a block at ``start``:
    the keys its attention reads summed over rows, the query positions, and
    the query-key pairs; ``cache.*`` (K12's) over a K/V cache, ``mla.*``
    (K13's) over a latent one."""
    keys = batch * (start + bl) - (batch * cache.prompt_len - cache.real_keys)
    kind = "mla" if cache.lat is not None else "cache"
    count(f"{kind}.keys", keys)
    count(f"{kind}.queries", batch * bl)
    count(f"{kind}.pairs", bl * keys)


class GraphedPass:
    """One pass kind over one cache buffer on the card: run eagerly on its
    first call, recorded as a CUDA graph on its second (static block ids in,
    the pass's output tensor out) and replayed from then on.  The output of
    a replay is overwritten by the next one.  A replay adds the kernel
    launches the recording made to the launch counters."""

    def __init__(self, fn: Callable[[torch.Tensor], Optional[torch.Tensor]]):
        self.fn = fn
        self.calls = 0
        self.graph = None

    def __call__(self, block_ids: torch.Tensor) -> Optional[torch.Tensor]:
        if self.graph is None:
            self.calls += 1
            if self.calls == 1:
                return self.fn(block_ids)
            self._record(block_ids)
        self.ids.copy_(block_ids)
        self.graph.replay()
        for name, n in self.launches.items():
            KERNELS[name].launches += n
        return self.out

    def _record(self, block_ids: torch.Tensor) -> None:
        self.ids = block_ids.clone()
        before = {name: k.launches for name, k in KERNELS.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self.fn(self.ids)
        # The recording launched nothing: its calls are counted per replay.
        self.launches = {name: k.launches - before.get(name, 0)
                         for name, k in KERNELS.items() if k.launches != before.get(name, 0)}
        for name, k in KERNELS.items():
            k.launches = before.get(name, 0)
        self.graph = graph


def make_sdar_fns(cfg: ModelConfig):
    """``(prefill_fn, step_fn, commit_fn)`` for ``sampling/sdar.py``:

    - ``prefill_fn(params, ids, attn_mask, total_len, real_keys)`` → a
      :class:`SdarCache` of ``total_len`` positions holding the prompt;
    - ``step_fn(params, cache, block_ids, start)`` → the block's logits (on
      the card, overwritten by the next step);
    - ``commit_fn(params, cache, block_ids, start)``: the finished block's
      K and V into the cache.

    The functions keep one cache a batch shape, which every batch of that
    shape reuses; on the card the steps and commits over it run as
    :class:`GraphedPass` es (one per pass kind, cache and weights)."""
    _check_supported(cfg)
    caches: Dict[tuple, SdarCache] = {}
    passes: Dict[tuple, GraphedPass] = {}
    absorb = mla.Absorbed(cfg) if cfg.is_mla else None

    @torch.inference_mode()
    def prefill_fn(params, ids, attn_mask, total_len, real_keys):
        with span("model.forward"):
            count_pass(ids)
            if cfg.is_mla and tracing_on():
                # A device read, made only under the tracer.
                lengths = ([ids.shape[1]] * ids.shape[0] if attn_mask is None
                           else attn_mask.sum(dim=-1).tolist())
                count("mla.prefill_pairs",
                      mla.prefill_pairs(lengths, ids.shape[1], cfg.block_length))
                count("mla.prefill_queries", int(sum(lengths)))
            dtype, dev = params["embed"].dtype, ids.device
            key = (ids.shape[0], total_len, dtype, dev)
            if key not in caches:
                caches[key] = new_cache(cfg, ids.shape[0], total_len, dtype, dev)
            return forward_prefill(cfg, params, ids, attn_mask, caches[key], real_keys)

    def run_pass(params, cache, block_ids, start, logits):
        cache.start.fill_(start)
        absorbed = absorb(params) if absorb is not None else None
        if not block_ids.is_cuda:
            return forward_block(cfg, params, block_ids, cache, logits, absorbed)
        key = (logits, cache.buffer.data_ptr(), params["embed"].data_ptr(), *block_ids.shape)
        if key not in passes:
            passes[key] = GraphedPass(
                lambda ids: forward_block(cfg, params, ids, cache, logits, absorbed))
        return passes[key](block_ids)

    @torch.inference_mode()
    def step_fn(params, cache, block_ids, start):
        with span("model.forward"):
            count_pass(block_ids)
            count_keys(cache, block_ids.shape[0], block_ids.shape[1], start)
            return run_pass(params, cache, block_ids, start, True)

    @torch.inference_mode()
    def commit_fn(params, cache, block_ids, start):
        with span("model.forward"):
            count_pass(block_ids)
            count_keys(cache, block_ids.shape[0], block_ids.shape[1], start)
            run_pass(params, cache, block_ids, start, False)

    return prefill_fn, step_fn, commit_fn
