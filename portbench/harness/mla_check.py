"""The latent-attention (DeepSeek-V3 layer) cells' sizes, weights and
comparison with the plain reference.

:func:`sizes` reads a ``deepseek_v3`` configuration file into one flat dict
that the program's config (its own ``config_from_hf``) and the reference
(``portbench/reference/kanana.py``) are both built from.
:func:`draw_weights` draws the weights on the device from the seed, in the
layout the program takes and the published column order (the rope columns
of ``wq`` and ``wkv_a`` interleaved, which the program moves to its own
order when it loads them): ``params["blocks"][name]`` stacked over the
layers that have it (attention over all, the dense FFN over the first
``first_k_dense_replace``, the router, its selection bias and the experts
over the rest).

The comparison is the SDAR cells' (``harness/sdar_check.py``: the same
record of ``ModelRunner.block_fns``, the same structure check, the same
gaps, sample and statistics), with the reference's packed rows carrying
the keys each query sees as two ranges (``reference/kanana.py::pack``)
instead of a square matrix, which a 32k-position row could not hold, and
with the routes pinned:

- The program keeps each position's chosen experts in every expert layer
  (``SdarCache.routes``), and the record takes them after each pass (the
  prompt's after the prefill, a block's after its step or commit:
  :class:`Record`).  Under the sigmoid router a chosen expert weighs about
  ``routed_scaling_factor / K`` (0.41 at kanana-2's), so where two experts'
  scores nearly tie, rounding that turns the choice the other way moves
  the token by a large step, and 47 layers and the attention over 16k-32k
  positions carry it to the sampled block: a reference left to route by
  itself judges a different network than the one the program ran.  So the
  reference takes the program's experts at every real and padded position
  of its packed row (:func:`packed_routes`), with its own f32 weights of
  them, and the token and order gaps judge everything but the choice.
- ``route_flip_share`` judges the choice: over the real positions of the
  sampled rows and the expert layers, the share of the program's chosen
  experts that are not among the top-k the reference's own f32 scores
  choose at the same place (near-ties alone, where sound).  The control's
  reading is the share of its own (fp8) choices outside the f32
  reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from portbench.harness import model, sdar_check, seeds
from portbench.harness.decode_check import _control_gaps, _fold, _no_eos, _zero, gaps, stats
from portbench.harness.sdar_check import _gen, after
from portbench.reference import kanana as ref

ROUTES = ("the latent-attention check pins the reference to the program's routes, which "
          "it reads from the cache after each pass (SdarCache.routes); this program's "
          "cache keeps none, so the benchmark has to read them elsewhere")

# sizes key -> the configuration file's key.
_KEYS = {
    "vocab_size": "vocab_size", "hidden_size": "hidden_size",
    "num_layers": "num_hidden_layers", "num_heads": "num_attention_heads",
    "kv_lora_rank": "kv_lora_rank", "q_lora_rank": "q_lora_rank",
    "qk_nope_head_dim": "qk_nope_head_dim", "qk_rope_head_dim": "qk_rope_head_dim",
    "v_head_dim": "v_head_dim", "intermediate_size": "intermediate_size",
    "moe_intermediate_size": "moe_intermediate_size", "num_experts": "n_routed_experts",
    "num_experts_per_tok": "num_experts_per_tok", "num_shared_experts": "n_shared_experts",
    "first_k_dense_replace": "first_k_dense_replace",
    "routed_scaling_factor": "routed_scaling_factor", "norm_topk_prob": "norm_topk_prob",
    "scoring_func": "scoring_func", "norm_eps": "rms_norm_eps", "rope_theta": "rope_theta",
    "rope_interleave": "rope_interleave", "mask_token_id": "mask_token_id",
    "eos_token_id": "eos_token_id", "dtype": "torch_dtype", "block_length": "block_length",
    "bias_scale": "e_score_correction_bias_scale",
}


def sizes(conf: dict) -> Dict:
    """The configuration as one flat dict of the keys above; refuses what
    the reference does not compute (a low-rank q, a softmax router,
    several expert groups)."""
    s = {key: conf.get(name) for key, name in _KEYS.items()}
    if s["q_lora_rank"] or conf.get("n_group", 1) != 1 or s["scoring_func"] != "sigmoid":
        raise NotImplementedError("the latent-attention check takes no q_lora_rank, one "
                                  "expert group and the sigmoid router")
    s["name"] = conf["name"]
    return s


def iter_weights(s: Dict, seed: int, device: torch.device):
    """(flat name, tensor) of each leaf, in the order it is drawn, as
    ``harness/model.py::iter_weights`` draws them (normals over the square
    root of the fan-in, norm gains 1 + 0.1·normal, the LM head's mask-id
    column zero); the routers' selection bias is ``bias_scale``·normal in
    float32, as the published ``e_score_correction_bias`` is kept."""
    gen = seeds.device_generator(seed, seeds.WEIGHTS, device)
    dt = model.weight_dtype(s, device)

    def draw(shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    def dense(shape, fan_in):
        return draw(shape).mul_(1.0 / math.sqrt(fan_in))

    def gain(shape):
        return draw(shape).mul_(0.1).add_(1.0)

    L, D, V, H = s["num_layers"], s["hidden_size"], s["vocab_size"], s["num_heads"]
    R, N, P, Vh = s["kv_lora_rank"], s["qk_nope_head_dim"], s["qk_rope_head_dim"], s["v_head_dim"]
    k = s["first_k_dense_replace"]
    E, Fm, F = s["num_experts"], s["moe_intermediate_size"], s["intermediate_size"]
    Fs = Fm * s["num_shared_experts"]
    yield "blocks/attn_norm", gain((L, D))
    yield "blocks/wq", dense((L, D, H * (N + P)), D)
    yield "blocks/wkv_a", dense((L, D, R + P), D)
    yield "blocks/kv_norm", gain((L, R))
    yield "blocks/wkv_b", dense((L, R, H * (N + Vh)), R)
    yield "blocks/wo", dense((L, H * Vh, D), H * Vh)
    yield "blocks/ffn_norm", gain((L, D))
    yield "blocks/w_gate", dense((k, D, F), D)
    yield "blocks/w_up", dense((k, D, F), D)
    yield "blocks/w_down", dense((k, F, D), F)
    yield "blocks/router", dense((L - k, D, E), D)
    yield "blocks/e_bias", draw((L - k, E), torch.float32).mul_(s["bias_scale"])
    yield "blocks/we_gate", dense((L - k, E, D, Fm), D)
    yield "blocks/we_up", dense((L - k, E, D, Fm), D)
    yield "blocks/we_down", dense((L - k, E, Fm, D), Fm)
    yield "blocks/ws_gate", dense((L - k, D, Fs), D)
    yield "blocks/ws_up", dense((L - k, D, Fs), D)
    yield "blocks/ws_down", dense((L - k, Fs, D), Fs)
    head = dense((D, V), D)
    head[:, s["mask_token_id"]] = 0
    yield "lm_head", head
    yield "embed", dense((V, D), D)
    yield "final_norm", gain((D,))


def draw_weights(s: Dict, seed: int, device: torch.device) -> dict:
    """Seeded weights in the program's layout (:func:`iter_weights`)."""
    out: dict = {"blocks": {}}
    for name, t in iter_weights(s, seed, device):
        if name.startswith("blocks/"):
            out["blocks"][name[len("blocks/"):]] = t
        else:
            out[name] = t
    return out


@dataclass
class Record(sdar_check.Record):
    """SDAR's record of one ``generate_ids`` call, with the routes the
    passes left in the cache: the prompt's ``[L - k, B, P, K]`` after the
    prefill, each step's and commit's block's ``[L - k, B, bl, K]``."""
    prompt_routes: torch.Tensor = None
    step_routes: List[torch.Tensor] = field(default_factory=list)
    commit_routes: List[torch.Tensor] = field(default_factory=list)


def routes_of(cache, lo: int, hi: int) -> torch.Tensor:
    """A copy of the cache's routes of positions ``lo .. hi - 1``."""
    if getattr(cache, "routes", None) is None:
        raise RuntimeError(ROUTES)
    return cache.routes[:, :, lo:hi].clone()


@dataclass
class Trajectory(sdar_check.Trajectory):
    """One request's path with its routes (``[L - k, n, K]`` each)."""
    prompt_routes: torch.Tensor = None
    step_routes: List[torch.Tensor] = field(default_factory=list)
    commit_routes: List[torch.Tensor] = field(default_factory=list)


def trajectories(record: Record, out, lengths: List[int], device) -> List[Trajectory]:
    """Each row of a batch's record as a trajectory, with the output row."""
    return [Trajectory(prompt=t.prompt, mask=t.mask, steps=t.steps, commits=t.commits,
                       final=t.final, prompt_routes=record.prompt_routes[:, r],
                       step_routes=[x[:, r] for x in record.step_routes],
                       commit_routes=[x[:, r] for x in record.commit_routes])
            for r, t in enumerate(sdar_check.trajectories(record, out, lengths, device))]


def packed_routes(t: Trajectory, steps: List[int], spb: int, bl: int):
    """(the program's routes int64 [L - k, S, K] along :func:`packed`'s row,
    bool [S]: which of its positions are real): the prompt's from the
    prefill, each committed block's from its commit, each sampled state's
    block from its step."""
    k = max(steps) // spb
    routes = torch.cat([t.prompt_routes] + t.commit_routes[:k]
                       + [t.step_routes[i] for i in steps], dim=1).long()
    real = torch.cat([t.mask.bool(), torch.ones(routes.shape[1] - t.mask.shape[0],
                                                dtype=torch.bool, device=t.mask.device)])
    return routes, real.to(routes.device)


def route_misses(chosen: torch.Tensor, judge: torch.Tensor, real: torch.Tensor) -> int:
    """Chosen experts [L, S, K] not among ``judge``'s [L, S, K], counted at
    the real positions."""
    out = (chosen[..., :, None] != judge[..., None, :]).all(dim=-1)
    return int(out[:, real].sum())


def packed(t: Trajectory, steps: List[int], spb: int, bl: int):
    """``reference/kanana.py::pack`` of the states of steps ``steps``: the
    prompt and the blocks committed before the last of them, with each
    step's block beside them."""
    k = max(steps) // spb
    prefix = torch.cat([t.prompt] + [c for _, c in t.commits[:k]])
    mask = torch.cat([t.mask.to(prefix.device),
                      torch.ones(k * bl, dtype=t.mask.dtype, device=prefix.device)])
    blocks = [(t.prompt.shape[0] + (i // spb) * bl, t.steps[i][1]) for i in steps]
    return ref.pack(prefix, mask, blocks, bl)


def judge(trajs: List[Trajectory], pairs, weights: dict, s: Dict, mix: dict,
          control=None):
    """(the widest gaps over ``pairs``, {request: its widest gaps}) under the
    float32 reference, the sampled states of one request packed into one
    row, one request a forward, routed by the program's experts; with
    ``route_flip_share``.  ``control``: also the gaps of what the reference
    computed under that cast (routed as the program routed) would commit,
    and the share of its own choices of experts outside the f32
    reference's, under ``control_*`` names."""
    bl, _, spb = _gen(mix)
    mask_id = s["mask_token_id"]
    eos = s["eos_token_id"] if mix["generate"].get("avoid_eos") else None
    sides = ("", "control_") if control is not None else ("",)
    totals = {side: _zero() for side in sides}
    per_request = {r: _zero() for r, _ in pairs}
    misses = {side: 0 for side in sides}
    slots = 0
    head = weights["lm_head"].float()
    steps: Dict[int, List[int]] = {}
    for r, i in pairs:
        steps.setdefault(r, []).append(i)
    for r, idx in steps.items():
        ids, pos, ranges, offsets = packed(trajs[r], idx, spb, bl)
        chosen, real = packed_routes(trajs[r], idx, spb, bl)
        route = ref.Route(chosen)
        hidden = ref.final_hidden(weights, s, ids[None], None, ranges=ranges[None],
                                  pos=pos[None], route=route)[0]
        own = torch.stack(route.own)
        misses[""] += route_misses(chosen, own, real)
        slots += int(real.sum()) * chosen.shape[0] * chosen.shape[2]
        hidden_c = None
        if control:
            route_c = ref.Route(chosen)
            hidden_c = ref.final_hidden(weights, s, ids[None], None, control,
                                        ranges=ranges[None], pos=pos[None], route=route_c)[0]
            misses["control_"] += route_misses(torch.stack(route_c.own), own, real)
        del route, own
        for i, lo in zip(idx, offsets):
            cur, nxt = trajs[r].steps[i][1], after(trajs[r], i, spb).to(ids.device)
            logits = _no_eos(ref.linear(hidden[lo:lo + bl], head), eos)
            g = {"": gaps(logits, cur, nxt, mask_id)}
            if control is not None:
                g["control_"] = _control_gaps(
                    logits, _no_eos(ref.linear(hidden_c[lo:lo + bl], head, control), eos),
                    cur, nxt, mask_id)
            _fold(per_request[r], g[""])
            for side in sides:
                _fold(totals[side], g[side])
    worst = {}
    for side in sides:
        worst.update({side + k: v for k, v in stats(totals[side]).items()})
        worst[side + "route_flip_share"] = misses[side] / max(slots, 1)
    return worst, {r: stats(acc) for r, acc in per_request.items()}
