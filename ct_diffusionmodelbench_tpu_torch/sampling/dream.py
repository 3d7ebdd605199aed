"""Dream / DiffuCoder ``diffusion_generate`` semantics.

Counterpart of ``sampling/dream.py``:

    timesteps t_i = linspace(1, eps, steps + 1)
    per step, on the full bidirectional forward (logits already shifted by
    the model's ``logit_shift``):
      - sample candidate tokens at masked positions with temperature /
        top-p / top-k filtering,
      - score each masked position by ``alg``: 'origin' (each masked
        position transfers with probability 1 - s/t), 'maskgit_plus'
        (chosen-token probability), 'topk_margin' (top1 - top2
        probability), 'entropy' (negative entropy),
      - transfer the ``floor(mask_count * (1 - s/t))`` highest-scored
        positions (all of them on the last step); with ``alg_temp > 0`` the
        positions are sampled ∝ softmax(score / alg_temp) by Gumbel-top-k.

Every op runs full-width [B, S(, V)] with -inf masking, as the reference.
The step loop is a Python loop over host-known step indices.

Top-p / top-k filter the ``TOP_P_PREFILTER`` largest logits (the whole
vocabulary with ``exact``), as the reference.  The reference takes those
with ``jax.lax.approx_max_k`` when it samples (T > 0) without ``exact``, a
TPU speed device with no counterpart here: the port always takes the exact
top-K, which is what the reference does whenever ``exact`` is set or the
decode is greedy.

Randomness: a ``torch.Generator``, or the uniform draws of each step passed
in (``uniforms[i] = (u_tok, u_pos)``: ``u_tok`` [B, S', K] for the token
sample at T > 0, ``u_pos`` [B, S'] for 'origin' or ``alg_temp > 0``; either
may be None where unused), so a test can feed both frameworks one set of
draws.  The reference's jitted-sampler cache has no counterpart: PyTorch
runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device
from ct_diffusionmodelbench_tpu_torch.ops.sampling_ops import rank_topk_mask
from ct_diffusionmodelbench_tpu_torch.sampling.llada import _supports_logit_slice

NEG_INF = float("-inf")
TOP_P_PREFILTER = 64
ALGS = ("origin", "maskgit_plus", "topk_margin", "entropy")

Draws = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


@dataclass(frozen=True)
class DreamSamplerConfig:
    steps: int = 256
    max_new_tokens: int = 256
    temperature: float = 0.4
    top_p: Optional[float] = 0.95
    top_k: Optional[int] = None
    alg: str = "entropy"          # origin | maskgit_plus | topk_margin | entropy
    alg_temp: float = 0.0
    mask_id: int = 151666
    eps: float = 1e-3
    exact: bool = False           # filter over the full vocabulary
    batch_mean_counts: bool = False  # remote-code batch-averaged transfer
                                     # counts (identical at batch size 1)

    def __post_init__(self):
        if self.alg not in ALGS:
            raise NotImplementedError(self.alg)


def _uniform(shape, device, generator, given: Optional[torch.Tensor]):
    """Uniform draws in [1e-20, 1): the given ones, else the generator's."""
    if given is not None:
        return given.to(device=device, dtype=torch.float32)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u.clamp_min(1e-20)


def _top_k(work: torch.Tensor, k: int):
    """The k largest of the last dim in descending order, ties to the
    lowest index (``lax.top_k``'s order)."""
    if k == work.shape[-1]:
        return torch.sort(work, dim=-1, descending=True, stable=True)
    return torch.topk(work, k, dim=-1, sorted=True)


def _neg_entropy(work: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(work, dim=-1)
    return torch.sum(probs * torch.log(probs + 1e-10), dim=-1)


def _filter_and_sample(logits: torch.Tensor, sc: DreamSamplerConfig,
                       generator: Optional[torch.Generator] = None,
                       u_tok: Optional[torch.Tensor] = None):
    """Temperature / top-p / top-k token sampling and per-position scores.

    logits [B, S, V] f32 → (x0 [B, S] int64, conf [B, S] f32 per ``alg``),
    confidences under the filtered softmax (the full one without a
    filter), as the published ``sample_tokens``."""
    work = logits / sc.temperature if sc.temperature > 0 else logits
    no_filter = (sc.top_p is None or sc.top_p >= 1.0) and sc.top_k is None
    if sc.temperature <= 0 and no_filter and sc.alg in (
            "entropy", "maskgit_plus", "origin"):
        # Greedy shortcut: argmax and logsumexp only.
        x0 = torch.argmax(work, dim=-1)
        if sc.alg == "entropy":
            return x0, _neg_entropy(work)
        lse = torch.logsumexp(work, dim=-1)
        return x0, torch.exp(torch.amax(work, dim=-1) - lse)

    v = work.shape[-1]
    k = v if sc.exact else min(TOP_P_PREFILTER, v)
    top_vals, top_idx = _top_k(work, k)
    filtered = top_vals
    filtering = False
    if sc.top_k is not None and sc.top_k < k:
        pos = torch.arange(k, device=work.device)
        filtered = torch.where(pos < sc.top_k, filtered, NEG_INF)
        filtering = True
    if sc.top_p is not None and sc.top_p < 1.0:
        # Drop token i once the mass before it already exceeds top_p.
        probs_sorted = torch.softmax(filtered, dim=-1)
        cum = torch.cumsum(probs_sorted, dim=-1)
        filtered = torch.where((cum - probs_sorted) > sc.top_p, NEG_INF, filtered)
        filtering = True
    lse = torch.logsumexp(filtered if filtering else work, dim=-1, keepdim=True)
    log_probs = filtered - lse                      # [B, S, K], -inf where dropped

    if sc.temperature > 0:
        u = _uniform(filtered.shape, work.device, generator, u_tok)
        g = -torch.log(-torch.log(u))
        scores = torch.where(torch.isfinite(log_probs), log_probs + g, NEG_INF)
        choice = torch.argmax(scores, dim=-1)
    else:
        choice = torch.zeros(filtered.shape[:-1], dtype=torch.long,
                             device=work.device)
    x0 = torch.gather(top_idx, -1, choice[..., None])[..., 0]
    if sc.alg == "topk_margin":
        p = torch.exp(log_probs)
        conf = p[..., 0] - p[..., 1]
    elif sc.alg == "entropy":
        if filtering:
            p = torch.exp(log_probs)                # zeros where dropped
            conf = torch.sum(p * torch.log(p + 1e-10), dim=-1)
        else:
            conf = _neg_entropy(work)
    else:   # maskgit_plus / origin: the chosen token's probability
        conf = torch.exp(torch.gather(log_probs, -1, choice[..., None])[..., 0])
    return x0, conf


def _timesteps(steps: int, eps: float) -> torch.Tensor:
    """linspace(1, eps, steps + 1) in f32 as XLA evaluates the reference's
    ``jnp.linspace``: r = f32(1/n), c = f32(eps * r), t_i = (1 - i*r) + i*c
    with the last sum fused (one rounding), t_n = eps.  Equal bit for bit to
    eager ``jnp.linspace`` for every step count below 352 (a test checks).
    The reference's sampler evaluates it under ``jax.jit``, where the values
    differ from the eager ones by an ulp at some step counts (52, 82, 104,
    333 and 351 among them) without changing how many tokens a step
    unmasks (a test checks that count at 256 and 512 steps)."""
    i = torch.arange(steps, dtype=torch.float32)
    r = torch.tensor(1.0 / steps, dtype=torch.float32)
    stop = torch.tensor(eps, dtype=torch.float32)
    head = (1 - i * r).double() + i.double() * (stop * r).double()
    return torch.cat([head.float(), stop[None]])


def _dream_loop(forward_fn, sc: DreamSamplerConfig, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator],
                uniforms: Optional[Sequence[Draws]], record_history: bool,
                prompt_len: int = 0, supports_slice: bool = False):
    """x [B, P+G] updated in place; returns (x, history [steps or 0, B, S]).

    ``prompt_len > 0`` with slice support scores only the generated region
    (the LM head, the f32 logits and the sampling math on [B, gen]),
    equivalent to the full width whenever the prompt holds no mask token;
    off under ``exact`` and ``batch_mean_counts``, as in the reference."""
    b, s = x.shape
    timesteps = _timesteps(sc.steps, sc.eps)
    sliced = (supports_slice and prompt_len > 0
              and not sc.exact and not sc.batch_mean_counts)
    lo = prompt_len if sliced else 0
    history = []
    for i in range(sc.steps):
        u_tok, u_pos = (None, None) if uniforms is None else uniforms[i]
        x_gen = x[:, lo:]
        mask_index = x_gen == sc.mask_id
        if sliced:
            logits, _ = forward_fn(x, attn_mask, logit_start=lo, logit_length=s - lo)
        else:
            logits, _ = forward_fn(x, attn_mask)
        x0, conf = _filter_and_sample(logits.float(), sc, generator, u_tok)
        x0 = x0.to(x.device)
        conf = conf.to(x.device)
        # The reference's f32 1 - s/t (a step index known on the host).
        frac = float(1.0 - timesteps[i + 1] / timesteps[i])
        is_last = i == sc.steps - 1

        if sc.alg == "origin":
            p_transfer = 1.0 if is_last else frac
            u = _uniform(x_gen.shape, x.device, generator, u_pos)
            transfer = mask_index & (u < p_transfer)
        else:
            if sc.batch_mean_counts:
                # One count for the whole batch: floor of the mean mask
                # count per row times the fraction.
                mean = mask_index.sum().float() / mask_index.shape[0]
                kc = mean if is_last else mean * frac
                k_count = kc.to(torch.int64).expand(b)
            else:
                mask_num = mask_index.sum(dim=1)
                k_count = mask_num if is_last else (
                    mask_num.float() * frac).to(torch.int64)
            full_conf = torch.where(mask_index, conf, NEG_INF)
            if sc.alg_temp and sc.alg_temp > 0:
                # Gumbel-top-k: k positions without replacement
                # ∝ softmax(conf / alg_temp).
                u = _uniform(full_conf.shape, x.device, generator, u_pos)
                g = -torch.log(-torch.log(u))
                full_conf = torch.where(mask_index, full_conf / sc.alg_temp + g, NEG_INF)
            transfer = rank_topk_mask(full_conf, k_count) & mask_index
        x[:, lo:] = torch.where(transfer, x0.to(x.dtype), x_gen)
        if record_history:
            history.append(x.clone())
    hist = (torch.stack(history) if record_history
            else torch.zeros((0, b, s), dtype=x.dtype, device=x.device))
    return x, hist


def make_dream_sampler(forward_fn: Callable, sampler_config: DreamSamplerConfig,
                       output_history: bool = False) -> Callable:
    """``sample(params, prompt_ids, attn_mask=None, generator=None,
    uniforms=None) -> (sequences [B, P+G], history [steps or 0, B, P+G])``."""
    sc = sampler_config
    supports_slice = _supports_logit_slice(forward_fn)

    @torch.inference_mode()
    def sample(params, prompt_ids, attn_mask=None, generator=None, uniforms=None):
        b, p = prompt_ids.shape
        gen = torch.full((b, sc.max_new_tokens), sc.mask_id, dtype=prompt_ids.dtype,
                         device=prompt_ids.device)
        x = torch.cat([prompt_ids, gen], dim=1)
        full_mask = None
        if attn_mask is not None:
            ones = torch.ones((b, sc.max_new_tokens), dtype=attn_mask.dtype,
                              device=attn_mask.device)
            full_mask = torch.cat([attn_mask, ones], dim=1)
        fwd = lambda ids, m, **kw: forward_fn(params, ids, m, **kw)  # noqa: E731
        return _dream_loop(fwd, sc, x, full_mask, generator, uniforms,
                           output_history, prompt_len=int(p),
                           supports_slice=supports_slice)

    return sample


def dream_generate(forward_fn: Callable, params, prompt_ids: torch.Tensor, *,
                   steps: int = 256, max_new_tokens: int = 256,
                   temperature: float = 0.4, top_p: Optional[float] = 0.95,
                   top_k: Optional[int] = None, alg: str = "entropy",
                   alg_temp: float = 0.0, mask_id: int = 151666,
                   attn_mask: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[Sequence[Draws]] = None,
                   output_history: bool = False, exact: bool = False,
                   batch_mean_counts: bool = False, device: DeviceLike = None):
    """Counterpart of the reference's ``dream_generate`` (the remote-code
    ``model.diffusion_generate``): (sequences [B, P+G], history) on
    ``device``."""
    dev = resolve_device(device)
    sc = DreamSamplerConfig(
        steps=steps, max_new_tokens=max_new_tokens, temperature=temperature,
        top_p=top_p, top_k=top_k, alg=alg, alg_temp=alg_temp, mask_id=mask_id,
        exact=exact, batch_mean_counts=batch_mean_counts)
    prompt_ids = prompt_ids.to(dev)
    if attn_mask is not None:
        attn_mask = attn_mask.to(dev)
    sampler = make_dream_sampler(forward_fn, sc, output_history)
    return sampler(params, prompt_ids, attn_mask=attn_mask, generator=generator,
                   uniforms=uniforms)
