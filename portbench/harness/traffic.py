"""The one traffic generator: batches of prompts, or of training rows,
from a mix's parameters and the seed.

Eval mixes (``kind`` ``eval_decode``): every batch holds ``batch`` prompts.
Their lengths are drawn one per stratum of ``prompt_strata`` (each ``[lo,
hi]``, both ends included), in an order drawn from the seed: each batch
then covers the mix's range alike, so every seed gives the same padded
length and nearly the same work, in another order.  Ids are uniform in
``id_range`` and never the mask id.  Each batch is left-padded, with its
attention mask, to the runner's bucket of the longest prompt, as
``ModelRunner.generate_batch`` pads.

Training mixes (``kind`` ``sft``): rows of ``seq_len`` tokens, the
prompt's length of each uniform in ``prompt_range``, the rest the answer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

from portbench.harness import seeds


@dataclass
class PromptBatch:
    ids: np.ndarray        # [B, P] int64, left-padded
    mask: np.ndarray       # [B, P] int32, 1 = real token
    lengths: List[int]     # each row's prompt length, unpadded


def _ids(rng: np.random.Generator, n: int, id_range, mask_id: int) -> np.ndarray:
    lo, hi = id_range
    ids = rng.integers(lo, hi, size=n, dtype=np.int64)
    # Never the mask id: it would read as a position still to be denoised.
    return np.where(ids == mask_id, lo, ids)


def prompt_batch(mix: dict, rng: np.random.Generator, mask_id: int) -> PromptBatch:
    strata = mix["prompt_strata"]
    if len(strata) != mix["batch"]:
        raise ValueError(f"{len(strata)} prompt strata for a batch of {mix['batch']}")
    lengths = [int(rng.integers(lo, hi + 1)) for lo, hi in strata]
    lengths = [lengths[i] for i in rng.permutation(len(lengths))]
    bucket = mix["bucket"]
    p = -(-max(lengths) // bucket) * bucket
    ids = np.zeros((len(lengths), p), np.int64)
    mask = np.zeros((len(lengths), p), np.int32)
    for r, n in enumerate(lengths):
        ids[r, p - n:] = _ids(rng, n, mix["id_range"], mask_id)
        mask[r, p - n:] = 1
    return PromptBatch(ids, mask, lengths)


def prompt_batches(mix: dict, seed: int, mask_id: int,
                   tag: int = seeds.TRAFFIC) -> Iterator[PromptBatch]:
    """The mix's batches, endlessly, in the order the seed gives."""
    rng = seeds.host_rng(seed, tag)
    while True:
        yield prompt_batch(mix, rng, mask_id)


def sft_rows(mix: dict, seed: int, n: int, mask_id: int,
             tag: int = seeds.TRAFFIC) -> List[dict]:
    """``n`` training rows, each ``{"input_ids": [L ids], "prompt_lengths":
    p}``: all rows differ."""
    rng = seeds.host_rng(seed, tag)
    lo, hi = mix["prompt_range"]
    return [{"input_ids": _ids(rng, mix["seq_len"], mix["id_range"], mask_id).tolist(),
             "prompt_lengths": int(rng.integers(lo, hi + 1))} for _ in range(n)]
