"""Batch collation with the reference's variable-length training trick.

Counterpart of ``train/collator.py``, kept line for line: the same
``random.Random(seed)`` draws in the same order, so a seeded collator gives
the JAX trainer's batches exactly.  Pad to the longest sequence in the batch
(capped at ``max_length``) with pad-id (falling back to eos-id); with
probability ``varlen_prob`` sample a shorter target length in
``[varlen_min, max_length]``, never below the batch's longest prompt; round
the padded length up to a multiple of ``bucket``.  Returns numpy arrays; the
trainer moves them to its device.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np


class DiffusionCollator:
    def __init__(
        self,
        pad_token_id: Optional[int],
        eos_token_id: Optional[int],
        max_length: int = 2048,
        variable_length: bool = True,
        varlen_prob: float = 0.01,
        varlen_min: int = 8,
        bucket: int = 64,
        seed: int = 0,
    ):
        pid = pad_token_id if pad_token_id is not None else eos_token_id
        if pid is None:
            raise ValueError("need a pad or eos token id")
        self.pad_id = pid
        self.max_length = max_length
        self.variable_length = variable_length
        self.varlen_prob = varlen_prob
        self.varlen_min = varlen_min
        self.bucket = max(bucket, 1)
        self._rng = random.Random(seed)

    def _bucketed(self, n: int) -> int:
        b = self.bucket
        return min(((n + b - 1) // b) * b, self.max_length) if b > 1 else n

    def __call__(self, features: Sequence[Dict], train: bool = True) -> Dict[str, np.ndarray]:
        input_ids: List[List[int]] = [list(f["input_ids"]) for f in features]
        prompt_lengths = [int(f["prompt_lengths"]) for f in features]

        base_len = min(max(len(ids) for ids in input_ids), self.max_length)
        max_prompt_len = max(prompt_lengths) if prompt_lengths else 0

        max_len = base_len
        if train and self.variable_length and self._rng.random() < self.varlen_prob:
            sampled = self._rng.randint(self.varlen_min, self.max_length)
            max_len = max(min(sampled, self.max_length), max_prompt_len, 1)
        max_len = self._bucketed(max_len)

        out_ids = np.full((len(input_ids), max_len), self.pad_id, np.int32)
        out_plens = np.zeros((len(input_ids),), np.int32)
        for row, (ids, plen) in enumerate(zip(input_ids, prompt_lengths)):
            ids = ids[:max_len]
            out_ids[row, : len(ids)] = ids
            out_plens[row] = min(plen, max_len)
        return {"input_ids": out_ids, "prompt_lengths": out_plens}
