"""Seeds of a run's parts, all from ``--seed``.

Each part (the weights, the traffic, the warm-up batch, the sample the
comparison takes) gets a stream of its own, keyed by a tag, so adding a
draw to one part moves no other.  ``--seed`` may be any whole number that
fits 64 bits.
"""

from __future__ import annotations

import numpy as np
import torch

WEIGHTS, TRAFFIC, WARMUP, SAMPLE, NOISE = range(5)


def sub_seed(seed: int, tag: int, *more: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from ``seed`` and
    the part's tag."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), tag, *more])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def host_rng(seed: int, tag: int, *more: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2**64 - 1), tag, *more]))


def device_generator(seed: int, tag: int, device, *more: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag, *more))
    return gen
