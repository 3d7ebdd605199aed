"""Parameter bridge: a JAX parameter pytree (numpy leaves) → the port's
dict of tensors, same keys, same layer-stacked ``[L, ...]`` layout (the
expert stacks stay ``[L, E, D, Fm]``).

Used by the parity tests to run both frameworks on identical weights.
``np.asarray`` of a bf16 JAX array is an ``ml_dtypes.bfloat16`` array, which
``torch.from_numpy`` rejects, so bf16 leaves travel as their uint16 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device


def tensor_from_numpy(a, device: DeviceLike = None) -> torch.Tensor:
    """One leaf: numpy (or array-like) → tensor on ``device``, bit-exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = bits.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(resolve_device(device))


def params_from_numpy(tree, device: DeviceLike = None):
    """Nested dict of array leaves → the same nesting of tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)
