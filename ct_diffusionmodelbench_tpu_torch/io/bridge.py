"""Parameter bridge: a JAX parameter pytree (numpy leaves) → the port's
dict of tensors, same keys, same layer-stacked ``[L, ...]`` layout (the
expert stacks stay ``[L, E, D, Fm]``).

Used by the parity tests to run both frameworks on identical weights.
``np.asarray`` of a bf16 JAX array is an ``ml_dtypes.bfloat16`` array, which
``torch.from_numpy`` rejects, so bf16 leaves travel as their uint16 bits.

:func:`shard_from_numpy` takes the tree straight to one rank's shard of a
``parallel/`` mesh: each leaf is sliced on the host before it moves, so
ranks that share a card never each hold the full model there.
"""

from __future__ import annotations

import numpy as np
import torch

from ct_diffusionmodelbench_tpu_torch.device import DeviceLike, resolve_device
from ct_diffusionmodelbench_tpu_torch.parallel.sharding import local_specs, shard_leaf


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


def shard_from_numpy(cfg, tree, mesh):
    """A full parameter tree (numpy leaves) → this rank's shard on its
    device (``parallel/sharding.py::local_specs``)."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return tensor_from_numpy(shard_leaf(np.asarray(node), spec, mesh), mesh.device)

    return walk(tree, local_specs(cfg, mesh.model))
