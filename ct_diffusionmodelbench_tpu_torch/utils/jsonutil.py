"""JSON sanitization for result artifacts.

Counterpart of ``utils/jsonutil.py``: numpy scalars and arrays, and here
torch tensors, become plain Python values before ``json.dump``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {key: to_jsonable(value) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(item) for item in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return obj.tolist()
    return obj
