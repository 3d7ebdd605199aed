"""safetensors reader and writer on torch tensors alone.

Counterpart of ``io/safetensors_io.py`` (which reads bf16 through
``ml_dtypes``; the port has neither ``ml_dtypes`` nor the ``safetensors``
package).  The format:

    [8 bytes little-endian u64 header length][JSON header][raw tensor data]

with the header mapping tensor name → {dtype, shape, data_offsets} plus an
optional ``__metadata__`` dict.  Tensors are written as their raw bytes (a
``uint8`` view of the contiguous CPU copy, so bf16 keeps its bits).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional

import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _raw_bytes(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as a flat uint8 CPU tensor (C order)."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


def save_safetensors(path: str | Path, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write tensors in safetensors layout (insertion order)."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        dt = _DTYPE_NAMES.get(t.dtype)
        if dt is None:
            raise TypeError(f"unsupported dtype {t.dtype} for tensor {name!r}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": dt, "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * ((8 - len(blob) % 8) % 8)  # HF pads the header to 8 bytes

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(_raw_bytes(t).numpy())


def load_safetensors(path: str | Path) -> Dict[str, torch.Tensor]:
    """Read every tensor into CPU memory."""
    data = bytearray(Path(path).read_bytes())
    header_len = int.from_bytes(data[:8], "little")
    header = json.loads(bytes(data[8:8 + header_len]))
    base = 8 + header_len
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        raw = torch.frombuffer(data, dtype=torch.uint8, count=hi - lo,
                               offset=base + lo) if hi > lo else \
            torch.empty(0, dtype=torch.uint8)
        out[name] = raw.view(_DTYPES[info["dtype"]]).reshape(info["shape"]).clone()
    return out


def read_metadata(path: str | Path) -> dict:
    """The header's ``__metadata__`` dict ({} when there is none), without
    reading the tensors."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
    return header.get("__metadata__", {})


def shard_tensors(tensors: Mapping[str, torch.Tensor],
                  max_shard_bytes: int) -> Iterable[Dict[str, torch.Tensor]]:
    """Greedy sharding by insertion order, as HF's
    ``save_pretrained(max_shard_size=...)``."""
    shard: Dict[str, torch.Tensor] = {}
    size = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        if shard and size + n > max_shard_bytes:
            yield shard
            shard, size = {}, 0
        shard[name] = t
        size += n
    if shard:
        yield shard
