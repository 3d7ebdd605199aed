"""Published peaks of the cards the benchmark runs on, by CUDA device name.

NVIDIA's data sheet for the H100 SXM part, dense rates without sparsity,
at its full 700 W: 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the
tensor cores, 3.35 TB/s of HBM.  The longest matching name prefix wins; an
unknown card has no peak, and the metrics that need one are left out.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    best = max((k for k in PEAKS if kind.startswith(k)), key=len, default=None)
    return PEAKS[best] if best else None
