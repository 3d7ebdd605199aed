"""Quantize an HF-layout checkpoint directory to an int8 serving checkpoint.

    python -m ct_diffusionmodelbench_tpu_torch.quantize_ckpt --in DIR --out DIR [--device cpu]

Counterpart of ``tools/quantize_ckpt.py``: load, quantize every eligible
weight (``ops/quant.py``, per output channel, bit-equal to the reference's),
save in the int8 format of ``io/checkpoint.py`` and copy the tokenizer files
beside it.  ``ModelRunner.from_dir`` recognises the result by its
``config.json`` marker.  Quantization runs on the card unless ``--device``
names another; the weights are read into host memory first and moved one
leaf at a time.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from ct_diffusionmodelbench_tpu_torch.device import resolve_device
from ct_diffusionmodelbench_tpu_torch.io.checkpoint import (
    load_checkpoint, save_quantized_checkpoint)
from ct_diffusionmodelbench_tpu_torch.ops.quant import place_params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="src", required=True)
    ap.add_argument("--out", dest="dst", required=True)
    ap.add_argument("--device", default=None,
                    help="where to quantize (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, params = load_checkpoint(args.src, device="cpu")
    save_quantized_checkpoint(args.dst, cfg, place_params(params, dev, quantize=True))

    # Tokenizer files beside the weights, so from_dir finds them.
    src, dst = Path(args.src), Path(args.dst)
    for f in src.glob("tokenizer*"):
        shutil.copy(f, dst / f.name)
    for name in ("special_tokens_map.json", "generation_config.json"):
        if (src / name).exists():
            shutil.copy(src / name, dst / name)
    print(f"wrote int8 checkpoint to {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
