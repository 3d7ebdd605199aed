"""Shared CLI plumbing: model loading and the serving flags.

Counterpart of ``cli/common.py``: every serving CLI exposes the same
``--dp/--tp``, ``--accel``, ``--quant`` and ``--parallel-threshold`` flags
and the same ``--model-dir``/``--preset`` loading rules.  Meshes (``--dp``
or ``--tp`` above 1) are not ported yet and raise; ``--accel`` and
``--parallel-threshold`` reach the runner, which refuses what it does not
serve.  ``--device`` is how a caller asks for the CPU, where the reference
reads ``JAX_PLATFORMS``: the default is the card.
"""

from __future__ import annotations

from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner


def add_device_flag(p) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="Device to run on (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain PyTorch versions)")


def add_parallel_flags(p) -> None:
    p.add_argument("--dp", type=int, default=1,
                   help="Data-parallel mesh axis (not ported yet: above 1 "
                        "raises)")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel mesh axis (not ported yet: above 1 "
                        "raises)")
    p.add_argument("--accel", type=str, default=None,
                   choices=["block-cache"],
                   help="Opt-in approximate acceleration: 'block-cache' = "
                        "Fast-dLLM-style dual KV cache (not ported yet: the "
                        "runner refuses it). Default: the exact sampler")
    p.add_argument("--quant", type=str, default=None,
                   choices=["int8"],
                   help="Opt-in weight-only int8 quantization (per-output-"
                        "channel symmetric): experts through the int8 grouped "
                        "kernels, dense products cast before cuBLAS. "
                        "Approximate (weight rounding)")
    p.add_argument("--parallel-threshold", type=float, default=None,
                   help="Opt-in Fast-dLLM confidence-threshold parallel "
                        "decoding (not ported yet: the runner refuses it). "
                        "Default: the reference's fixed transfer schedule")
    add_device_flag(p)


def runner_from_args(args) -> ModelRunner:
    """--preset (random weights) or --model-dir (HF or int8 checkpoint) on
    ``--device``."""
    dp = getattr(args, "dp", 1)
    tp = getattr(args, "tp", 1)
    if dp > 1 or tp > 1:
        raise NotImplementedError(
            f"--dp {dp} / --tp {tp}: meshes (TP/DP serving) are not ported "
            "yet (ROADMAP Queue 1 #7)")
    accel = getattr(args, "accel", None)
    quant = getattr(args, "quant", None)
    mask_id = getattr(args, "mask_id", None)
    device = getattr(args, "device", None)
    if getattr(args, "preset", None):
        runner = ModelRunner.random_init(args.preset, accel=accel, quant=quant,
                                         device=device)
        if mask_id is not None:
            runner.mask_id = mask_id
    elif getattr(args, "model_dir", None):
        runner = ModelRunner.from_dir(args.model_dir, mask_id_override=mask_id,
                                      accel=accel, quant=quant, device=device)
    else:
        raise SystemExit("need --model-dir or --preset")
    runner.parallel_threshold = getattr(args, "parallel_threshold", None)
    return runner
