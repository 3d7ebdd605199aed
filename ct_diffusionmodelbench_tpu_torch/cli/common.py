"""Shared CLI plumbing: model loading and the serving flags.

Counterpart of ``cli/common.py``: every serving CLI exposes the same
``--dp/--tp``, ``--accel``, ``--quant`` and ``--parallel-threshold`` flags
and the same ``--model-dir``/``--preset`` loading rules.  ``--accel
block-cache`` and ``--parallel-threshold`` reach the runner, which refuses
them for the Dream/DiffuCoder families.  ``--device`` is how a caller asks
for the CPU, where the reference reads ``JAX_PLATFORMS``: the default is
the card.

``--dp``/``--tp`` above 1 serve over a ``parallel/`` mesh, one process per
rank::

    torchrun --nproc-per-node 2 -m ct_diffusionmodelbench_tpu_torch.cli.chat \
        --preset llada-moe-7b --tp 2 --prompt "..."

Every rank decodes; :func:`rank_zero_output` keeps the others from
printing, verifying or writing result files.
"""

from __future__ import annotations

import contextlib
import io
import shutil
import tempfile

from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
from ct_diffusionmodelbench_tpu_torch.parallel.mesh import is_main_process


def add_device_flag(p) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="Device to run on (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain PyTorch versions)")


def add_parallel_flags(p) -> None:
    add_mesh_flags(p)
    p.add_argument("--accel", type=str, default=None,
                   choices=["block-cache"],
                   help="Opt-in approximate acceleration: 'block-cache' = "
                        "Fast-dLLM-style dual KV cache (per-step compute "
                        "drops from full-sequence to the active block; "
                        "LLaDA families). Default: the exact sampler")
    p.add_argument("--quant", type=str, default=None,
                   choices=["int8"],
                   help="Opt-in weight-only int8 quantization (per-output-"
                        "channel symmetric): experts through the int8 grouped "
                        "kernels, dense products cast before cuBLAS. "
                        "Approximate (weight rounding)")
    p.add_argument("--parallel-threshold", type=float, default=None,
                   help="Opt-in Fast-dLLM confidence-threshold parallel "
                        "decoding: unmask every position whose confidence "
                        "exceeds this (e.g. 0.9) each step instead of the "
                        "fixed schedule (LLaDA families; composes with "
                        "--accel block-cache). Default: the reference's fixed "
                        "transfer schedule")
    add_device_flag(p)


def add_mesh_flags(p) -> None:
    p.add_argument("--dp", type=int, default=1,
                   help="Data-parallel mesh axis (batch rows split over it); "
                        "launch dp·tp processes with torchrun")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel mesh axis (heads / FFN / experts / "
                        "vocab split over it)")
    p.add_argument("--dist-backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl with a card "
                        "per rank, gloo on the CPU; gloo is the choice for "
                        "ranks sharing a card)")


@contextlib.contextmanager
def rank_zero_output(args):
    """On ranks other than 0: stdout discarded, verification off and the
    CLIs' result directories pointed at a temporary directory that is
    removed afterwards.  Rank 0 (or a run without a process group) is
    untouched."""
    if is_main_process():
        yield args
        return
    scratch = tempfile.mkdtemp(prefix="ctdb-rank-")
    dirs = ("output_dir", "results_dir", "save_dir")
    saved = {a: getattr(args, a) for a in dirs + ("no_verify",) if hasattr(args, a)}
    for a in dirs:
        if hasattr(args, a):
            setattr(args, a, scratch)
    if hasattr(args, "no_verify"):
        args.no_verify = True
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            yield args
    finally:
        for a, v in saved.items():
            setattr(args, a, v)
        shutil.rmtree(scratch, ignore_errors=True)


def runner_from_args(args) -> ModelRunner:
    """--preset (random weights) or --model-dir (HF or int8 checkpoint) on
    ``--device``, over a ``--dp``/``--tp`` mesh when either is above 1."""
    mesh_kw = dict(dp=getattr(args, "dp", 1), tp=getattr(args, "tp", 1),
                   backend=getattr(args, "dist_backend", None))
    accel = getattr(args, "accel", None)
    quant = getattr(args, "quant", None)
    mask_id = getattr(args, "mask_id", None)
    device = getattr(args, "device", None)
    if getattr(args, "preset", None):
        runner = ModelRunner.random_init(args.preset, accel=accel, quant=quant,
                                         device=device, **mesh_kw)
        if mask_id is not None:
            runner.mask_id = mask_id
    elif getattr(args, "model_dir", None):
        runner = ModelRunner.from_dir(args.model_dir, mask_id_override=mask_id,
                                      accel=accel, quant=quant, device=device,
                                      **mesh_kw)
    else:
        raise SystemExit("need --model-dir or --preset")
    runner.parallel_threshold = getattr(args, "parallel_threshold", None)
    return runner
