from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy, tensor_from_numpy
from ct_diffusionmodelbench_tpu_torch.io.datasets_io import (
    MATH_OLYMPIAD_DATASET,
    NUMINA_DATASET,
    format_instruction_lean_sft,
    format_instruction_problem,
    load_hub_or_local,
    load_minif2f,
    pick_bench_split,
    split_80_10_10,
    split_fresh_for_inference,
    split_val_from_training,
)

__all__ = ["MATH_OLYMPIAD_DATASET", "NUMINA_DATASET", "format_instruction_lean_sft",
           "format_instruction_problem", "load_hub_or_local", "load_minif2f",
           "params_from_numpy", "pick_bench_split", "split_80_10_10",
           "split_fresh_for_inference", "split_val_from_training", "tensor_from_numpy"]
