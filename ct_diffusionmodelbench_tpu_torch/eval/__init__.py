from ct_diffusionmodelbench_tpu_torch.eval.runner import GenResult, ModelRunner
from ct_diffusionmodelbench_tpu_torch.eval.quality import evaluate_solution_quality
from ct_diffusionmodelbench_tpu_torch.eval.lean import (
    AsyncVerifier,
    FakeLeanVerifier,
    LakeProjectVerifier,
    LeanVerifier,
)
from ct_diffusionmodelbench_tpu_torch.eval.benchmark import BenchmarkConfig, DiffusionBenchmark
from ct_diffusionmodelbench_tpu_torch.eval.minif2f import extract_lean_code, run_minif2f_evaluation
from ct_diffusionmodelbench_tpu_torch.eval.analyzer import ModelAnalyzer

__all__ = ["AsyncVerifier", "BenchmarkConfig", "DiffusionBenchmark", "FakeLeanVerifier",
           "GenResult", "LakeProjectVerifier", "LeanVerifier", "ModelAnalyzer",
           "ModelRunner", "evaluate_solution_quality", "extract_lean_code",
           "run_minif2f_evaluation"]
