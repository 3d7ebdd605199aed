from ct_diffusionmodelbench_tpu_torch.eval.runner import GenResult, ModelRunner

__all__ = ["GenResult", "ModelRunner"]
