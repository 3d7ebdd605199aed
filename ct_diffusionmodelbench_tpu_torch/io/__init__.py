from ct_diffusionmodelbench_tpu_torch.io.bridge import params_from_numpy, tensor_from_numpy

__all__ = ["params_from_numpy", "tensor_from_numpy"]
