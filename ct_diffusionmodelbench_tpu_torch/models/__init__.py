from ct_diffusionmodelbench_tpu_torch.models.config import (
    PRESETS, ModelConfig, config_from_hf, get_config)
from ct_diffusionmodelbench_tpu_torch.models.transformer import (
    forward, init_params, make_forward_fn)

__all__ = ["PRESETS", "ModelConfig", "config_from_hf", "get_config",
           "forward", "init_params", "make_forward_fn"]
