from ct_diffusionmodelbench_tpu_torch.models.config import (
    PRESETS, ModelConfig, config_from_hf, get_config)
from ct_diffusionmodelbench_tpu_torch.models.transformer import (
    forward, init_params, make_forward_fn)
from ct_diffusionmodelbench_tpu_torch.models.block_cache import make_cached_fns
from ct_diffusionmodelbench_tpu_torch.models.sdar_cache import make_sdar_fns

__all__ = ["PRESETS", "ModelConfig", "config_from_hf", "get_config",
           "forward", "init_params", "make_forward_fn", "make_cached_fns", "make_sdar_fns"]
