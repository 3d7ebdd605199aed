from ct_diffusionmodelbench_tpu_torch.sampling.llada import (
    LLaDASamplerConfig, llada_generate, make_llada_sampler)
from ct_diffusionmodelbench_tpu_torch.sampling.dream import (
    DreamSamplerConfig, dream_generate, make_dream_sampler)

__all__ = ["LLaDASamplerConfig", "llada_generate", "make_llada_sampler",
           "DreamSamplerConfig", "dream_generate", "make_dream_sampler"]
