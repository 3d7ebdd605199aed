from ct_diffusionmodelbench_tpu_torch.sampling.llada import (
    LLaDASamplerConfig, llada_generate, make_llada_sampler)

__all__ = ["LLaDASamplerConfig", "llada_generate", "make_llada_sampler"]
