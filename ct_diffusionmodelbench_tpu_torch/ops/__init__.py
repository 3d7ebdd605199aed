"""Attention, grouped expert GEMMs, sampler primitives, and the build of
the hand-written CUDA kernels (``cuda_build``)."""
