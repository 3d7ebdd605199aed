"""PyTorch/CUDA port of ``ct_diffusionmodelbench_tpu`` for NVIDIA Hopper.

The JAX/Pallas package stays the reference; this package mirrors its module
layout (``models/``, ``ops/``, ``sampling/``) so each function has a named
counterpart.  It imports ``torch`` and never JAX or the JAX package.

The Pallas kernels of the main decode path are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use into
``build/cuda_kernels/`` and bound with ``ctypes`` (ops/cuda_build.py).  Each
kernel has a plain PyTorch version in the same module: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.

Entry points (``models.init_params``, ``models.make_forward_fn``,
``sampling.llada_generate``) run on ``cuda`` unless ``device="cpu"`` is
passed; with no card and no explicit device they raise.
"""
