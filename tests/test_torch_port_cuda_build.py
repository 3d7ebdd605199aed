"""The port's kernel build bookkeeping, on the CPU (no nvcc needed).

A library is named by a hash of its source, the ``csrc/`` headers it
includes and the nvcc flags, so an edited header rebuilds every source that
includes it instead of loading a stale library from ``build/cuda_kernels/``.
"""

from pathlib import Path

import pytest

from ct_diffusionmodelbench_tpu_torch.ops import cuda_build
from ct_diffusionmodelbench_tpu_torch.ops import flash_attention as fa
from ct_diffusionmodelbench_tpu_torch.ops import flash_attention_bwd as fab
from ct_diffusionmodelbench_tpu_torch.ops import grouped_gemm_cuda as gg


def _write(path: Path, text: str) -> Path:
    path.write_text(text)
    return path


def test_local_headers_are_followed_once(tmp_path):
    src = _write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n#include "a.cuh"\n'
                                    '  #  include "b.cuh"\n')
    _write(tmp_path / "a.cuh", '#pragma once\n#include "c.cuh"\n#include "b.cuh"\n')
    _write(tmp_path / "b.cuh", "#pragma once\n")
    _write(tmp_path / "c.cuh", '#pragma once\n#include "a.cuh"\n')
    got = [h.name for h in cuda_build.local_headers(src)]
    assert sorted(got) == ["a.cuh", "b.cuh", "c.cuh"] and len(got) == 3


def test_library_path_changes_with_an_included_header(tmp_path):
    src = _write(tmp_path / "k.cu", '#include "h.cuh"\nint f() { return G; }\n')
    header = _write(tmp_path / "h.cuh", "#define G 1\n")
    lib = cuda_build.Library("flash_attention.cu")
    lib.source = src
    before = lib.path
    assert lib.path == before                      # stable while nothing changes
    header.write_text("#define G 2\n")
    assert lib.path != before
    assert lib.path.name.startswith("k-") and lib.path.parent == cuda_build.BUILD_DIR


@pytest.mark.parametrize("library", [fa.LIBRARY, fab.LIBRARY, gg.LIBRARY_Q, gg.LIBRARY,
                                     gg.LIBRARY_FUSED, fa.LIBRARY_DIRECT])
def test_flash_sources_hash_the_shared_header(library):
    """Every source that includes the shared Hopper header (the flash
    kernels, the bf16 and int8 grouped pairs and the fused expert FFN)
    hashes it."""
    assert [h.name for h in cuda_build.local_headers(library.source)] == ["hopper_mma.cuh"]


def test_sources_without_local_headers_hash_only_themselves(tmp_path):
    """A source that includes only system headers (every kernel source now
    includes the shared Hopper header, so a written one stands in)."""
    src = _write(tmp_path / "k.cu", "#include <cuda_runtime.h>\nint f() { return 0; }\n")
    assert cuda_build.local_headers(src) == []
    lib = cuda_build.Library("flash_attention.cu")
    lib.source = src
    before = lib.path
    src.write_text("#include <cuda_runtime.h>\nint f() { return 1; }\n")
    assert lib.path != before
