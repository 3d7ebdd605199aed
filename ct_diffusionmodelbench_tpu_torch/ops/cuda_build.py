"""Build and bind the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  Nothing
is built at import: a library is built at its first use (or all at once,
in parallel, by :func:`build_all`) into ``build/cuda_kernels/`` at the repo
root, named by a hash of its source, the ``csrc/`` headers it includes and
the flags, so a changed source or header rebuilds.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises on a non-zero code and counts
the launches it made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-lineinfo", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> List[Path]:
    """The ``#include "..."`` files of ``source`` that sit beside it, and
    theirs, each once, in the order first met."""
    found: List[Path] = []
    todo = [source]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop().read_text()):
            header = source.parent / name
            if header.exists() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class Library:
    """One ``csrc/*.cu`` source and the shared library built from it."""

    def __init__(self, source: str):
        self.source = CSRC_DIR / source
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in local_headers(self.source):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless the library is already built."""
        out = self.path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        try:
            return subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                stdout=log, stderr=subprocess.STDOUT)
        finally:
            log.close()

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        rc = proc.wait()
        out = self.path
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if rc != 0:
            log = out.with_suffix(".log").read_text()
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(rc {rc}):\n{log}")
        os.replace(tmp, out)

    def handle(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            self._lib = ctypes.CDLL(str(self.path))
        return self._lib


class Kernel:
    """A C entry point of a :class:`Library` with a launch counter.

    ``launches`` goes up by one for every successful launch through
    ``__call__`` and nowhere else."""

    def __init__(self, name: str, library: Library, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(self.library.handle(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def build_all(libraries: Sequence[Library]) -> float:
    """Build every library not yet built, one nvcc per source, all started
    together; returns the wall seconds it took."""
    t0 = time.perf_counter()
    procs: List = [(lib, lib.start_build()) for lib in libraries]
    errors = []
    for lib, proc in procs:
        try:
            lib.finish_build(proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.handle()
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


# ctypes argument kinds, for the Kernel argtypes lists.
PTR = ctypes.c_void_p
INT = ctypes.c_int
INT64 = ctypes.c_int64
FLOAT = ctypes.c_float


def dtype_code(name: str, dtype) -> int:
    """The C entry points' code of a tensor dtype: 0 float32, 1 bfloat16;
    raises for any other."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"{name} has dtype {dtype}, expected float32 or bfloat16")
    return codes[dtype]
