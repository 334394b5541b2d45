"""Builds the package's CUDA sources with ``nvcc`` and binds them with ``ctypes``.

Each ``holocron_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and becomes its
own shared library ``_build/<name>-<digest>.so``, where the digest covers the source
and the compiler flags, so an edit rebuilds and an unchanged source is reused. Nothing
is built when this module is imported: a library is built on its first use, or up
front, in parallel, by :func:`build`. ``nvcc``'s resource report (``-Xptxas -v``) is
kept beside each library as ``<name>-<digest>.log``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

__all__ = ["BUILD_DIR", "CSRC", "FLOAT_DTYPES", "Kernel", "build", "cuda_operands", "library_path", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
# the dtype codes of the float kernels' C entry points
FLOAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> List[Path]:
    """Compiles the named sources that are not built yet, one ``nvcc`` each, all at
    once. Raises with the compiler's output if any fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, target, tmp, proc))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent process never loads a half-written file
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return [library_path(name) for name in names]


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        (path,) = build([name])
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


class Kernel:
    """One C entry point of a built library, with its launch count.

    Every entry point returns the ``cudaGetLastError()`` that follows its launch; a
    non-zero code raises here, because a refused launch never runs and a later
    synchronize would not report it. ``launches`` counts successful launches.
    """

    def __init__(self, library: str, symbol: str, argtypes: Sequence) -> None:
        self.library, self.symbol, self.argtypes = library, symbol, list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = load(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            lib.holocron_cuda_error_string.argtypes = [ctypes.c_int]
            lib.holocron_cuda_error_string.restype = ctypes.c_char_p
            self._fn, self._lib = fn, lib
        err = self._fn(*args)
        if err != 0:
            msg = self._lib.holocron_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def cuda_operands(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors, contiguous, after checking that they lie on one CUDA device in one
    of :data:`FLOAT_DTYPES`; raises otherwise."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"expected tensors on one CUDA device, got {[str(t.device) for t in tensors]}")
    if dtype not in FLOAT_DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"expected float32 or bfloat16 tensors of one dtype, got {[t.dtype for t in tensors]}")
    return tuple(t.contiguous() for t in tensors)
