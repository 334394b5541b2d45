"""ctypes binding of the repository's native JPEG decoder (``native/holocron_loader.cpp``)
for the service's host-side decode: the port's own copy of
``holocron_tpu/utils/data/_native.py:31-95,188-227``, reduced to the uint8 decode and
resize the service takes.

The library is built from that source with ``g++ ... -ljpeg`` on first use, with the
flags of ``native/Makefile``, into ``holocron_tpu_torch/_build/`` (the source's
``native/`` directory is left as it is). Its file name carries a digest of the source,
the flags and this host's CPU (the build targets ``-march=native``), so an edit or
another machine rebuilds. :func:`load_native` returns None where there is no compiler
or no libjpeg, as the JAX package's does; the service then decodes with PIL.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ...kernels._build import BUILD_DIR

__all__ = ["decode_batch_u8", "load_native", "native_available"]

SOURCE = Path(__file__).resolve().parents[3] / "native" / "holocron_loader.cpp"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"]  # native/Makefile
_P = ctypes.c_void_p


def _cpu_signature() -> bytes:
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    return "\n".join(dict.fromkeys(l for l in lines if l.startswith(("model name", "flags")))).encode()


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode() + _cpu_signature()).hexdigest()[:16]
    return BUILD_DIR / f"holocron_loader-{digest}.so"


@functools.cache
def load_native() -> Optional[ctypes.CDLL]:
    """The decoder's library, built first if needed; None where it cannot be built or
    loaded, or is older than the uint8 entry point (``hl_version() < 3``)."""
    target = _library_path()
    if not target.exists():
        cxx = shutil.which("g++")
        if cxx is None or not SOURCE.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        try:
            subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE), "-ljpeg", "-lpthread"], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, target)  # atomic: a concurrent process never loads a half-written file
    try:
        lib = ctypes.CDLL(str(target))
    except OSError:
        return None
    lib.hl_version.argtypes, lib.hl_version.restype = [], ctypes.c_int
    if lib.hl_version() < 3:
        return None
    lib.hl_decode_u8_batch.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int]
    lib.hl_decode_u8_batch.restype = None
    return lib


def native_available() -> bool:
    return load_native() is not None


def decode_batch_u8(jpeg_buffers: Sequence[bytes], out_h: int, out_w: int, num_threads: int = 8) -> np.ndarray:
    """Decodes JPEG byte strings to a bilinearly resized (half-pixel centres)
    ``(N, out_h, out_w, 3)`` uint8 batch. Raises RuntimeError without the library and
    ValueError naming the buffers that failed to decode."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native JPEG decoder is unavailable (no g++ or libjpeg)")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"the output size must be positive, got {out_h} x {out_w}")
    n = len(jpeg_buffers)
    blob = np.frombuffer(b"".join(jpeg_buffers), dtype=np.uint8)
    offsets = np.zeros(n + 1, dtype=np.uintp)
    offsets[1:] = np.cumsum([len(b) for b in jpeg_buffers])
    out = np.empty((n, out_h, out_w, 3), dtype=np.uint8)
    status = np.zeros(n, dtype=np.int32)
    lib.hl_decode_u8_batch(blob.ctypes.data, offsets.ctypes.data, n, out_h, out_w, out.ctypes.data,
                           status.ctypes.data, num_threads)
    if status.any():
        raise ValueError(f"failed to decode JPEG(s) at indices {np.nonzero(status)[0].tolist()}")
    return out
