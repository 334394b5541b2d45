"""ctypes binding of the repository's native JPEG decoder (``native/holocron_loader.cpp``):
the port's own copy of ``holocron_tpu/utils/data/_native.py``. The service takes the
uint8 decode and resize (:func:`decode_batch_u8`); the classification CLI the fused
decode + RandomResizedCrop + flip of its training batches (:func:`decode_rrc_batch`)
and the normalized decode of its evaluation batches (:func:`native_collate`).

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
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...kernels._build import BUILD_DIR

__all__ = ["NativeImageFolder", "decode_batch", "decode_batch_u8", "decode_rrc_batch", "load_native",
           "native_available", "native_collate"]

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
    ints, doubles = [ctypes.c_int] * 3, [ctypes.c_double] * 5
    lib.hl_decode_u8_batch.argtypes = [_P, _P, *ints, _P, _P, ctypes.c_int]
    lib.hl_decode_batch.argtypes = [_P, _P, *ints, _P, _P, _P, _P, ctypes.c_int]
    lib.hl_decode_rrc_batch.argtypes = [_P, _P, *ints, *doubles, _P, _P, _P, ctypes.c_int]
    for fn in (lib.hl_decode_u8_batch, lib.hl_decode_batch, lib.hl_decode_rrc_batch):
        fn.restype = None
    return lib


def native_available() -> bool:
    return load_native() is not None


def _blob(jpeg_buffers: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """The buffers as one byte array and their ``n + 1`` offsets into it."""
    offsets = np.zeros(len(jpeg_buffers) + 1, dtype=np.uintp)
    offsets[1:] = np.cumsum([len(b) for b in jpeg_buffers])
    return np.frombuffer(b"".join(jpeg_buffers), dtype=np.uint8), offsets


def _library() -> ctypes.CDLL:
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native JPEG decoder is unavailable (no g++ or libjpeg)")
    return lib


def _check_size(out_h: int, out_w: int) -> None:
    if out_h < 1 or out_w < 1:
        raise ValueError(f"the output size must be positive, got {out_h} x {out_w}")


def _raise_on_failure(status: np.ndarray) -> None:
    if status.any():
        raise ValueError(f"failed to decode JPEG(s) at indices {np.nonzero(status)[0].tolist()}")


def decode_batch_u8(jpeg_buffers: Sequence[bytes], out_h: int, out_w: int, num_threads: int = 8) -> np.ndarray:
    """Decodes JPEG byte strings to a bilinearly resized (half-pixel centres)
    ``(N, out_h, out_w, 3)`` uint8 batch. Raises RuntimeError without the library and
    ValueError naming the buffers that failed to decode."""
    lib = _library()
    _check_size(out_h, out_w)
    blob, offsets = _blob(jpeg_buffers)
    n = len(jpeg_buffers)
    out = np.empty((n, out_h, out_w, 3), dtype=np.uint8)
    status = np.zeros(n, dtype=np.int32)
    lib.hl_decode_u8_batch(blob.ctypes.data, offsets.ctypes.data, n, out_h, out_w, out.ctypes.data,
                           status.ctypes.data, num_threads)
    _raise_on_failure(status)
    return out


def decode_batch(jpeg_buffers: Sequence[bytes], out_h: int, out_w: int, mean: Sequence[float],
                 std: Sequence[float], num_threads: int = 8) -> np.ndarray:
    """Decodes JPEG byte strings to a resized, normalized ``(N, out_h, out_w, 3)``
    float32 batch, ``(x / 255 - mean) / std`` (``_native.py:98-134``)."""
    lib = _library()
    _check_size(out_h, out_w)
    blob, offsets = _blob(jpeg_buffers)
    n = len(jpeg_buffers)
    out = np.empty((n, out_h, out_w, 3), dtype=np.float32)
    status = np.zeros(n, dtype=np.int32)
    mean_arr, std_arr = np.asarray(mean, dtype=np.float32), np.asarray(std, dtype=np.float32)
    lib.hl_decode_batch(blob.ctypes.data, offsets.ctypes.data, n, out_h, out_w, mean_arr.ctypes.data,
                        std_arr.ctypes.data, out.ctypes.data, status.ctypes.data, num_threads)
    _raise_on_failure(status)
    return out


def decode_rrc_batch(jpeg_buffers: Sequence[bytes], out_h: int, out_w: int, scale=(0.08, 1.0),
                     ratio=(3.0 / 4.0, 4.0 / 3.0), flip_prob: float = 0.5, seeds: Optional[Sequence[int]] = None,
                     num_threads: int = 8) -> np.ndarray:
    """JPEG decode + RandomResizedCrop + random horizontal flip in one native call
    (``_native.py:137-185``): a ``(N, out_h, out_w, 3)`` uint8 batch, each image's draws
    from its own 64-bit ``seeds`` entry (drawn from a fresh generator when None)."""
    lib = _library()
    _check_size(out_h, out_w)
    blob, offsets = _blob(jpeg_buffers)
    n = len(jpeg_buffers)
    out = np.empty((n, out_h, out_w, 3), dtype=np.uint8)
    status = np.zeros(n, dtype=np.int32)
    if seeds is None:
        seeds = np.random.default_rng().integers(1, 2**63, size=n, dtype=np.uint64)
    seeds_arr = np.ascontiguousarray(seeds, dtype=np.uint64)
    if seeds_arr.shape != (n,):
        raise ValueError(f"expected {n} seeds, got {seeds_arr.shape}")
    lib.hl_decode_rrc_batch(blob.ctypes.data, offsets.ctypes.data, n, out_h, out_w, float(scale[0]),
                            float(scale[1]), float(ratio[0]), float(ratio[1]), float(flip_prob),
                            seeds_arr.ctypes.data, out.ctypes.data, status.ctypes.data, num_threads)
    _raise_on_failure(status)
    return out


class NativeImageFolder:
    """A directory per class of JPEGs whose samples are the raw bytes and the class
    index (``_native.py:227-247``), for a collate that decodes natively."""

    def __init__(self, root: str) -> None:
        root_path = Path(root)
        self.classes = sorted(d.name for d in root_path.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = [
            (p, self.class_to_idx[c])
            for c in self.classes
            for p in sorted((root_path / c).rglob("*"))
            if p.suffix.lower() in {".jpg", ".jpeg"}
        ]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, target = self.samples[idx]
        return path.read_bytes(), target


class _NativeCollate:
    """The collate :func:`native_collate` builds; a class, so that it pickles into
    spawned loader workers."""

    def __init__(self, out_h: int, out_w: int, mean, std, center_crop: Optional[int], num_threads: int) -> None:
        self.out_h, self.out_w, self.mean, self.std = out_h, out_w, tuple(mean), tuple(std)
        self.center_crop, self.num_threads = center_crop, num_threads

    def __call__(self, batch: List) -> Tuple[torch.Tensor, torch.Tensor]:
        buffers, targets = zip(*batch)
        x = decode_batch(list(buffers), self.out_h, self.out_w, self.mean, self.std, self.num_threads)
        if self.center_crop is not None:
            off_h = (self.out_h - self.center_crop) // 2
            off_w = (self.out_w - self.center_crop) // 2
            x = np.ascontiguousarray(x[:, off_h : off_h + self.center_crop, off_w : off_w + self.center_crop])
        return torch.from_numpy(x).permute(0, 3, 1, 2), torch.as_tensor(np.asarray(targets))


def native_collate(out_h: int, out_w: int, mean, std, center_crop: Optional[int] = None,
                   num_threads: int = 8) -> _NativeCollate:
    """A collate of :class:`NativeImageFolder` samples (``_native.py:250-264``): decode,
    resize to ``(out_h, out_w)`` and normalize natively, then an optional centre crop
    (the evaluation batches of the classification CLI). Returns an NCHW float32 batch,
    an NCHW view of the decoded NHWC one, and the targets."""
    return _NativeCollate(out_h, out_w, mean, std, center_crop, num_threads)
