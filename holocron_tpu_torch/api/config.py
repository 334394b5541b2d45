"""Service configuration (``api/app/config.py``): the same environment names and
defaults, plus ``HOLOCRON_DEVICE``."""

import os

import torch

PROJECT_NAME: str = os.environ.get("PROJECT_NAME", "holocron-tpu API")
PROJECT_DESCRIPTION: str = "Image classification API built on holocron-tpu"
VERSION: str = "0.1.0.dev0"
ARCH: str = os.environ.get("HOLOCRON_ARCH", "rexnet1_0x")
NUM_CLASSES: int = int(os.environ.get("HOLOCRON_NUM_CLASSES", "10"))
CHECKPOINT: str = os.environ.get("HOLOCRON_CHECKPOINT", "")
HOST: str = os.environ.get("API_HOST", "0.0.0.0")
PORT: int = int(os.environ.get("API_PORT", "8050"))
MAX_BATCH: int = int(os.environ.get("HOLOCRON_MAX_BATCH", "8"))
BATCH_WAIT_MS: float = float(os.environ.get("HOLOCRON_BATCH_WAIT_MS", "5"))
# serve the selective-int8 form (holocron_tpu_torch.quant): "1" follows the arch's
# measured verdict (recommended_quantization; the float form where int8 loses or was
# not measured), "force" quantizes regardless
_q = os.environ.get("HOLOCRON_QUANTIZE", "0")
QUANTIZE = "force" if _q == "force" else _q == "1"
# where the model runs: the card unless the CPU is asked for (tests)
DEVICE: str = os.environ.get("HOLOCRON_DEVICE", "cuda")


def device() -> torch.device:
    """:data:`DEVICE` as a ``torch.device``; raises for a CUDA device where there is none
    (no quiet CPU fallback)."""
    dev = torch.device(DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"HOLOCRON_DEVICE is {DEVICE!r} but no CUDA device is available; "
                           "set HOLOCRON_DEVICE=cpu to serve on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"HOLOCRON_DEVICE must be cuda or cpu, got {DEVICE!r}")
    return dev
