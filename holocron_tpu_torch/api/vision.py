"""Model loading and preprocessing for the inference service (``api/app/vision.py``).

The service runs the deploy form of the configured model (reparametrized where the
model can be, int8 under ``HOLOCRON_QUANTIZE``) in float32, as the JAX service serves
it, through :func:`..models.core.deploy_forward`: one CUDA graph a power-of-two batch
bucket, uint8 images in, ``/255``, mean/std and softmax inside the graph. The graphs
are captured with cuDNN's TF32 off (torch's default allows it in convolutions), so
float32 is served in full float32.
"""

import io
import logging
import math
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import models
from ..models.core import cudnn_settings, deploy_forward
from ..models.presets import IMAGENETTE
from . import config

IMAGE_SIZE = 224
SEED = 0

MODEL = None
BATCHER = None
CLASSES: List[str] = IMAGENETTE.classes
_LOCK = threading.RLock()  # one model and one capture, whichever request comes first


def load_model(arch: Optional[str] = None, num_classes: Optional[int] = None) -> torch.nn.Module:
    """The model the service runs, on :func:`.config.device`, in eval mode: the seeded
    factory of ``arch`` in float32; ``HOLOCRON_CHECKPOINT``'s weights where set (the
    port trainer's ``save`` format or a bare ``state_dict``, read with
    ``torch.load(weights_only=True)``); reparametrized where the model can be; and under
    ``HOLOCRON_QUANTIZE`` its selective-int8 form with per-call activation scales."""
    arch = config.ARCH if arch is None else arch
    num_classes = config.NUM_CLASSES if num_classes is None else num_classes
    device = config.device()
    model = getattr(models, arch)(num_classes=num_classes, generator=torch.Generator().manual_seed(SEED),
                                  device=device).eval()
    if config.CHECKPOINT:
        state = torch.load(config.CHECKPOINT, map_location=device, weights_only=True)
        model.load_state_dict(state.get("model", state))
    if hasattr(model, "reparametrize"):
        model.reparametrize()
    model = model.to(memory_format=torch.channels_last)
    if config.QUANTIZE:
        from ..quant import quantize_model, recommended_quantization

        # the measured per-arch verdict: int8 where it was measured faster on the card;
        # unmeasured archs fall back too. Only "force" quantizes regardless.
        verdict = recommended_quantization(arch)
        if config.QUANTIZE != "force" and (verdict is None or not verdict["recommended"]):
            reason = (
                f"int8 measures {verdict['int8_speedup']:.2f}x bf16 on {arch} (holocron_tpu_torch.quant)"
                if verdict is not None
                else f"{arch} has no measured int8 verdict (holocron_tpu_torch.quant.INT8_VERDICTS)"
            )
            logging.getLogger(__name__).warning(
                f"HOLOCRON_QUANTIZE requested but {reason}: serving float32; "
                "set HOLOCRON_QUANTIZE=force to override"
            )
            return model
        # per-call activation scales: no calibration set exists at serving time
        return quantize_model(model, arch=arch)
    return model


def get_model() -> torch.nn.Module:
    global MODEL
    with _LOCK:
        if MODEL is None:
            MODEL = load_model()
        return MODEL


def get_batcher():
    """The micro-batcher over the captured forward: concurrent requests coalesce into
    one padded graph replay (power-of-two buckets up to ``MAX_BATCH``, see
    :mod:`.batcher`). The batch crosses to the card as uint8."""
    global BATCHER
    with _LOCK:
        if BATCHER is None:
            from .batcher import MicroBatcher

            model = get_model()
            device = config.device()
            buckets = [1 << i for i in range(math.ceil(math.log2(max(config.MAX_BATCH, 1))) + 1)]
            with cudnn_settings(benchmark=True, deterministic=False, allow_tf32=False):
                fwd = deploy_forward(model, buckets, IMAGE_SIZE, (IMAGENETTE.mean, IMAGENETTE.std))

            def infer(batch: np.ndarray) -> np.ndarray:
                return fwd(torch.from_numpy(batch)).cpu().numpy()

            BATCHER = MicroBatcher(infer, max_batch=config.MAX_BATCH, max_wait_ms=config.BATCH_WAIT_MS, device=device)
        return BATCHER


def reset() -> None:
    """Stops the batcher and drops the model, so that the next request loads them anew
    from :mod:`.config` (another arch, form or device)."""
    global MODEL, BATCHER
    with _LOCK:
        if BATCHER is not None:
            BATCHER.close()
        MODEL = BATCHER = None


def decode_image(img_data: bytes):
    """PIL decode: the path for non-JPEG payloads, and for JPEG where the native decoder
    is missing (PIL is imported only then)."""
    from PIL import Image

    return Image.open(io.BytesIO(img_data)).convert("RGB")


def preprocess_bytes(img_data: bytes) -> np.ndarray:
    """Encoded image bytes -> batcher-ready ``(1, 224, 224, 3)`` uint8.

    JPEG payloads take the native path (libjpeg decode and bilinear resize in C++,
    ``native/holocron_loader.cpp``); anything else, or a JPEG the native decoder cannot
    read, a PIL decode and resize. Both return uint8 host arrays: normalization runs in
    the batcher's captured forward.
    """
    if img_data[:3] == b"\xff\xd8\xff":  # JPEG magic
        from ..utils.data import decode_batch_u8, native_available

        if native_available():
            try:
                return decode_batch_u8([img_data], IMAGE_SIZE, IMAGE_SIZE)
            except (ValueError, RuntimeError):
                pass  # corrupt JPEG: let PIL try
    from PIL import Image

    pil = decode_image(img_data).resize((IMAGE_SIZE, IMAGE_SIZE), Image.BILINEAR)
    return np.asarray(pil, dtype=np.uint8)[None]


def classify_image(img_data: bytes) -> Tuple[str, float, dict]:
    """Returns ``(label, confidence, timings)``; ``timings`` carries the per-stage
    latency attribution (decode/queue/infer ms and the coalesced batch size) that the
    servers send as ``X-*`` response headers."""
    t0 = time.perf_counter()
    x = np.asarray(preprocess_bytes(img_data))
    decode_ms = (time.perf_counter() - t0) * 1e3
    result = get_batcher().submit(x)
    probs = result["probs"]
    idx = int(probs.argmax())
    label = CLASSES[idx] if idx < len(CLASSES) else str(idx)
    timings = {
        "decode_ms": decode_ms,
        "queue_ms": result["queue_ms"],
        "infer_ms": result["infer_ms"],
        "batch_size": result["batch_size"],
    }
    return label, float(probs[idx]), timings
