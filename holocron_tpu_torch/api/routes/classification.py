"""Classification route logic (``api/app/routes/classification.py``), shared by the
stdlib and FastAPI servers: decode, run through the micro-batcher, top candidate."""

from typing import Optional

from ..schemas import ClsCandidate
from ..vision import classify_image

__all__ = ["classify"]


def classify(img_data: bytes, timings: Optional[dict] = None) -> ClsCandidate:
    """Runs one encoded image through the batched model and returns the top candidate.

    When the caller passes a ``timings`` dict, the per-stage latency attribution
    (decode/queue/infer, batch size) is written into it for response headers."""
    label, confidence, t = classify_image(img_data)
    if timings is not None:
        timings.update(t)
    return ClsCandidate(value=label, confidence=confidence)
