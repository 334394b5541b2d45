#!/usr/bin/env python
"""A Gradio demo of the service's model, the port of ``demo/app.py``: top-3 classes of
an uploaded image.

    python -m holocron_tpu_torch.demo --port 8001
    python -m holocron_tpu_torch.demo --device cpu

The image is resized to 224 x 224 (bilinear) and submitted as uint8 to the service's
micro-batcher (:func:`~holocron_tpu_torch.api.vision.get_batcher`: the configured model
in its deploy form, normalization and softmax inside its captured forward). Needs
``gradio``, imported only by :func:`main`. Runs on the card unless ``--device cpu``.
"""

import argparse
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["main", "make_predict"]


def make_predict(batcher, classes: Sequence[str]) -> Callable:
    """``predict(pil_image) -> {label: probability}`` of the 3 most probable classes,
    through ``batcher.submit``; a class index past ``classes`` is labelled by its number."""

    def predict(pil_img) -> Dict[str, float]:
        from PIL import Image

        x = np.asarray(pil_img.convert("RGB").resize((224, 224), Image.BILINEAR), dtype=np.uint8)[None]
        probs = np.asarray(batcher.submit(x)["probs"])
        top3 = probs.argsort()[::-1][:3]
        return {classes[i] if i < len(classes) else str(i): float(probs[i]) for i in top3}

    return predict


def main(args) -> None:
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit("gradio is required for the demo: pip install gradio") from e

    from .api import config, vision

    config.DEVICE = args.device
    predict = make_predict(vision.get_batcher(), vision.CLASSES)
    gr.Interface(
        fn=predict,
        inputs=gr.Image(type="pil"),
        outputs=gr.Label(num_top_classes=3),
        title="holocron-tpu-torch classification demo",
    ).launch(server_port=args.port, share=args.share)


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="holocron-tpu-torch demo")
    p.add_argument("--port", type=int, default=8001)
    p.add_argument("--share", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
