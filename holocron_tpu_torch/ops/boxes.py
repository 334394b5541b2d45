"""Pairwise box geometry (``holocron_tpu/ops/boxes.py``): IoU, GIoU, DIoU and CIoU on
``(M, 4)`` and ``(N, 4)`` ``xyxy`` boxes, as ``(M, N)`` matrices; leading batch
dimensions, ``(..., M, 4)`` and ``(..., N, 4)``, give ``(..., M, N)``."""

import math

import torch

__all__ = [
    "aspect_ratio",
    "aspect_ratio_consistency",
    "box_area",
    "box_giou",
    "box_iou",
    "ciou_loss",
    "diou_loss",
    "iou_penalty",
]


def _check_boxes(*box_sets: torch.Tensor) -> None:
    """Refuses boxes whose corners are swapped (``boxes.py:20-29``). It reads the values
    back to the host, as the JAX package does outside ``jit``."""
    for boxes in box_sets:
        if bool((boxes[..., 2:] < boxes[..., :2]).any()):
            raise AssertionError("Incorrect coordinate format")


def _clip0(t: torch.Tensor) -> torch.Tensor:
    """``max(t, 0)`` with ``jnp.clip``'s subgradient: half the gradient each way at 0
    (touching boxes), where ``clamp_min`` passes all of it."""
    return torch.maximum(t, t.new_zeros(()))


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """The area of ``xyxy`` boxes: ``(..., N, 4) -> (..., N)``."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = _clip0(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union, union


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """The pairwise IoU matrix ``(M, N)`` (``boxes.py:48-50``)."""
    return _box_iou(boxes1, boxes2)[0]


def box_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Generalized IoU (`Rezatofighi et al. <https://arxiv.org/pdf/1902.09630.pdf>`_,
    ``boxes.py:53-65``): ``IoU - |C - A u B| / |C|``, C the smallest enclosing box."""
    _check_boxes(boxes1, boxes2)
    iou, union = _box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = _clip0(rb - lt)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def iou_penalty(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """The DIoU penalty ``rho^2(centers) / c^2``, c the enclosing box's diagonal
    (``boxes.py:68-79``)."""
    cw = torch.maximum(boxes1[..., :, None, 2], boxes2[..., None, :, 2]) - torch.minimum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    ch = torch.maximum(boxes1[..., :, None, 3], boxes2[..., None, :, 3]) - torch.minimum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    c2 = cw**2 + ch**2
    dx = (boxes1[..., 0] + boxes1[..., 2])[..., :, None] - (boxes2[..., 0] + boxes2[..., 2])[..., None, :]
    dy = (boxes1[..., 1] + boxes1[..., 3])[..., :, None] - (boxes2[..., 1] + boxes2[..., 3])[..., None, :]
    return (dx**2 + dy**2) / 4.0 / c2


def diou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Distance-IoU loss (`Zheng et al. <https://arxiv.org/pdf/1911.08287.pdf>`_,
    ``boxes.py:82-88``): ``1 - IoU + penalty``."""
    return 1.0 - box_iou(boxes1, boxes2) + iou_penalty(boxes1, boxes2)


def aspect_ratio(boxes: torch.Tensor) -> torch.Tensor:
    """``atan(w / h)`` a box (``boxes.py:91-104``), the height held at least 1e-12 in
    magnitude with its sign, so that a flat box gives no NaN to a gradient."""
    h = boxes[..., 3] - boxes[..., 1]
    tiny = torch.where(h < 0, torch.full_like(h, -1e-12), torch.full_like(h, 1e-12))
    h_safe = torch.where(h.abs() < 1e-12, tiny, h)
    return torch.atan((boxes[..., 2] - boxes[..., 0]) / h_safe)


def aspect_ratio_consistency(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """CIoU's ``v``: ``(4 / pi^2) * (atan(w1 / h1) - atan(w2 / h2))^2``
    (``boxes.py:107-113``)."""
    v = aspect_ratio(boxes1)[..., :, None] - aspect_ratio(boxes2)[..., None, :]
    return (4.0 / math.pi**2) * v**2


def ciou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Complete IoU loss (`Zheng et al. <https://arxiv.org/pdf/1911.08287.pdf>`_,
    ``boxes.py:116-130``): ``1 - IoU + penalty + alpha * v``, ``alpha = v / ((1 - IoU) +
    v)`` where ``v != 0`` and ``IoU != 0``. As the paper and the JAX package
    (``docs/ARCHITECTURE.md:84``), not original Holocron, whose masked update of that
    term writes to a copy."""
    iou = box_iou(boxes1, boxes2)
    v = aspect_ratio_consistency(boxes1, boxes2)
    loss = 1.0 - iou + iou_penalty(boxes1, boxes2)
    alpha_v = torch.where((v != 0) & (iou != 0), v * v / (1.0 - iou + v).clamp_min(1e-12), torch.zeros_like(v))
    return loss + alpha_v
