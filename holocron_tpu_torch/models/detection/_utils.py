"""Static-shape detection infrastructure, the port of
``holocron_tpu/models/detection/_utils.py``.

Ground truth is padded to ``max_boxes`` with a validity mask; NMS is a fixed-size
greedy pass over score-sorted candidates, batched over the images; detections come
back as fixed-size tensors and a keep mask, with no read back to the host, so that a
CUDA graph can hold the whole of :func:`post_process`; :func:`detections_to_list`
turns them into the reference's list of dicts on the host.

Ties: ``jax.lax.top_k`` and ``jnp.argsort`` are stable (on equal scores the lower
index comes first), and so is ``torch.sort(..., stable=True)``, which is used here in
their place; ``torch.topk``'s order among ties on the card is unspecified.
"""

from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["box_iou_pairwise", "detections_to_list", "masked_nms", "pad_targets", "post_process"]


def pad_targets(target: Sequence[Dict], max_boxes: int = 50) -> Dict[str, torch.Tensor]:
    """Pads a reference-style list of ``{boxes, labels}`` dicts (``_utils.py:24-36``) to
    ``boxes (B, max_boxes, 4)`` float32, ``labels (B, max_boxes)`` int64 and ``mask (B,
    max_boxes)`` bool tensors on the CPU; boxes past ``max_boxes`` are dropped."""
    b = len(target)
    boxes = np.zeros((b, max_boxes, 4), dtype=np.float32)
    labels = np.zeros((b, max_boxes), dtype=np.int64)
    mask = np.zeros((b, max_boxes), dtype=bool)
    for i, t in enumerate(target):
        tb = np.asarray(t["boxes"], dtype=np.float32).reshape(-1, 4)
        n = min(tb.shape[0], max_boxes)
        boxes[i, :n] = tb[:n]
        labels[i, :n] = np.asarray(t["labels"]).reshape(-1)[:n]
        mask[i, :n] = True
    return {"boxes": torch.from_numpy(boxes), "labels": torch.from_numpy(labels), "mask": torch.from_numpy(mask)}


def box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of ``(..., M, 4)`` against ``(..., N, 4)`` -> ``(..., M, N)``, the union held
    at least 1e-12 (``_utils.py:39-48``)."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.maximum(rb - lt, lt.new_zeros(()))  # jnp.clip's subgradient at 0: half each way
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / torch.maximum(union, union.new_full((), 1e-12))


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over candidates already in visiting order (``(B, K, 4)`` boxes, ``(B,
    K)`` validity): candidate ``i`` survives when it is valid and no kept candidate
    before it overlaps it by more than ``iou_threshold`` (``_utils.py:63-69``); returns
    the keep mask.

    The overlaps of each candidate with the later ones are computed once; the pass
    keeps, for each candidate, a count of the kept candidates before it that overlap it
    (an invalid one starts at 1), so that step ``i`` keeps ``i`` where its count is 0
    and adds its overlaps to the later counts: two launches a step, batched over the
    images, no read back to the host. The counts stay exact in float32 (at most K).
    """
    k = boxes.shape[1]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu_(1)
    overlaps = ((box_iou_pairwise(boxes, boxes) > iou_threshold) & later).float()
    counts = (~valid).float()
    for i in range(k):
        counts.addcmul_(counts[:, i : i + 1] == 0, overlaps[:, i])
    return counts == 0


def masked_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over one image's fixed-size candidates ``(K, 4)``, ``(K,)``, ``(K,)``;
    returns the keep mask (``_utils.py:51-71``): torchvision ``nms`` semantics on the
    valid subset, candidates visited by descending score (ties by index), each
    suppressing later overlapping ones."""
    order = torch.sort(-torch.where(valid, scores, torch.full_like(scores, -torch.inf)), stable=True).indices
    keep_sorted = greedy_keep(boxes[order][None], valid[order][None], iou_threshold)[0]
    return torch.zeros_like(keep_sorted).index_put_((order,), keep_sorted)


def post_process(
    boxes: torch.Tensor,
    b_o: torch.Tensor,
    b_scores: torch.Tensor,
    rpn_nms_thresh: float = 0.7,
    box_score_thresh: float = 0.05,
    pre_nms_topk: int = 1024,
    obj_thresh: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """The objectness filter, the score threshold, the top ``pre_nms_topk`` and NMS, on
    probability-space inputs (``_utils.py:74-107``): ``boxes (B, K, 4)``, ``b_o (B, K)``,
    ``b_scores (B, K, C)``. Returns fixed-size ``boxes (B, k, 4)``, ``scores``,
    ``labels`` and the ``keep`` mask, ``k = min(pre_nms_topk, K)``, in descending
    score order. ``obj_thresh`` is the reference's objectness gate (0.5), a parameter so
    that evaluation can rank weakly trained models. No host sync: a CUDA graph can
    capture it."""
    boxes = boxes.clamp(0.0, 1.0)
    scores = b_scores.amax(dim=-1) * b_o
    labels = b_scores.argmax(dim=-1)
    valid = (b_o >= obj_thresh) & (scores >= box_score_thresh)

    k = min(pre_nms_topk, boxes.shape[1])
    ranked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    top_idx = torch.sort(ranked, dim=1, descending=True, stable=True).indices[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_scores = torch.gather(scores, 1, top_idx)
    top_labels = torch.gather(labels, 1, top_idx)
    top_valid = torch.gather(valid, 1, top_idx)
    # the top k are in visiting order already: masked_nms's own sort would leave them so
    keep = greedy_keep(top_boxes, top_valid, rpn_nms_thresh)
    return {"boxes": top_boxes, "scores": top_scores, "labels": top_labels, "keep": keep}


def detections_to_list(padded: Dict[str, torch.Tensor]) -> List[Dict[str, np.ndarray]]:
    """The host-side conversion of :func:`post_process`'s output to the reference's list
    of ``{boxes, scores, labels}`` dicts of numpy arrays, each image's kept detections by
    descending score (``_utils.py:110-126``, the same numpy calls)."""
    boxes, scores, labels, keep = (padded[k].detach().cpu().numpy() for k in ("boxes", "scores", "labels", "keep"))
    out = []
    for i in range(boxes.shape[0]):
        k = keep[i]
        order = np.argsort(-scores[i][k])
        out.append({
            "boxes": boxes[i][k][order],
            "scores": scores[i][k][order],
            "labels": labels[i][k][order].astype(np.int64),
        })
    return out
