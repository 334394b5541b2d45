"""YOLOv1 (`Redmon et al. <https://pjreddie.com/media/files/papers/yolo_1.pdf>`_) and the
shared detection machinery, the port of ``holocron_tpu/models/detection/yolo.py``.

The target assignment is vectorized over padded ground truth and batched over the
images (the JAX package vmaps it); NMS is the fixed-size one of ``_utils``.
"""

import logging
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..classification.darknet import DARKNET24_LAYOUT, DarknetBodyV1, init_darknet_weights, leaky_relu_01
from ..utils import conv_sequence
from ._utils import box_iou_pairwise, detections_to_list, pad_targets, post_process

__all__ = ["DetectionModel", "YOLOv1", "yolo_v12_losses", "yolov1"]

logger = logging.getLogger(__name__)

NormLayer = Callable[[int], nn.Module]
RawOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Target = Union[Sequence[Dict[str, Any]], Dict[str, torch.Tensor]]


def _image_index(t: torch.Tensor) -> torch.Tensor:
    """``(B, 1)`` image indices for advanced indexing of a ``(B, ...)`` tensor by
    ``(B, M)`` indices."""
    return torch.arange(t.shape[0], device=t.device)[:, None]


def yolo_v12_losses(
    pred_xyxy: torch.Tensor,
    pred_xy: torch.Tensor,
    pred_wh: torch.Tensor,
    pred_o: torch.Tensor,
    pred_scores: torch.Tensor,
    target: Dict[str, torch.Tensor],
    lambda_obj: float = 1.0,
    lambda_noobj: float = 0.5,
    lambda_class: float = 1.0,
    lambda_coords: float = 5.0,
    ignore_high_iou: bool = False,
) -> Dict[str, torch.Tensor]:
    """The YOLOv1/v2 multi-part loss (``yolo.py:30-107``), batched over the images.

    Predictions: absolute ``pred_xyxy (B, H, W, A, 4)``, centers ``pred_xy (B, H, W, A,
    2)``, sizes ``pred_wh``, objectness ``pred_o (B, H, W, A)`` and class scores
    ``pred_scores (B, H, W, A, C)``; ``target`` padded (``boxes``, ``labels``, ``mask``).
    For each ground-truth box the anchor of its center cell with the highest IoU is
    responsible (objectness target that IoU, coordinates and class regressed there);
    every other anchor pays the no-objectness penalty. Each box is paired with its own
    responsible anchor in the wh term (the JAX package's fix of the reference's
    broadcast). The wh term's square root has a zero subgradient at wh <= 0, so that a
    saturated head gives no NaN.

    The no-objectness mask counts the valid boxes that land on each anchor
    (``index_put_`` with ``accumulate``; padded and co-located boxes repeat indices)
    and keeps the anchors that none lands on.
    """
    b, h, w, num_anchors = pred_o.shape
    gtb, gtl, gtm = target["boxes"], target["labels"], target["mask"]
    bi = _image_index(gtb)
    gt_xy = (gtb[..., :2] + gtb[..., 2:]) / 2.0
    gt_wh = (gtb[..., 2:] - gtb[..., :2]).clamp_min(0.0)
    cx = (gt_xy[..., 0] * w).to(torch.int64).clamp(0, w - 1)
    cy = (gt_xy[..., 1] * h).to(torch.int64).clamp(0, h - 1)

    cell_boxes = pred_xyxy[bi, cy, cx]  # (B, M, A, 4)
    iou = box_iou_pairwise(gtb[..., None, :], cell_boxes)[..., 0, :]  # (B, M, A)
    anchor = iou.argmax(dim=-1)
    iou_best = iou.amax(dim=-1)
    gtm_f = gtm.to(pred_xyxy.dtype)

    obj = torch.sum(gtm_f * (iou_best - pred_o[bi, cy, cx, anchor]) ** 2)
    onehot = F.one_hot(gtl, pred_scores.shape[-1]).to(pred_xyxy.dtype)
    clf = torch.sum(gtm_f[..., None, None] * (onehot[..., None, :] - pred_scores[bi, cy, cx]) ** 2)
    sel_xy = pred_xy[bi, cy, cx, anchor]
    sel_wh = pred_wh[bi, cy, cx, anchor]
    bbox = torch.sum(gtm_f[..., None] * (gt_xy - sel_xy) ** 2)
    wh_pos = sel_wh > 0.0
    sqrt_wh = torch.sqrt(torch.where(wh_pos, sel_wh, torch.ones_like(sel_wh))) * wh_pos.to(pred_xyxy.dtype)
    bbox = bbox + torch.sum(gtm_f[..., None] * (torch.sqrt(gt_wh) - sqrt_wh) ** 2)

    landed = torch.zeros((b, h, w, num_anchors), dtype=pred_xyxy.dtype, device=pred_xyxy.device)
    landed.index_put_((bi.expand_as(cy), cy, cx, anchor), gtm_f, accumulate=True)
    noobj_mask = (landed == 0).to(pred_xyxy.dtype)
    if ignore_high_iou:
        all_iou = box_iou_pairwise(pred_xyxy.reshape(b, -1, 4), gtb)  # (B, HWA, M)
        best = torch.where(gtm[:, None, :], all_iou, torch.zeros_like(all_iou)).amax(dim=-1)
        noobj_mask = noobj_mask * (best.reshape(b, h, w, num_anchors) < 0.5)
    noobj = torch.sum(noobj_mask * pred_o**2)
    return {
        "obj_loss": lambda_obj * obj / b,
        "noobj_loss": lambda_noobj * noobj / b,
        "bbox_loss": lambda_coords * bbox / b,
        "clf_loss": lambda_class * clf / b,
    }


class DetectionModel(nn.Module):
    """The detectors' call semantics (the JAX package's ``DetectionModel``,
    ``yolo.py:110-162``).

    - ``model(x)`` in eval mode: the list of ``{boxes, scores, labels}`` dicts of numpy
      arrays, one an image (:meth:`raw`, then :func:`post_process` in float32 with the
      model's ``rpn_nms_thresh`` and ``box_score_thresh``, then
      :func:`detections_to_list`);
    - ``model(x, target)``: the loss dict, in the module's mode (the trainer's step runs
      it in train mode); ``target`` is a list of ``{boxes, labels}`` dicts (relative
      ``xyxy`` boxes, which must lie in [0, 1]), padded on the host to ``max_boxes``, or
      a dict already padded (:func:`pad_targets`), moved to ``x``'s device;
    - train mode with no target raises ``ValueError``; a list of images is stacked.

    :meth:`raw` gives ``(boxes (B, K, 4), b_o (B, K), b_scores (B, K, C))`` in
    probability space, the function that is captured, quantized and gated.
    """

    rpn_nms_thresh: float = 0.7
    box_score_thresh: float = 0.05
    max_boxes: int = 50

    def _outputs(self, x: torch.Tensor, target: Optional[Dict[str, torch.Tensor]]):
        raise NotImplementedError

    def raw(self, x: torch.Tensor) -> RawOutputs:
        """The raw eval outputs (the JAX module's ``apply`` without a target)."""
        return self._outputs(x, None)

    def pad(self, target: Target, device: torch.device) -> Dict[str, torch.Tensor]:
        """``target`` padded (a list is checked and padded on the host) and on ``device``."""
        if isinstance(target, (list, tuple)):
            for t in target:
                boxes = np.asarray(t["boxes"], dtype=np.float32)
                if boxes.size and (boxes.min() < 0 or boxes.max() > 1):
                    raise ValueError("Ground truth boxes are expected to have values between 0 and 1.")
            target = pad_targets(target, self.max_boxes)
        return {k: v.to(device, non_blocking=True) for k, v in target.items()}

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]], target: Optional[Target] = None):
        if self.training and target is None:
            raise ValueError("`target` needs to be specified in training mode")
        if isinstance(x, (list, tuple)):
            x = torch.stack(list(x))
        if target is not None:
            return self._outputs(x, self.pad(target, x.device))
        boxes, b_o, b_scores = self.raw(x)
        return detections_to_list(post_process(boxes.float(), b_o.float(), b_scores.float(), self.rpn_nms_thresh,
                                               self.box_score_thresh))


def warn_no_backbone_weights(arch: str) -> None:
    """``pretrained_backbone=True`` loads nothing: the JAX package warns and keeps the
    random initialization where the checkpoint cannot be fetched
    (``holocron_tpu/models/utils.py:267-279``); the port has no checkpoint loading yet."""
    logger.warning(f"{arch}: pretrained backbone weights are not ported yet, using default initialization.")


class YOLOv1(DetectionModel):
    """YOLOv1 (``yolo.py:165-253``): the Darknet-24 body, four 3x3 convs (the second of
    stride 2), a fully connected head (``head_hidden_nodes``, the activation, dropout 0.5)
    predicting, a cell of the ``H x W`` grid, ``num_anchors`` boxes with their objectness
    and one class distribution shared by them.

    The grid's size comes from ``input_shape`` (``(C, H, W)``: the input side over 64 on
    the darknet24 layout),
    which sizes the first linear layer (the JAX package infers it at init). The head
    flattens its input in NHWC order, as the JAX package does, so that its weights carry
    over unchanged. Weights are drawn from ``generator`` on the CPU, then moved to
    ``device``: the card unless the caller asks for the CPU (``device="cpu"``).
    ``state_dict`` keys: ``backbone.*`` (the darknet24 body's), ``block4.{offset}`` and
    ``classifier.{1,4}`` (the two linear layers).
    """

    def __init__(
        self,
        layout: Sequence[Sequence[int]],
        num_classes: int = 20,
        in_channels: int = 3,
        stem_channels: int = 64,
        num_anchors: int = 2,
        lambda_obj: float = 1.0,
        lambda_noobj: float = 0.5,
        lambda_class: float = 1.0,
        lambda_coords: float = 5.0,
        rpn_nms_thresh: float = 0.7,
        box_score_thresh: float = 0.05,
        head_hidden_nodes: int = 512,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        backbone_norm_layer: Optional[NormLayer] = None,
        input_shape: Tuple[int, int, int] = (3, 448, 448),
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_classes, self.num_anchors = num_classes, num_anchors
        self.lambdas = (lambda_obj, lambda_noobj, lambda_class, lambda_coords)
        self.rpn_nms_thresh, self.box_score_thresh = rpn_nms_thresh, box_score_thresh
        act_layer = act_layer or leaky_relu_01()
        self.backbone = DarknetBodyV1(layout, in_channels, stem_channels, act_layer,
                                      backbone_norm_layer if backbone_norm_layer is not None else norm_layer)
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        c = self.backbone.out_channels
        self.block4 = nn.Sequential(
            *conv_sequence(c, 1024, act_layer, kernel_size=3, padding=1, **common),
            *conv_sequence(1024, 1024, act_layer, kernel_size=3, padding=1, stride=2, **common),
            *conv_sequence(1024, 1024, act_layer, kernel_size=3, padding=1, **common),
            *conv_sequence(1024, 1024, act_layer, kernel_size=3, padding=1, **common),
        )
        stride = 2 ** (len(layout) + 2)  # the stem, a max pool a group, block4's strided conv
        self.grid = (input_shape[1] // stride, input_shape[2] // stride)
        cells = self.grid[0] * self.grid[1]
        self.classifier = nn.Sequential(
            nn.Flatten(),
            nn.Linear(cells * 1024, head_hidden_nodes),
            act_layer,
            nn.Dropout(0.5),
            nn.Linear(head_hidden_nodes, cells * (num_anchors * 5 + num_classes)),
        )
        init_darknet_weights(self, generator)
        self.to(device)

    def _outputs(self, x: torch.Tensor, target: Optional[Dict[str, torch.Tensor]]):
        out = self.block4(self.backbone(x))
        b, _, h, w = out.shape
        out = self.classifier(out.permute(0, 2, 3, 1))
        a, nc = self.num_anchors, self.num_classes
        out = out.reshape(b, h, w, a * 5 + nc)
        # one class distribution a cell, shared by its anchors (yolo.py:218-220)
        b_scores = torch.softmax(out[..., -nc:], dim=-1)[..., None, :].expand(b, h, w, a, nc)
        box_o = torch.sigmoid(out[..., : a * 5].reshape(b, h, w, a, 5))
        b_coords, b_o = box_o[..., :4], box_o[..., 4]
        c_x = torch.arange(w, dtype=out.dtype, device=out.device).reshape(1, 1, -1, 1)
        c_y = torch.arange(h, dtype=out.dtype, device=out.device).reshape(1, -1, 1, 1)
        xy = torch.stack([(b_coords[..., 0] + c_x) / w, (b_coords[..., 1] + c_y) / h], dim=-1)
        wh = b_coords[..., 2:]
        pred_xyxy = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
        if target is not None:
            return yolo_v12_losses(pred_xyxy, xy, wh, b_o, b_scores, target, *self.lambdas)
        return pred_xyxy.reshape(b, -1, 4), b_o.reshape(b, -1), b_scores.reshape(b, -1, nc)


def yolov1(pretrained: bool = False, pretrained_backbone: bool = True, **kwargs: Any) -> YOLOv1:
    """YOLOv1 (``yolo.py:256-265``) on the darknet24 layout. ``pretrained_backbone`` only
    warns: no weights are loaded (:func:`warn_no_backbone_weights`)."""
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported yet; build with pretrained=False")
    if pretrained_backbone:
        warn_no_backbone_weights("yolov1")
    return YOLOv1(DARKNET24_LAYOUT, **kwargs)
