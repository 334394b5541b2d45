"""YOLOv4 (`Bochkovskiy et al. <https://arxiv.org/pdf/2004.10934.pdf>`_), the port of
``holocron_tpu/models/detection/yolov4.py``: the CSP-Darknet-53 body at three feature
scales, an SPP and PAN neck, three scale-specific YOLO layers (``scale_xy`` decoding,
anchors assigned by wh-only IoU, a CIoU box loss, a BCE class loss), the assignment as
dense masked tensors over padded ground truth, batched over the images.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from ...nn.modules.downsample import SPP
from ...nn.modules.dropblock import DropBlock2d
from ...ops.boxes import ciou_loss
from ..classification.darknet import init_darknet_weights
from ..classification.darknetv4 import CSPDARKNET53_LAYOUT, DarknetBodyV4
from ..layers import BatchNorm2d, FrozenBatchNorm2d
from ..utils import conv_sequence
from ._utils import box_iou_pairwise
from .yolo import DetectionModel, _image_index, warn_no_backbone_weights

__all__ = ["Neck", "PAN", "YOLOv4", "YoloLayer", "Yolov4Head", "yolov4"]

NormLayer = Callable[[int], nn.Module]

# COCO anchor priors over the 608 px input (yolov4.py:30-38)
DEFAULT_ANCHORS = tuple(
    tuple((aw / 608, ah / 608) for aw, ah in scale)
    for scale in (
        ((12, 16), (19, 36), (40, 28)),
        ((36, 75), (76, 55), (72, 146)),
        ((142, 110), (192, 243), (459, 401)),
    )
)


def _convs(act_layer: nn.Module, common: Dict[str, Any], *specs: Tuple[int, int, int]) -> List[nn.Module]:
    """The layers of one conv block a ``(in, out, kernel)`` spec (padding ``kernel // 2``)."""
    layers: List[nn.Module] = []
    for c_in, c_out, k in specs:
        layers += conv_sequence(c_in, c_out, act_layer, kernel_size=k, padding=k // 2, **common)
    return layers


class PAN(nn.Module):
    """The path-aggregation block (``yolov4.py:41-69``): 1x1 convs halve ``x`` (then
    upsampled by 2, nearest) and the lateral ``up``, their concat (lateral first)
    through five convs alternating 1x1 to the half and 3x3 back. ``state_dict`` keys
    ``conv1``, ``conv2`` and ``convs``."""

    def __init__(self, in_channels: int, up_channels: int, act_layer: nn.Module, **common: Any) -> None:
        super().__init__()
        half = in_channels // 2
        self.conv1 = nn.Sequential(*_convs(act_layer, common, (in_channels, half, 1)))
        self.conv2 = nn.Sequential(*_convs(act_layer, common, (up_channels, half, 1)))
        self.convs = nn.Sequential(*_convs(act_layer, common, (2 * half, half, 1), (half, 2 * half, 3),
                                           (2 * half, half, 1), (half, 2 * half, 3), (2 * half, half, 1)))

    def forward(self, x: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
        out = F.interpolate(self.conv1(x), scale_factor=2, mode="nearest")
        return self.convs(torch.cat([self.conv2(up), out], dim=1))


class Neck(nn.Module):
    """The FPN convs with SPP(5, 9, 13) on the deepest features, then two PAN stages
    (``yolov4.py:72-102``); returns the three scales, finest first. ``state_dict``
    keys ``fpn.{offset}`` (SPP in the middle), ``pan1.*`` and ``pan2.*``."""

    def __init__(self, in_channels: Sequence[int], act_layer: nn.Module, **common: Any) -> None:
        super().__init__()
        c0, c1, c = in_channels
        self.fpn = nn.Sequential(
            *_convs(act_layer, common, (c, c // 2, 1), (c // 2, c, 3), (c, c // 2, 1)),
            SPP((5, 9, 13)),
            *_convs(act_layer, common, (2 * c, c // 2, 1), (c // 2, c, 3), (c, c // 2, 1)),
        )
        self.pan1 = PAN(c // 2, c1, act_layer, **common)
        self.pan2 = PAN(c // 4, c0, act_layer, **common)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        out = self.fpn(feats[2])
        aux1 = self.pan1(out, feats[1])
        aux2 = self.pan2(aux1, feats[0])
        return aux2, aux1, out


class YoloLayer(nn.Module):
    """Scale-specific decoding and losses (``yolov4.py:105-239``): no parameters, the
    anchors a non-persistent buffer (so that a graph capture reads them on the card)."""

    def __init__(
        self,
        anchors: Sequence[Tuple[float, float]],
        num_classes: int = 80,
        scale_xy: float = 1.0,
        lambda_obj: float = 1.0,
        lambda_noobj: float = 0.001,
        lambda_class: float = 0.1,
        lambda_coords: float = 1.0,
        ignore_thresh: float = 0.5,
    ) -> None:
        super().__init__()
        self.num_classes, self.num_anchors, self.scale_xy = num_classes, len(anchors), scale_xy
        self.lambdas = (lambda_obj, lambda_noobj, lambda_class, lambda_coords)
        self.ignore_thresh = ignore_thresh
        self.register_buffer("anchors", torch.tensor(anchors, dtype=torch.float32), persistent=False)

    def format_outputs(self, output: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The head's NCHW output decoded to ``xyxy`` boxes ``(B, H, W, A, 4)``, objectness
        logits ``(B, H, W, A)`` and class logits ``(B, H, W, A, C)`` (``yolov4.py:133-155``):
        centers ``scale_xy * sigmoid - (scale_xy - 1) / 2`` cells, wh the anchors times
        ``exp``, clipped to [0, 2]."""
        b, _, h, w = output.shape
        output = output.permute(0, 2, 3, 1).reshape(b, h, w, self.num_anchors, 5 + self.num_classes)
        anchors = self.anchors.to(output.dtype)
        c_x = torch.arange(w, dtype=output.dtype, device=output.device).reshape(1, 1, -1, 1)
        c_y = torch.arange(h, dtype=output.dtype, device=output.device).reshape(1, -1, 1, 1)
        b_xy = self.scale_xy * torch.sigmoid(output[..., :2]) - 0.5 * (self.scale_xy - 1)
        xy = torch.stack([(b_xy[..., 0] + c_x) / w, (b_xy[..., 1] + c_y) / h], dim=-1)
        b_wh = (torch.exp(output[..., 2:4]) * anchors).clamp(0.0, 2.0)
        top_left = xy - 0.5 * b_wh
        return torch.cat([top_left, top_left + b_wh], dim=-1), output[..., 4], output[..., 5:]

    def compute_losses(self, pred_boxes: torch.Tensor, b_o: torch.Tensor, b_scores: torch.Tensor,
                       target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The losses (``yolov4.py:157-231``), with the JAX package's two fixes of the
        reference (its ignore-threshold write and CIoU's alpha term take effect).

        - The responsible anchor of a box has the highest wh-only IoU with it; a cell's
          objectness target is the best IoU of its prediction with any box, where a box
          is responsible; the no-objectness penalty spares every anchor of a box's cell
          and every prediction whose best IoU reaches ``ignore_thresh``. Both masks count
          the valid boxes that land on each position (``index_put_`` with
          ``accumulate``; padded and co-located boxes repeat indices).
        - The CIoU box loss takes, at each responsible position, the least CIoU over
          the valid boxes. A padded row is replaced by a unit box before the box math,
          so that no ``atan(0 / 0)`` reaches a gradient (its columns are then +inf and
          never win the minimum).
        - The class loss is BCE with logits, the mean over the classes.
        """
        b, h, w, num_anchors = b_o.shape
        gtb, gtl, gtm = target["boxes"], target["labels"], target["mask"]
        dtype = pred_boxes.dtype
        anchors = self.anchors.to(dtype)
        bi = _image_index(gtb)
        gt_xy = (gtb[..., :2] + gtb[..., 2:]) / 2.0
        gt_wh = (gtb[..., 2:] - gtb[..., :2]).clamp_min(0.0)
        cx = (gt_xy[..., 0] * w).to(torch.int64).clamp(0, w - 1)
        cy = (gt_xy[..., 1] * h).to(torch.int64).clamp(0, h - 1)
        inter = torch.minimum(gt_wh[..., None, 0], anchors[:, 0]) * torch.minimum(gt_wh[..., None, 1], anchors[:, 1])
        union = gt_wh[..., 0:1] * gt_wh[..., 1:2] + anchors[:, 0] * anchors[:, 1] - inter
        a_star = (inter / union.clamp_min(1e-12)).argmax(dim=-1)

        gtm_f = gtm.to(dtype)
        bidx = bi.expand_as(cy)
        landed = torch.zeros((b, h, w, num_anchors), dtype=dtype, device=b_o.device)
        obj_mask = landed.index_put((bidx, cy, cx, a_star), gtm_f, accumulate=True) > 0
        in_cell = torch.zeros((b, h, w), dtype=dtype, device=b_o.device).index_put((bidx, cy, cx), gtm_f,
                                                                                   accumulate=True)
        noobj_mask = (in_cell == 0)[..., None].to(dtype)

        iou = box_iou_pairwise(pred_boxes.reshape(b, -1, 4), gtb)  # (B, HWA, M)
        iou = torch.where(gtm[:, None, :], iou, torch.full_like(iou, -1.0))
        best_iou = iou.amax(dim=-1).reshape(b, h, w, num_anchors)
        best_gt = iou.argmax(dim=-1).reshape(b, h, w, num_anchors)
        zero = best_iou.new_zeros(())  # torch.maximum splits the gradient at a tie, as jnp.maximum and jnp.clip
        target_o = torch.where(obj_mask, torch.maximum(best_iou, zero), zero)
        target_labels = torch.gather(gtl, 1, best_gt.reshape(b, -1)).reshape(b, h, w, num_anchors)
        target_scores = F.one_hot(target_labels, self.num_classes).to(dtype) * obj_mask[..., None]
        noobj_mask = noobj_mask * (best_iou < self.ignore_thresh)

        po_sig = torch.sigmoid(b_o)
        obj_loss = torch.sum(torch.where(obj_mask, (po_sig - target_o) ** 2, zero))
        noobj_loss = torch.sum(noobj_mask * po_sig**2)

        unit = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=gtb.dtype, device=gtb.device)
        safe_gtb = torch.where(gtm[..., None], gtb, unit)
        ciou = ciou_loss(pred_boxes.reshape(b, -1, 4), safe_gtb)  # (B, HWA, M)
        ciou = torch.where(gtm[:, None, :], ciou, torch.full_like(ciou, torch.inf))
        min_ciou = ciou.amin(dim=-1).reshape(b, h, w, num_anchors)
        per_image = torch.sum(torch.where(obj_mask, min_ciou, zero), dim=(1, 2, 3))
        bbox_loss = torch.sum(torch.where(gtm.any(dim=1), per_image, zero))

        bce = torch.maximum(b_scores, zero) - b_scores * target_scores + torch.log1p(torch.exp(-b_scores.abs()))
        clf_loss = torch.sum(torch.where(obj_mask, bce.mean(dim=-1), zero))
        lambda_obj, lambda_noobj, lambda_class, lambda_coords = self.lambdas
        return {
            "obj_loss": lambda_obj * obj_loss / b,
            "noobj_loss": lambda_noobj * noobj_loss / b,
            "bbox_loss": lambda_coords * bbox_loss / b,
            "clf_loss": lambda_class * clf_loss / b,
        }

    def forward(self, output: torch.Tensor, target: Optional[Dict[str, torch.Tensor]] = None):
        boxes, b_o, b_scores = self.format_outputs(output)
        if target is not None:
            return self.compute_losses(boxes, b_o, b_scores, target)
        b = boxes.shape[0]
        return (boxes.clamp(0.0, 1.0).reshape(b, -1, 4), torch.sigmoid(b_o).reshape(b, -1),
                torch.sigmoid(b_scores).reshape(b, -1, self.num_classes))


class Yolov4Head(nn.Module):
    """The three-scale head with cross-scale reuse and zero-initialized prediction convs
    (``yolov4.py:242-309``). The last conv block before each of the first two prediction
    convs has no DropBlock. ``state_dict`` keys ``head1``, ``pre_head2``, ``head2_1``,
    ``head2_2``, ``pre_head3`` and ``head3`` (each prediction conv the last layer of its
    ``Sequential``)."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 80, anchors: Any = DEFAULT_ANCHORS,
                 act_layer: Optional[nn.Module] = None, **common: Any) -> None:
        super().__init__()
        if len(anchors) != 3:
            raise AssertionError(f"The number of anchors is expected to be 3. received: {len(anchors)}")
        c0, c1, c2 = in_channels
        out = (5 + num_classes) * 3
        no_drop = {**common, "drop_layer": None}
        self.head1 = nn.Sequential(*_convs(act_layer, no_drop, (c0, 256, 3)), nn.Conv2d(256, out, 1))
        self.pre_head2 = nn.Sequential(*conv_sequence(c0, 256, act_layer, kernel_size=3, padding=1, stride=2,
                                                      **common))
        self.head2_1 = nn.Sequential(*_convs(act_layer, common, (256 + c1, 256, 1), (256, 512, 3), (512, 256, 1),
                                             (256, 512, 3), (512, 256, 1)))
        self.head2_2 = nn.Sequential(*_convs(act_layer, no_drop, (256, 512, 3)), nn.Conv2d(512, out, 1))
        self.pre_head3 = nn.Sequential(*conv_sequence(256, 512, act_layer, kernel_size=3, padding=1, stride=2,
                                                      **common))
        self.head3 = nn.Sequential(
            *_convs(act_layer, common, (512 + c2, 512, 1), (512, 1024, 3), (1024, 512, 1), (512, 1024, 3),
                    (1024, 512, 1), (512, 1024, 3)),
            nn.Conv2d(1024, out, 1),
        )
        self.yolo1 = YoloLayer(anchors[0], num_classes=num_classes, scale_xy=1.2)
        self.yolo2 = YoloLayer(anchors[1], num_classes=num_classes, scale_xy=1.1)
        self.yolo3 = YoloLayer(anchors[2], num_classes=num_classes, scale_xy=1.05)

    def pred_convs(self) -> List[nn.Conv2d]:
        return [self.head1[-1], self.head2_2[-1], self.head3[-1]]

    def forward(self, feats: Sequence[torch.Tensor], target: Optional[Dict[str, torch.Tensor]] = None):
        o1 = self.head1(feats[0])
        h2 = self.head2_1(torch.cat([self.pre_head2(feats[0]), feats[1]], dim=1))
        o2 = self.head2_2(h2)
        o3 = self.head3(torch.cat([self.pre_head3(h2), feats[2]], dim=1))
        y1, y2, y3 = self.yolo1(o1, target), self.yolo2(o2, target), self.yolo3(o3, target)
        if target is not None:
            return {k: y1[k] + y2[k] + y3[k] for k in y1}
        return tuple(torch.cat(parts, dim=1) for parts in zip(y1, y2, y3))


class YOLOv4(DetectionModel):
    """YOLOv4 (``yolov4.py:312-356``): the CSP backbone at three scales, the SPP and PAN
    neck and the three-scale head; Mish activations and DropBlock by default.

    ``backbone_norm_layer`` replaces ``norm_layer`` in the backbone (:func:`yolov4`
    passes ``FrozenBatchNorm2d`` with ``pretrained_backbone``). Weights are drawn from
    ``generator`` on the CPU (the prediction convs start at zero), then moved to
    ``device``: the card unless the caller asks for the CPU (``device="cpu"``).
    ``state_dict`` keys ``backbone.*`` (the cspdarknet53 body's), ``neck.*`` and
    ``head.*``.
    """

    def __init__(
        self,
        layout: Sequence[Tuple[int, int]],
        num_classes: int = 80,
        in_channels: int = 3,
        stem_channels: int = 32,
        anchors: Any = DEFAULT_ANCHORS,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = BatchNorm2d,
        drop_layer: Optional[Callable[[], nn.Module]] = DropBlock2d,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        backbone_norm_layer: Optional[NormLayer] = None,
        rpn_nms_thresh: float = 0.7,
        box_score_thresh: float = 0.05,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_classes, self.drop_layer = num_classes, drop_layer
        self.rpn_nms_thresh, self.box_score_thresh = rpn_nms_thresh, box_score_thresh
        act_layer = act_layer or nn.Mish()
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        self.backbone = DarknetBodyV4(layout, in_channels, stem_channels, 3, act_layer,
                                      backbone_norm_layer if backbone_norm_layer is not None else norm_layer,
                                      drop_layer, conv_layer)
        widths = [c for c, _ in layout[-3:]]
        self.neck = Neck(widths, act_layer, **common)
        c = widths[2]  # the neck's outputs: c / 8, c / 4 and c / 2 channels
        self.head = Yolov4Head((c // 8, c // 4, c // 2), num_classes, anchors, act_layer, **common)
        init_darknet_weights(self, generator)
        with torch.no_grad():
            for conv in self.head.pred_convs():
                nn.init.zeros_(conv.weight)
                nn.init.zeros_(conv.bias)
        self.to(device)

    def _outputs(self, x: torch.Tensor, target: Optional[Dict[str, torch.Tensor]]):
        return self.head(self.neck(self.backbone(x)), target)


def yolov4(pretrained: bool = False, pretrained_backbone: bool = True, **kwargs: Any) -> YOLOv4:
    """YOLOv4 (``yolov4.py:359-370``) on the cspdarknet53 layout. ``pretrained_backbone``
    freezes the backbone's normalization (``FrozenBatchNorm2d``) and warns that no
    weights were loaded (:func:`~holocron_tpu_torch.models.detection.yolo.warn_no_backbone_weights`)."""
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported yet; build with pretrained=False")
    if pretrained_backbone:
        kwargs["backbone_norm_layer"] = FrozenBatchNorm2d
        warn_no_backbone_weights("yolov4")
    return YOLOv4(CSPDARKNET53_LAYOUT, **kwargs)
