"""YOLOv2 (`Redmon & Farhadi <https://pjreddie.com/media/files/papers/YOLO9000.pdf>`_), the
port of ``holocron_tpu/models/detection/yolov2.py``: the Darknet-19 body with its
passthrough features stacked by space-to-depth, 5 anchor priors, sigmoid-offset and
anchor-exp decoding, and the YOLOv1/v2 loss.
"""

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...nn.functional import concat_downsample2d
from ..classification.darknet import init_darknet_weights, leaky_relu_01
from ..classification.darknetv2 import DARKNET19_LAYOUT, DarknetBodyV2
from ..layers import BatchNorm2d, FrozenBatchNorm2d
from ..utils import conv_sequence
from .yolo import DetectionModel, warn_no_backbone_weights, yolo_v12_losses

__all__ = ["YOLOv2", "yolov2"]

NormLayer = Callable[[int], nn.Module]

# K-means priors of the darknet yolov2-voc config, over the 13 x 13 grid (yolov2.py:29-33)
DEFAULT_ANCHORS: Tuple[Tuple[float, float], ...] = tuple(
    (aw / 13, ah / 13)
    for aw, ah in [(1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892), (9.47112, 4.84053), (11.2364, 10.0071)]
)


class YOLOv2(DetectionModel):
    """YOLOv2 (``yolov2.py:36-137``): the Darknet-19 body in passthrough form, two 3x3
    convs on its output, a 1x1 conv to ``layout[-2][0] // passthrough_ratio`` channels
    on the passthrough features and their space-to-depth by 2, the concat of both, a
    3x3 conv and a biased 1x1 head (He-normal, zero bias) predicting, an anchor a cell,
    the box, its objectness and the class distribution.

    ``backbone_norm_layer`` replaces ``norm_layer`` in the backbone
    (:func:`yolov2` passes ``FrozenBatchNorm2d`` with ``pretrained_backbone``). Weights
    are drawn from ``generator`` on the CPU, then moved to ``device``: the card unless
    the caller asks for the CPU (``device="cpu"``). ``state_dict`` keys: ``backbone.*``
    (the darknet19 body's), ``block5.{offset}``, ``passthrough_layer.{offset}``,
    ``block6.{offset}`` and ``head``.
    """

    def __init__(
        self,
        layout: Sequence[Tuple[int, int]],
        num_classes: int = 20,
        in_channels: int = 3,
        stem_channels: int = 32,
        anchors: Sequence[Tuple[float, float]] = DEFAULT_ANCHORS,
        passthrough_ratio: int = 8,
        lambda_obj: float = 1.0,
        lambda_noobj: float = 0.5,
        lambda_class: float = 1.0,
        lambda_coords: float = 5.0,
        rpn_nms_thresh: float = 0.7,
        box_score_thresh: float = 0.05,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = BatchNorm2d,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        backbone_norm_layer: Optional[NormLayer] = None,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.num_classes, self.num_anchors = num_classes, len(anchors)
        self.lambdas = (lambda_obj, lambda_noobj, lambda_class, lambda_coords)
        self.rpn_nms_thresh, self.box_score_thresh = rpn_nms_thresh, box_score_thresh
        act_layer = act_layer or leaky_relu_01()
        common = {"norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        self.backbone = DarknetBodyV2(layout, in_channels, stem_channels, True, act_layer,
                                      backbone_norm_layer if backbone_norm_layer is not None else norm_layer,
                                      drop_layer, conv_layer)
        top, mid = layout[-1][0], layout[-2][0] // passthrough_ratio
        self.block5 = nn.Sequential(
            *conv_sequence(top, top, act_layer, kernel_size=3, padding=1, **common),
            *conv_sequence(top, top, act_layer, kernel_size=3, padding=1, **common),
        )
        self.passthrough_layer = nn.Sequential(*conv_sequence(layout[-2][0], mid, act_layer, kernel_size=1, **common))
        self.block6 = nn.Sequential(*conv_sequence(4 * mid + top, top, act_layer, kernel_size=3, padding=1, **common))
        self.head = nn.Conv2d(top, self.num_anchors * (5 + num_classes), 1)
        self.register_buffer("anchors", torch.tensor(anchors, dtype=torch.float32), persistent=False)
        init_darknet_weights(self, generator)
        self.to(device)

    def _outputs(self, x: torch.Tensor, target: Optional[Dict[str, torch.Tensor]]):
        out, passthrough = self.backbone(x)
        out = self.block5(out)
        passthrough = self.passthrough_layer(passthrough)
        passthrough = concat_downsample2d(passthrough.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)
        out = self.head(self.block6(torch.cat([passthrough, out], dim=1)))

        b, _, h, w = out.shape
        nc = self.num_classes
        out = out.permute(0, 2, 3, 1).reshape(b, h, w, self.num_anchors, 5 + nc)
        b_scores = torch.softmax(out[..., -nc:], dim=-1)
        anchors = self.anchors.to(out.dtype)
        c_x = torch.arange(w, dtype=out.dtype, device=out.device).reshape(1, 1, -1, 1)
        c_y = torch.arange(h, dtype=out.dtype, device=out.device).reshape(1, -1, 1, 1)
        b_x = (torch.sigmoid(out[..., 0]) + c_x) / w
        b_y = (torch.sigmoid(out[..., 1]) + c_y) / h
        b_w = anchors[:, 0] * torch.exp(out[..., 2])
        b_h = anchors[:, 1] * torch.exp(out[..., 3])
        b_o = torch.sigmoid(out[..., 4])
        xy = torch.stack([b_x, b_y], dim=-1)
        wh = torch.stack([b_w, b_h], dim=-1)
        pred_xyxy = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
        if target is not None:
            return yolo_v12_losses(pred_xyxy, xy, wh, b_o, b_scores, target, *self.lambdas)
        return pred_xyxy.reshape(b, -1, 4), b_o.reshape(b, -1), b_scores.reshape(b, -1, nc)


def yolov2(pretrained: bool = False, pretrained_backbone: bool = True, **kwargs: Any) -> YOLOv2:
    """YOLOv2 (``yolov2.py:140-152``) on the darknet19 layout. ``pretrained_backbone``
    freezes the backbone's normalization (``FrozenBatchNorm2d``, ``yolov2.py:143-145``)
    and warns that no weights were loaded (:func:`warn_no_backbone_weights`)."""
    if pretrained:
        raise NotImplementedError("pretrained weights are not ported yet; build with pretrained=False")
    if pretrained_backbone:
        kwargs["backbone_norm_layer"] = FrozenBatchNorm2d
        warn_no_backbone_weights("yolov2")
    return YOLOv2(DARKNET19_LAYOUT, **kwargs)
