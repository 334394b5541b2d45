"""UNet+ and UNet++ (`Zhou et al. <https://arxiv.org/pdf/1912.05074.pdf>`_), the port of
``holocron_tpu/models/segmentation/unetpp.py``: the nested cascade and the dense skip
grid over the U-Net's contracting path and bridge, with bilinear upsampling.

``state_dict`` keys: ``encoder.{i}`` (:class:`DownPath`), ``bridge``, ``decoder.{i}.{j}``
(the :class:`UpPath` of level ``i``, shallowest 0, cell ``j``; the JAX package's
``decoder_{i}_{j}``) and ``classifier``.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from ..checkpoints import Checkpoint
from ..utils import _pretrained
from .unet import DownPath, UpPath, _init_weights, _relu, _two_bridge_convs

__all__ = ["UNetp", "UNetpp", "unetp", "unetpp"]

NormLayer = Callable[[int], nn.Module]

LAYOUT = [64, 128, 256, 512]  # unetp's and unetpp's (unetpp.py:23-24)
default_cfgs: Dict[str, Dict[str, Any]] = {
    "unetp": {"arch": "UNetp", "layout": LAYOUT, "url": None},
    "unetpp": {"arch": "UNetpp", "layout": LAYOUT, "url": None},
}


class _NestedUNet(nn.Module):
    """The encoder, bridge and classifier the nested variants share (``unetpp.py:27-59``);
    ``dense`` gives each decoder cell of a level every earlier cell of it as skips
    (UNet++), else only the last (UNet+). Weights are drawn from ``generator`` on the
    CPU, then moved to ``device``: the card unless the caller asks for the CPU."""

    dense = False

    def __init__(
        self,
        layout: Sequence[int],
        in_channels: int = 3,
        num_classes: int = 10,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        layout = list(layout)
        common = {"act_layer": act_layer or _relu(), "norm_layer": norm_layer, "drop_layer": drop_layer,
                  "conv_layer": conv_layer}
        self.encoder = nn.ModuleList(
            DownPath(c_in, c_out, idx > 0, 1, **common)
            for idx, (c_in, c_out) in enumerate(zip([in_channels, *layout[:-1]], layout)))
        self.bridge = nn.Sequential(nn.MaxPool2d(2), *_two_bridge_convs(layout[-1], **common))
        # level i has a cell a row j < len(layout) - i; its upsampled input is level i + 1
        # (the bridge below the deepest level), of layout[i + 1] channels
        self.decoder = nn.ModuleList(
            nn.ModuleList(
                UpPath((j + 1 if self.dense else 1) * layout[i] + up, up, layout[i], True, 1, **common)
                for j in range(len(layout) - i))
            for i, up in enumerate([*layout[1:], layout[-1]]))
        self.classifier = nn.Conv2d(layout[0], num_classes, 1)
        _init_weights(self, generator)
        self.to(device)

    def _encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        xs = []
        for down in self.encoder:
            x = down(x)
            xs.append(x)
        return [*xs, self.bridge(x)]


class UNetp(_NestedUNet):
    """UNet+ (``unetpp.py:62-79``): row by row, each level refined with the level below
    it, the deepest level of a row with what is left below it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = self._encode(x)
        for j in range(len(self.encoder)):
            for i in range(len(xs) - 1):
                up = xs[i + 1] if i + 2 < len(xs) else xs.pop()
                xs[i] = self.decoder[i][j](xs[i], up)
        return self.classifier(xs.pop())


class UNetpp(_NestedUNet):
    """UNet++ (``unetpp.py:82-100``): each cell sees every earlier cell of its level."""

    dense = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = [[f] for f in self._encode(x)]
        for j in range(len(self.encoder)):
            for i in range(len(xs) - 1):
                up = xs[i + 1][j] if i + 2 < len(xs) else xs.pop()[-1]
                xs[i].append(self.decoder[i][j](xs[i], up))
        return self.classifier(xs.pop()[-1])


def unetp(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
          **kwargs: Any) -> UNetp:
    """UNet+ (``unetpp.py:103-114``); ``pretrained`` warns: no release has a URL."""
    return _pretrained(UNetp(LAYOUT, **kwargs), pretrained, checkpoint, progress, default_cfgs["unetp"])


def unetpp(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
           **kwargs: Any) -> UNetpp:
    """UNet++ (``unetpp.py:103-119``); ``pretrained`` warns: no release has a URL."""
    return _pretrained(UNetpp(LAYOUT, **kwargs), pretrained, checkpoint, progress, default_cfgs["unetpp"])
