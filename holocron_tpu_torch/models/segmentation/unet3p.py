"""UNet3+ (`Huang et al. <https://arxiv.org/pdf/2004.08790.pdf>`_), the port of
``holocron_tpu/models/segmentation/unet3p.py``: full-scale aggregation, each decoder
row concatenating the shallower encoder features max-pooled to its size, its own skip,
and the deeper rows bilinear-upsampled to it, each projected to ``layout[0]`` channels.

``state_dict`` keys: ``encoder.{i}`` (:class:`DownPath`), ``decoder.{row}``
(:class:`FSAggreg`: ``downsamples.{k}.1``, ``skip``, ``upsamples.{k}.1`` and ``block``)
and ``classifier``.
"""

from typing import Any, Callable, List, Optional, Sequence, Union

import torch
from torch import nn

from ..layers import BatchNorm2d
from ..utils import conv_sequence
from .unet import DownPath, Upsample2d, _check_pretrained, _init_weights, _relu

__all__ = ["FSAggreg", "UNet3p", "unet3p"]

NormLayer = Callable[[int], nn.Module]

LAYOUT = [64, 128, 256, 512, 1024]  # unet3p's (unet3p.py:23)


class FSAggreg(nn.Module):
    """The full-scale aggregation block (``unet3p.py:27-71``): for ``e_chans`` shallower
    encoder features, a max pool by ``2 ** (len(e_chans) - k)`` and a biased 3x3 conv
    each (``downsamples``); a biased 3x3 conv of the row's own feature of ``skip_chan``
    channels (``skip``; the feature as it is in the top row, which has no shallower
    one); for ``d_chans`` deeper features, a bilinear upsampling by ``2 ** (k + 1)`` and
    a biased 3x3 conv each (``upsamples``); all at ``base_chan``, concatenated in that
    order, then a 3x3 conv block to ``depth * base_chan`` (``block``)."""

    def __init__(self, e_chans: Sequence[int], skip_chan: int, d_chans: Sequence[int], base_chan: int,
                 act_layer: Optional[nn.Module] = None, norm_layer: Optional[NormLayer] = BatchNorm2d,
                 drop_layer: Optional[Callable[[], nn.Module]] = None,
                 conv_layer: Optional[Callable[..., nn.Module]] = None) -> None:
        super().__init__()
        self.downsamples = nn.ModuleList(
            nn.Sequential(nn.MaxPool2d(2 ** (len(e_chans) - k)), nn.Conv2d(c, base_chan, 3, padding=1))
            for k, c in enumerate(e_chans))
        self.skip = nn.Conv2d(skip_chan, base_chan, 3, padding=1) if e_chans else nn.Identity()
        self.upsamples = nn.ModuleList(
            nn.Sequential(Upsample2d(2 ** (k + 1)), nn.Conv2d(c, base_chan, 3, padding=1))
            for k, c in enumerate(d_chans))
        depth = len(e_chans) + 1 + len(d_chans)
        self.block = nn.Sequential(*conv_sequence(depth * base_chan, depth * base_chan, act_layer or _relu(),
                                                  norm_layer, drop_layer, conv_layer, kernel_size=3, padding=1))

    def forward(self, downfeats: Sequence[torch.Tensor], feat: torch.Tensor,
                upfeats: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(downfeats) != len(self.downsamples) or len(upfeats) != len(self.upsamples):
            raise ValueError(
                f"Expected {len(self.downsamples)} encoding & {len(self.upsamples)} decoding features, "
                f"received: {len(downfeats)} & {len(upfeats)}")
        parts = [down(f) for down, f in zip(self.downsamples, downfeats)]
        parts.append(self.skip(feat))
        parts += [up(f) for up, f in zip(self.upsamples, upfeats)]
        return self.block(torch.cat(parts, dim=1))


class UNet3p(nn.Module):
    """UNet3+ (``unet3p.py:74-111``): the contracting path of ``layout``, then the
    decoder rows from the deepest but one up to the top (``decoder.{row}``, each
    ``len(layout) * layout[0]`` wide), and a 1x1 classifier on the top row. Conv blocks
    take ``norm_layer`` (batch norm by default, the biased convs of :class:`FSAggreg`
    none).

    Weights are drawn from ``generator`` on the CPU (fan-out He-normal convs, zero
    biases), then moved to ``device``: the card unless the caller asks for the CPU
    (``device="cpu"``).
    """

    def __init__(
        self,
        layout: Sequence[int],
        in_channels: int = 3,
        num_classes: int = 10,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = BatchNorm2d,
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
        width = len(layout) * layout[0]  # every decoder row's output
        self.decoder = nn.ModuleList(
            FSAggreg(layout[:row], layout[row], [width] * (len(layout) - 2 - row) + [layout[-1]], layout[0], **common)
            for row in range(len(layout) - 1))
        self.classifier = nn.Conv2d(width, num_classes, 1)
        _init_weights(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs: List[torch.Tensor] = []
        for down in self.encoder:
            x = down(x)
            xs.append(x)
        # deepest row first (unet3p.py:98-105)
        for row in range(len(xs) - 2, -1, -1):
            xs[row] = self.decoder[row](xs[:row], xs[row], xs[row + 1:])
        return self.classifier(xs[0])


def unet3p(pretrained: bool = False, **kwargs: Any) -> UNet3p:
    """UNet3+ (``unet3p.py:122-124``)."""
    _check_pretrained(pretrained)
    return UNet3p(LAYOUT, **kwargs)
