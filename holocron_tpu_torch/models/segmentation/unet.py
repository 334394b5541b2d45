"""U-Net (`Ronneberger et al. <https://arxiv.org/pdf/1505.04597.pdf>`_) and the
fastai-style DynamicUNet over a feature-pyramid encoder: the port of
``holocron_tpu/models/segmentation/unet.py``.

NCHW in, logits ``(N, num_classes, H, W)`` out. Upsampling is half-pixel bilinear
(``F.interpolate(..., align_corners=False)``, as ``jax.image.resize``) or a transposed
conv; a UBlock shrinks its upsampled features to the skip's size by torch's legacy
nearest rule (``mode="nearest"``, ``src = floor(dst * in / out)``), as the JAX package
does, and its pixel shuffle is ``nn.PixelShuffle``, whose channel order the JAX
package's copies. DynamicUNet reads its encoder's channels from a probe at construction (flax
infers them while tracing). ``state_dict`` keys follow original Holocron: ``encoder.*``,
``bridge.*``, ``decoder.{k}.*`` (each block's layers in
:func:`~holocron_tpu_torch.models.utils.conv_sequence` order), ``upsample.*`` and
``classifier``, the keys ``_convert_dynamic_unet`` reads.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

from ...nn.init import kaiming_normal_
from ..layers import BatchNorm2d
from ..checkpoints import Checkpoint
from ..utils import _pretrained, conv_sequence

__all__ = [
    "DownPath",
    "DynamicUNet",
    "FeaturePyramid",
    "UBlock",
    "UNet",
    "UNetBackbone",
    "UpPath",
    "Upsample2d",
    "VGG11Features",
    "unet",
    "unet2",
    "unet_rexnet13",
    "unet_tvresnet34",
    "unet_tvvgg11",
    "upsample2d",
]

NormLayer = Callable[[int], nn.Module]
Device = Union[str, torch.device]

UNET_LAYOUT = [64, 128, 256, 512]  # unet's and unet2's (unet.py:23-24)
REXNET13_BLOCKS = [0, 2, 4, 10, 15]  # the blocks of the rexnet1_3x feature pyramid (unet.py:27-30)

# unet.py:22-32
default_cfgs: Dict[str, Dict[str, Any]] = {
    "unet": {"encoder_layout": UNET_LAYOUT, "url": None},
    "unet2": {"encoder_layout": UNET_LAYOUT, "url": None},
    "unet_vgg11": {"url": None},
    "unet_tvresnet34": {"url": None},
    "unet_rexnet13": {
        "backbone_blocks": REXNET13_BLOCKS,
        "url": "https://github.com/frgfm/Holocron/releases/download/v0.1.3/unet_rexnet13_256-38315ff3.pth",
    },
}


def _relu() -> nn.Module:
    return nn.ReLU(inplace=True)


_INT_MAX = 2**31 - 1


def upsample2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Half-pixel bilinear upsampling by an integer ``factor`` (``unet.py:36-38``).

    torch's channels-last bilinear kernel indexes its output in 32 bits (it refuses
    ``INT_MAX`` elements or more: unet3p's 1024-channel bottom feature upsampled to 256 x
    256 at batch 32 is 2^31), so a batch beyond that is upsampled in equal runs of
    images and concatenated."""
    h, w = x.shape[-2:]
    size = (h * factor, w * factor)
    runs = -(-x.numel() * factor * factor // (_INT_MAX - 1))
    if runs <= 1 or x.shape[0] < 2:
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)
    step = -(-x.shape[0] // runs)
    return torch.cat([F.interpolate(part, size=size, mode="bilinear", align_corners=False) for part in x.split(step)])


class Upsample2d(nn.Module):
    """:func:`upsample2d` as a module."""

    def __init__(self, factor: int = 2) -> None:
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2d(x, self.factor)


def _center_crop(feat: torch.Tensor, target_hw: Sequence[int]) -> torch.Tensor:
    """The contracting path's features cropped to the expansive size (``unet.py:50-56``)."""
    dh, dw = feat.shape[-2] - target_hw[0], feat.shape[-1] - target_hw[1]
    h0, w0 = max(dh // 2, 0), max(dw // 2, 0)
    return feat[..., h0 : h0 + target_hw[0], w0 : w0 + target_hw[1]]


def _two_convs(in_chan: int, out_chan: int, padding: int, act_layer: nn.Module, norm_layer: Optional[NormLayer],
               drop_layer: Optional[Callable[[], nn.Module]], conv_layer: Optional[Callable[..., nn.Module]]) -> list:
    common = {"drop_layer": drop_layer, "conv_layer": conv_layer, "kernel_size": 3, "padding": padding}
    return [*conv_sequence(in_chan, out_chan, act_layer, norm_layer, **common),
            *conv_sequence(out_chan, out_chan, act_layer, norm_layer, **common)]


class DownPath(nn.Sequential):
    """An optional 2x2 max pool and two 3x3 conv blocks (``unet.py:59-83``)."""

    def __init__(self, in_chan: int, out_chan: int, downsample: bool = True, padding: int = 0,
                 act_layer: Optional[nn.Module] = None, norm_layer: Optional[NormLayer] = None,
                 drop_layer: Optional[Callable[[], nn.Module]] = None,
                 conv_layer: Optional[Callable[..., nn.Module]] = None) -> None:
        layers: List[nn.Module] = [nn.MaxPool2d(2)] if downsample else []
        layers += _two_convs(in_chan, out_chan, padding, act_layer or _relu(), norm_layer, drop_layer, conv_layer)
        super().__init__(*layers)


class UpPath(nn.Module):
    """Upsampling, the skips cropped to its size and concatenated before it, then two
    3x3 conv blocks (``unet.py:86-118``). ``in_chan`` is the concatenation's channels;
    the upsampling is bilinear, or a 2x2 stride-2 transposed conv from ``up_chan`` to
    ``out_chan`` (flax's ``ConvTranspose`` does not flip its kernel: the converter
    flips it)."""

    def __init__(self, in_chan: int, up_chan: int, out_chan: int, bilinear_upsampling: bool = True, padding: int = 0,
                 act_layer: Optional[nn.Module] = None, norm_layer: Optional[NormLayer] = None,
                 drop_layer: Optional[Callable[[], nn.Module]] = None,
                 conv_layer: Optional[Callable[..., nn.Module]] = None) -> None:
        super().__init__()
        self.upsample = Upsample2d(2) if bilinear_upsampling else nn.ConvTranspose2d(up_chan, out_chan, 2, stride=2)
        self.block = nn.Sequential(
            *_two_convs(in_chan, out_chan, padding, act_layer or _relu(), norm_layer, drop_layer, conv_layer))

    def forward(self, downfeats: Union[torch.Tensor, Sequence[torch.Tensor]], upfeat: torch.Tensor) -> torch.Tensor:
        if isinstance(downfeats, torch.Tensor):
            downfeats = [downfeats]
        up = self.upsample(upfeat)
        skips = [_center_crop(f, up.shape[-2:]) for f in downfeats]
        return self.block(torch.cat([*skips, up], dim=1))


@torch.no_grad()
def _init_weights(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Fan-out He-normal weights for every conv (a transposed conv's fan-out from its
    ``O * kh * kw``, as flax's HWIO kernel gives it) and zero biases, in module order,
    from ``generator``; norms keep ones and zeros."""
    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):
            kaiming_normal_(m.weight.transpose(0, 1), generator=generator)
        elif isinstance(m, nn.Conv2d):
            kaiming_normal_(m.weight, generator=generator)
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)


class UNet(nn.Module):
    """The plain U-Net (``unet.py:121-162``): ``len(layout)`` contracting paths, a
    bridge (max pool, ``2 * layout[-1]`` then ``layout[-1]`` channels), the expansive
    paths and a 1x1 classifier. Without ``norm_layer`` the convs are biased;
    ``same_padding=False`` reproduces the original U-Net's shrinking maps.

    Weights are drawn from ``generator`` on the CPU (:func:`_init_weights`), then moved
    to ``device``: the card unless the caller asks for the CPU (``device="cpu"``).
    """

    def __init__(
        self,
        layout: Sequence[int],
        in_channels: int = 3,
        num_classes: int = 10,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        same_padding: bool = True,
        bilinear_upsampling: bool = True,
        device: Device = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        layout = list(layout)
        act_layer = act_layer or _relu()
        common = {"act_layer": act_layer, "norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        pad = int(same_padding)
        self.encoder = nn.ModuleList(
            DownPath(c_in, c_out, idx > 0, pad, **common)
            for idx, (c_in, c_out) in enumerate(zip([in_channels, *layout[:-1]], layout)))
        self.bridge = nn.Sequential(nn.MaxPool2d(2), *_two_bridge_convs(layout[-1], **common))
        rev = layout[::-1]
        out_chans = [c // 2 if bilinear_upsampling else c for c in rev[:-1]] + [layout[0]]
        up_chans = [layout[-1], *out_chans[:-1]]
        self.decoder = nn.ModuleList(
            UpPath(skip + (up if bilinear_upsampling else out), up, out, bilinear_upsampling, pad, **common)
            for skip, up, out in zip(rev, up_chans, out_chans))
        self.classifier = nn.Conv2d(layout[0], num_classes, 1)
        _init_weights(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = []
        for down in self.encoder:
            x = down(x)
            xs.append(x)
        x = self.bridge(x)
        for up in self.decoder:
            x = up(xs.pop(), x)
        return self.classifier(x)


def _two_bridge_convs(chan: int, act_layer: nn.Module, norm_layer: Optional[NormLayer],
                      drop_layer: Optional[Callable[[], nn.Module]],
                      conv_layer: Optional[Callable[..., nn.Module]]) -> list:
    """The bridge's 3x3 convs, ``chan -> 2 chan -> chan``, padded whatever the model's
    padding (``unet.py:150-153``)."""
    common = {"drop_layer": drop_layer, "conv_layer": conv_layer, "kernel_size": 3, "padding": 1}
    return [*conv_sequence(chan, 2 * chan, act_layer, norm_layer, **common),
            *conv_sequence(2 * chan, chan, act_layer, norm_layer, **common)]


class UBlock(nn.Module):
    """The fastai-style up block (``unet.py:165-203``): a 1x1 conv to ``4 up_chan`` and
    a pixel shuffle (``upsample``), shrunk to the skip's size where it differs (legacy
    nearest), the skip through its own norm (``bn``), both concatenated, activated and
    through two 3x3 conv blocks (``block``)."""

    def __init__(self, left_chan: int, up_chan: int, out_chan: int, padding: int = 0,
                 act_layer: Optional[nn.Module] = None, norm_layer: Optional[NormLayer] = None,
                 drop_layer: Optional[Callable[[], nn.Module]] = None,
                 conv_layer: Optional[Callable[..., nn.Module]] = None) -> None:
        super().__init__()
        act_layer = act_layer or _relu()
        self.upsample = nn.Sequential(
            *conv_sequence(up_chan, 4 * up_chan, act_layer, norm_layer, drop_layer, conv_layer, kernel_size=1),
            nn.PixelShuffle(2))
        self.bn = BatchNorm2d(left_chan)
        self.block = nn.Sequential(
            act_layer, *_two_convs(left_chan + up_chan, out_chan, padding, act_layer, norm_layer, drop_layer, conv_layer))

    def forward(self, downfeat: torch.Tensor, upfeat: torch.Tensor) -> torch.Tensor:
        up = self.upsample(upfeat)
        if up.shape[-2:] != downfeat.shape[-2:]:
            up = F.interpolate(up, size=downfeat.shape[-2:], mode="nearest")
        return self.block(torch.cat([self.bn(downfeat), up], dim=1))


class FeaturePyramid(nn.Sequential):
    """An encoder: a ``Sequential`` whose forward returns the outputs of the layers at
    ``taps`` (original Holocron's ``IntermediateLayerGetter``), and runs no layer past
    the last of them."""

    def __init__(self, layers: Sequence[nn.Module], taps: Sequence[int]) -> None:
        super().__init__(*layers)
        self.taps = tuple(sorted(taps))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for idx, layer in enumerate(self):
            x = layer(x)
            if idx in self.taps:
                feats.append(x)
                if idx == self.taps[-1]:
                    break
        return feats


class UNetBackbone(FeaturePyramid):
    """The U-Net contracting path as a pyramid, one output a path (``unet.py:206-235``;
    ``unet2``'s encoder)."""

    def __init__(self, layout: Sequence[int], in_channels: int = 3, act_layer: Optional[nn.Module] = None,
                 norm_layer: Optional[NormLayer] = None, same_padding: bool = True) -> None:
        chans = [in_channels, *layout]
        paths = [DownPath(c_in, c_out, idx > 0, int(same_padding), act_layer or _relu(), norm_layer)
                 for idx, (c_in, c_out) in enumerate(zip(chans[:-1], chans[1:]))]
        super().__init__(paths, range(len(paths)))


class VGG11Features(FeaturePyramid):
    """A VGG-11 feature pyramid (``unet.py:238-256``): biased 3x3 convs and ReLU, a max
    pool before each stage but the first, the features after each stage."""

    def __init__(self, in_channels: int = 3, act_layer: Optional[nn.Module] = None) -> None:
        act_layer = act_layer or _relu()
        layers: List[nn.Module] = []
        taps = []
        chan = in_channels
        for s, widths in enumerate([(64,), (128,), (256, 256), (512, 512), (512, 512)]):
            if s > 0:
                layers.append(nn.MaxPool2d(2))
            for width in widths:
                layers += [nn.Conv2d(chan, width, 3, padding=1), act_layer]
                chan = width
            taps.append(len(layers) - 1)
        super().__init__(layers, taps)


@torch.no_grad()
def _probe_channels(encoder: nn.Module, in_channels: int, size: int = 64) -> List[int]:
    """The channels of each feature of ``encoder``, from one eval forward on zeros (eval:
    no norm's running statistics change)."""
    was_training = encoder.training
    encoder.eval()
    try:
        feats = encoder(torch.zeros(1, in_channels, size, size, device=next(encoder.parameters()).device))
    finally:
        encoder.train(was_training)
    return [f.shape[1] for f in feats]


class DynamicUNet(nn.Module):
    """A U-Net over a feature-pyramid ``encoder`` (``unet.py:259-304``): the deepest
    feature through its own norm, the activation and two 3x3 conv blocks (``bridge``,
    ``2 c`` then ``c`` channels), one :class:`UBlock` a feature from the deepest up
    (``decoder``), optionally a 1x1 conv to ``4 c`` and a pixel shuffle (``upsample``),
    and a 1x1 classifier. The channels are probed from the encoder at construction
    (:func:`_probe_channels`).

    Weights are drawn from ``generator`` on the CPU (:func:`_init_weights`, the
    encoder's too), then moved to ``device``: the card unless the caller asks for the
    CPU (``device="cpu"``).
    """

    def __init__(
        self,
        encoder: nn.Module,
        num_classes: int = 10,
        act_layer: Optional[nn.Module] = None,
        norm_layer: Optional[NormLayer] = None,
        drop_layer: Optional[Callable[[], nn.Module]] = None,
        conv_layer: Optional[Callable[..., nn.Module]] = None,
        same_padding: bool = True,
        final_upsampling: bool = False,
        in_channels: int = 3,
        device: Device = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        act_layer = act_layer or _relu()
        common = {"act_layer": act_layer, "norm_layer": norm_layer, "drop_layer": drop_layer, "conv_layer": conv_layer}
        self.encoder = encoder
        chans = _probe_channels(encoder, in_channels)
        self.bridge = nn.Sequential(BatchNorm2d(chans[-1]), act_layer, *_two_bridge_convs(chans[-1], **common))
        layout = chans[::-1][1:] + [chans[0]]
        up_chans = [chans[-1], *layout[:-1]]
        self.decoder = nn.ModuleList(
            UBlock(left, up, out, int(same_padding), **common)
            for left, up, out in zip(chans[::-1], up_chans, layout))
        self.upsample = None
        if final_upsampling:
            self.upsample = nn.Sequential(
                *conv_sequence(layout[-1], 4 * layout[-1], act_layer, norm_layer, drop_layer, conv_layer,
                               kernel_size=1),
                nn.PixelShuffle(2))
        self.classifier = nn.Conv2d(layout[-1], num_classes, 1)
        _init_weights(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = self.encoder(x)
        x = self.bridge(xs[-1])
        for block in self.decoder:
            x = block(xs.pop(), x)
        if self.upsample is not None:
            x = self.upsample(x)
        return self.classifier(x)


def _pretrained_unet(model: nn.Module, arch: str, pretrained: bool, checkpoint: Optional[Checkpoint],
                     progress: bool) -> nn.Module:
    """``default_cfg`` and the weights of ``default_cfgs[arch]["url"]`` (``unet.py:307-325``):
    only unet_rexnet13 has a URL; the others warn "Invalid model URL" with
    ``pretrained``."""
    return _pretrained(model, pretrained, checkpoint, progress, default_cfgs[arch])


def unet(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
         **kwargs: Any) -> UNet:
    """U-Net (``unet.py:315-317``)."""
    return _pretrained_unet(UNet(UNET_LAYOUT, **kwargs), "unet", pretrained, checkpoint, progress)


def _dynamic_unet(encoder: nn.Module, num_classes: int = 21, **kwargs: Any) -> DynamicUNet:
    return DynamicUNet(encoder, num_classes=num_classes, **kwargs)


def unet2(pretrained: bool = False, checkpoint: Optional[Checkpoint] = None, progress: bool = True,
          in_channels: int = 3, **kwargs: Any) -> DynamicUNet:
    """U-Net with fastai-style upscaling over the plain encoder (``unet.py:328-331``)."""
    encoder = UNetBackbone(UNET_LAYOUT, in_channels)
    return _pretrained_unet(_dynamic_unet(encoder, in_channels=in_channels, **kwargs), "unet2", pretrained,
                            checkpoint, progress)


def unet_tvvgg11(pretrained: bool = False, pretrained_backbone: bool = True, checkpoint: Optional[Checkpoint] = None,
                 progress: bool = True, **kwargs: Any) -> DynamicUNet:
    """DynamicUNet over a VGG-11 encoder (``unet.py:334-336``); ``pretrained_backbone``
    does nothing, as in the JAX package."""
    return _pretrained_unet(_dynamic_unet(VGG11Features(kwargs.get("in_channels", 3)), **kwargs), "unet_vgg11",
                            pretrained, checkpoint, progress)


def unet_tvresnet34(pretrained: bool = False, pretrained_backbone: bool = True,
                    checkpoint: Optional[Checkpoint] = None, progress: bool = True, **kwargs: Any) -> DynamicUNet:
    """DynamicUNet over a ResNet-34 encoder with the final upsampling
    (``unet.py:339-344``); ``pretrained_backbone`` does nothing, as in the JAX package."""
    from .encoders import ResNet34Features

    kwargs.setdefault("final_upsampling", True)
    return _pretrained_unet(_dynamic_unet(ResNet34Features(kwargs.get("in_channels", 3)), **kwargs),
                            "unet_tvresnet34", pretrained, checkpoint, progress)


def unet_rexnet13(pretrained: bool = False, pretrained_backbone: bool = True, checkpoint: Optional[Checkpoint] = None,
                  progress: bool = True, in_channels: int = 3, **kwargs: Any) -> DynamicUNet:
    """DynamicUNet over a ReXNet-1.3x encoder, SiLU in the decoder, with the final
    upsampling (``unet.py:347-356``); ``pretrained_backbone`` does nothing, as in the
    JAX package. ``pretrained`` loads the v0.1.3 release (``unet.py:27-30``)."""
    from .encoders import ReXNetFeatures

    kwargs.setdefault("final_upsampling", True)
    kwargs.setdefault("act_layer", nn.SiLU(inplace=True))
    encoder = ReXNetFeatures(1.3, out_blocks=REXNET13_BLOCKS, in_channels=in_channels)
    return _pretrained_unet(_dynamic_unet(encoder, in_channels=in_channels, **kwargs), "unet_rexnet13", pretrained,
                            checkpoint, progress)
