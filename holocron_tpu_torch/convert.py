"""JAX-package variables -> the port's ``state_dict``.

The inverse of ``holocron_tpu/models/_torch_convert.py``. Variables are nested dicts
of arrays (numpy, or anything ``np.asarray`` takes), ``{"params": ..., "batch_stats": ...}``.

- conv kernels: HWIO ``(kh, kw, I, O)`` -> OIHW ``(O, I, kh, kw)``
- dense kernels: ``(in, out)`` -> ``(out, in)``
- batch norm: ``scale/bias`` + ``mean/var`` -> ``weight/bias/running_mean/running_var``
  (and ``num_batches_tracked = 0``, which torch keeps and the JAX package does not)
- frozen batch norm: ``scale/bias/mean/var``, all statistics, -> the same four buffers
"""

from typing import Any, Dict, Mapping, Sequence, Union

import numpy as np
import torch
from torch import nn

from .models.classification.darknet import DarknetBodyV1, DarknetV1
from .models.classification.darknetv2 import DarknetBodyV2, DarknetV2
from .models.classification.darknetv3 import DarknetBodyV3, DarknetV3, ResBlock
from .models.classification.darknetv4 import DarknetV4
from .models.classification.res2net import ScaleConv2d
from .models.classification.resnet import ResNet
from .models.classification.rexnet import ReXNet, SEBlock
from .models.classification.sknet import SKConv2d
from .models.classification.tridentnet import TridentConv2d
from .models.detection import YOLOv1, YOLOv2, YOLOv4
from .models.layers import FrozenBatchNorm2d
from .models.segmentation import (DynamicUNet, ReXNetFeatures, ResNet34Features, UNet, UNet3p, UNetBackbone, UpPath,
                                  VGG11Features)
from .models.segmentation.unetpp import _NestedUNet
from .nn.modules.conv import PyConv2d

__all__ = [
    "add2d_state_dict",
    "darknet_state_dict",
    "detection_state_dict",
    "involution_state_dict",
    "nn_state_dict",
    "repvgg_state_dict",
    "resnet_state_dict",
    "rexnet_state_dict",
    "segmentation_state_dict",
]


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel, dtype=np.float32).transpose(3, 2, 0, 1)))


def _dense(kernel: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel, dtype=np.float32).T))


def _bn(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def repvgg_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`~holocron_tpu_torch.models.RepVGG` from the JAX RepVGG's
    variables, in train form (``conv_3x3``/``bn_3x3``/``conv_1x1``/``bn_1x1``/``bn_id``)
    or deploy form (``rep_conv``). Keys ``features.{s}.{j}.branches...`` and ``head.*``.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for name, block in params.items():
        if name == "head":
            sd["head.weight"] = _dense(block["kernel"])
            sd["head.bias"] = _t(block["bias"])
            continue
        _, s, j = name.split("_")  # features_{s}_{j}
        t = f"features.{s}.{j}.branches"
        if "rep_conv" in block:
            sd[f"{t}.weight"] = _conv(block["rep_conv"]["kernel"])
            sd[f"{t}.bias"] = _t(block["rep_conv"]["bias"])
            continue
        sd[f"{t}.0.0.weight"] = _conv(block["conv_3x3"]["kernel"])
        _bn(sd, f"{t}.0.1", block["bn_3x3"], stats[name]["bn_3x3"])
        sd[f"{t}.1.0.weight"] = _conv(block["conv_1x1"]["kernel"])
        _bn(sd, f"{t}.1.1", block["bn_1x1"], stats[name]["bn_1x1"])
        if "bn_id" in block:
            _bn(sd, f"{t}.2", block["bn_id"], stats[name]["bn_id"])
    return sd


def involution_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`~holocron_tpu_torch.nn.Involution2d` (keys ``reduce.*``
    and ``span.*``) from the JAX ``Involution2d``'s variables."""
    params = variables["params"]
    return {
        f"{name}.{key}": (_conv(params[name]["kernel"]) if key == "weight" else _t(params[name]["bias"]))
        for name in ("reduce", "span")
        for key in ("weight", "bias")
    }


def add2d_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`~holocron_tpu_torch.nn.Add2d` (``weight`` OIHW and, where
    the layer has one, ``bias``) from the JAX ``Add2d``'s variables (HWIO ``kernel``)."""
    params = variables["params"]
    sd = {"weight": _conv(params["kernel"])}
    if "bias" in params:
        sd["bias"] = _t(params["bias"])
    return sd


def _node(tree: Mapping, path: str) -> Mapping:
    for key in path.split("/"):
        tree = tree.get(key, {})
    return tree


def _conv_at(sd: Dict[str, torch.Tensor], prefix: str, node: Mapping) -> None:
    """A conv's ``kernel`` (HWIO) and, where it has one, ``bias``."""
    sd[f"{prefix}.weight"] = _conv(node["kernel"])
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _norm_at(sd: Dict[str, torch.Tensor], prefix: str, variables: Mapping, path: str) -> None:
    """A batch norm, or a frozen one (``FrozenBatchNorm2d``: no parameters, all four
    tensors in ``batch_stats``)."""
    params, stats = _node(variables["params"], path), _node(variables.get("batch_stats", {}), path)
    if "scale" in params:
        _bn(sd, prefix, params, stats)
        return
    for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
        sd[f"{prefix}.{ours}"] = _t(stats[theirs])


def resnet_state_dict(variables: Mapping, model: ResNet) -> Dict[str, torch.Tensor]:
    """State dict of a :class:`~holocron_tpu_torch.models.ResNet` (any block of the
    family) from the JAX ``ResNet``'s variables; the inverse of ``_convert_resnet``
    (``holocron_tpu/models/_torch_convert.py:117-194``).

    The feature indices come from ``model``'s layout (``deep_stem``, ``stem_pool``,
    ``num_repeats``, its stages), and each block's keys from its ``conv`` layers in
    order: the ``k``-th conv of a block (a conv, a :class:`ScaleConv2d`, an
    :class:`SKConv2d` or a :class:`PyConv2d`) is the JAX block's ``conv_{k}``, the layer
    after a conv or a pyramid its norm; then the shortcut and the head.
    """
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}

    def conv_norm(conv_key: str, norm_key: str, path: str) -> None:
        _conv_at(sd, conv_key, _node(params, f"{path}/conv"))
        _norm_at(sd, norm_key, variables, f"{path}/bn")

    idx = 0
    for s in range(3 if model.deep_stem else 1):
        conv_norm(f"features.{idx}", f"features.{idx + 1}", f"stem_{s}")
        idx += 3  # conv, norm, act
    idx += int(model.stem_pool) + int(model.num_repeats > 1)
    for i, stage in enumerate(model.features[idx:]):
        for j, block in enumerate(stage):
            t, d = f"features.{idx + i}.{j}", f"layer_{i}_{j}"
            k = 0
            for off, layer in enumerate(block.conv):
                src, dst = f"{d}/conv_{k}", f"{t}.conv.{off}"
                if isinstance(layer, (nn.Conv2d, TridentConv2d)):
                    conv_norm(dst, f"{t}.conv.{off + 1}", src)
                elif isinstance(layer, PyConv2d):
                    for level in range(len(layer)):
                        _conv_at(sd, f"{dst}.{level}", _node(params, f"{src}/conv/level{level}"))
                    _norm_at(sd, f"{t}.conv.{off + 1}", variables, f"{src}/bn")
                elif isinstance(layer, ScaleConv2d):
                    for n in range(len(layer.conv)):
                        conv_norm(f"{dst}.conv.{n}.0", f"{dst}.conv.{n}.1", f"{src}/conv_{n}")
                elif isinstance(layer, SKConv2d):
                    for n in range(len(layer.path_convs)):
                        conv_norm(f"{dst}.path_convs.{n}.0", f"{dst}.path_convs.{n}.1", f"{src}/path_{n}")
                    conv_norm(f"{dst}.sa.1", f"{dst}.sa.2", f"{src}/sa/fc1")
                    _conv_at(sd, f"{dst}.sa.4", _node(params, f"{src}/sa/fc2/conv"))
                else:
                    continue
                k += 1
            if block.downsample is not None:
                off = len(block.downsample) - 2  # 1 after ResNet-D's pool
                conv_norm(f"{t}.downsample.{off}", f"{t}.downsample.{off + 1}", f"{d}/downsample/proj")
    sd["head.weight"] = _dense(params["head"]["kernel"])
    sd["head.bias"] = _t(params["head"]["bias"])
    return sd


def _conv_norm(sd: Dict[str, torch.Tensor], variables: Mapping, conv_key: str, norm_key: str, path: str) -> None:
    """A JAX ``ConvSequence``'s conv and norm at ``path`` as the port's two layers."""
    _conv_at(sd, conv_key, _node(variables["params"], f"{path}/conv"))
    _norm_at(sd, norm_key, variables, f"{path}/bn")


def _rexblock(sd: Dict[str, torch.Tensor], variables: Mapping, t: str, d: str, block: nn.Module) -> None:
    """A :class:`ReXBlock`'s ``conv`` layers at ``t`` from the JAX block at ``d``: its
    ``expand`` (conv, norm, act; when it expands), ``dw`` (conv, norm), ``se``
    (``.conv.0``/``.1`` fc1's conv and norm, ``.conv.3`` fc2's conv), the activation and
    ``project`` (conv, norm)."""
    names = ["expand", "dw"] if block.t != 1 else ["dw"]
    off = 0
    for name in names:
        _conv_norm(sd, variables, f"{t}.{off}", f"{t}.{off + 1}", f"{d}/{name}")
        off += 3 if name == "expand" else 2
    if isinstance(block.conv[off], SEBlock):
        _conv_norm(sd, variables, f"{t}.{off}.conv.0", f"{t}.{off}.conv.1", f"{d}/se/fc1")
        _conv_at(sd, f"{t}.{off}.conv.3", _node(variables["params"], f"{d}/se/fc2/conv"))
        off += 1
    _conv_norm(sd, variables, f"{t}.{off + 1}", f"{t}.{off + 2}", f"{d}/project")


def rexnet_state_dict(variables: Mapping, model: ReXNet) -> Dict[str, torch.Tensor]:
    """State dict of a :class:`~holocron_tpu_torch.models.ReXNet` from the JAX
    ``ReXNet``'s variables; the inverse of ``_convert_rexnet``
    (``holocron_tpu/models/_torch_convert.py:197-242``).

    ``features.0``/``.1`` are the stem's conv and norm; each block ``features.{3 + i}``
    holds, in ``conv``, the JAX block ``block_{i}``'s layers (:func:`_rexblock`); then
    the penultimate conv and norm and ``head.1``.
    """
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _conv_norm(sd, variables, "features.0", "features.1", "stem")
    blocks = model.features[3:-3]
    for i, block in enumerate(blocks):
        _rexblock(sd, variables, f"features.{3 + i}.conv", f"block_{i}", block)
    pen = 3 + len(blocks)
    _conv_norm(sd, variables, f"features.{pen}", f"features.{pen + 1}", "penultimate")
    sd["head.1.weight"] = _dense(params["head"]["kernel"])
    sd["head.1.bias"] = _t(params["head"]["bias"])
    return sd


def nn_state_dict(variables: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """State dict of a module of the nn catalog (``FReLU``, ``SAM``, ``DimAttention``,
    ``TripletAttention``, ``LambdaLayer``, ``NormConv2d``, ``SlimConv2d``) from the JAX
    module's variables. The port's submodules carry the JAX names, so each is read at
    its path: a conv's ``kernel`` (HWIO -> OIHW) and ``bias``, a norm's parameters and
    statistics; then the module's own parameters: ``weight`` from ``kernel`` (HWIO ->
    OIHW), ``R`` (HWIO ``(r, r, dim_u, dim_k)`` -> ``(dim_k, dim_u, r, r)``), the rest
    (``bias``, ``pos_emb``) as they are."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name, sub in module.named_modules():
        if not name:
            continue
        path = name.replace(".", "/")
        if isinstance(sub, nn.Conv2d):
            _conv_at(sd, name, _node(params, path))
        elif isinstance(sub, nn.BatchNorm2d):
            _norm_at(sd, name, variables, path)
    for name, _ in module.named_parameters(recurse=False):
        if name == "weight":
            sd[name] = _conv(params["kernel"])
        elif name == "R":
            sd[name] = _conv(params["R"])
        else:
            sd[name] = _t(params[name])
    return sd


Names = Sequence[Union[str, Sequence[str]]]


def _layers_at(sd: Dict[str, torch.Tensor], variables: Mapping, prefix: str, seq: nn.Sequential,
               names: Names) -> None:
    """The convs of ``seq`` in order, each from the JAX path of ``names`` in turn: a conv
    block (``path/conv``, and ``path/bn`` for the norm after it), a bare conv (``path``
    holds the kernel), or, for a :class:`ResBlock`, a pair of paths for its two blocks."""
    params = variables["params"]
    todo = iter(names)
    for off, m in enumerate(seq):
        if isinstance(m, ResBlock):
            _layers_at(sd, variables, f"{prefix}.{off}.conv", m.conv, next(todo))
        elif isinstance(m, nn.Conv2d):
            path = next(todo)
            if "kernel" in _node(params, path):
                _conv_at(sd, f"{prefix}.{off}", _node(params, path))
                continue
            _conv_at(sd, f"{prefix}.{off}", _node(params, f"{path}/conv"))
            if off + 1 < len(seq) and isinstance(seq[off + 1], (nn.BatchNorm2d, FrozenBatchNorm2d)):
                _norm_at(sd, f"{prefix}.{off + 1}", variables, f"{path}/bn")
    if next(todo, None) is not None:
        raise ValueError(f"{prefix}: more JAX paths than convs")


def _darknet_body(sd: Dict[str, torch.Tensor], variables: Mapping, body: nn.Module, src: str, dest: str) -> None:
    """The keys of a darknet body (v1 to v4) under ``src`` from the JAX body at ``dest``."""
    _layers_at(sd, variables, f"{src}.stem", body.stem, [f"{dest}/stem"])
    if isinstance(body, (DarknetBodyV1, DarknetBodyV2)):
        for i, group in enumerate(body.layers):
            convs = sum(isinstance(m, nn.Conv2d) for m in group)
            _layers_at(sd, variables, f"{src}.layers.{i}", group, [f"{dest}/layer_{i}_{j}" for j in range(convs)])
    elif isinstance(body, DarknetBodyV3):
        for i, stage in enumerate(body.layers):
            blocks = [m for m in stage if isinstance(m, ResBlock)]
            names = [f"{dest}/layer_{i}_conv"] + [
                [f"{dest}/layer_{i}_block_{b}/conv_0", f"{dest}/layer_{i}_block_{b}/conv_1"]
                for b in range(len(blocks))]
            _layers_at(sd, variables, f"{src}.layers.{i}", stage, names)
    else:
        for i, stage in enumerate(body.stages):
            d, t = f"{dest}/stage_{i}", f"{src}.stages.{i}"
            blocks = sum(isinstance(m, ResBlock) for m in stage.main)
            _layers_at(sd, variables, f"{t}.base_layer", stage.base_layer, [f"{d}/base_0", f"{d}/base_1"])
            _layers_at(sd, variables, f"{t}.main", stage.main,
                       [*([f"{d}/main_{b}/conv_0", f"{d}/main_{b}/conv_1"] for b in range(blocks)), f"{d}/main_conv"])
            _layers_at(sd, variables, f"{t}.transition", stage.transition, [f"{d}/transition"])


def darknet_state_dict(variables: Mapping,
                       model: Union[DarknetV1, DarknetV2, DarknetV3, DarknetV4]) -> Dict[str, torch.Tensor]:
    """State dict of a darknet classifier (:class:`DarknetV1` to :class:`DarknetV4`) from
    the JAX one's variables; the inverse of ``_convert_darknetv1`` to ``v4``
    (``holocron_tpu/models/_torch_convert.py:244-324``, ``:394-413``). The keys of each
    conv block come from ``model``'s layers (a ``drop_layer`` shifts the offsets)."""
    sd: Dict[str, torch.Tensor] = {}
    _darknet_body(sd, variables, model.features, "features", "features")
    if isinstance(model, DarknetV2):
        _conv_at(sd, "classifier", _node(variables["params"], "classifier"))
    else:
        sd["classifier.weight"] = _dense(variables["params"]["classifier"]["kernel"])
        sd["classifier.bias"] = _t(variables["params"]["classifier"]["bias"])
    return sd


def detection_state_dict(variables: Mapping, model: Union[YOLOv1, YOLOv2, YOLOv4]) -> Dict[str, torch.Tensor]:
    """State dict of a detector (:class:`YOLOv1`, :class:`YOLOv2`, :class:`YOLOv4`) from
    the JAX one's variables, heads included. The JAX package converts the backbones only
    (``_torch_convert.py:416-438``), so the mapping of the rest is the port's own: each
    JAX ``ConvSequence`` of the neck and head to the conv and norm of the port's block in
    the same place; YOLOv1's dense layers ``classifier_0`` and ``classifier_1`` to
    ``classifier.1`` and ``classifier.4`` (both flatten in NHWC order)."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _darknet_body(sd, variables, model.backbone, "backbone", "backbone")
    if isinstance(model, YOLOv1):
        _layers_at(sd, variables, "block4", model.block4, [f"block4_{k}" for k in range(4)])
        for k, off in ((0, 1), (1, 4)):
            sd[f"classifier.{off}.weight"] = _dense(params[f"classifier_{k}"]["kernel"])
            sd[f"classifier.{off}.bias"] = _t(params[f"classifier_{k}"]["bias"])
    elif isinstance(model, YOLOv2):
        _layers_at(sd, variables, "block5", model.block5, ["block5_0", "block5_1"])
        _layers_at(sd, variables, "passthrough_layer", model.passthrough_layer, ["passthrough"])
        _layers_at(sd, variables, "block6", model.block6, ["block6"])
        _conv_at(sd, "head", params["head"])
    else:
        _layers_at(sd, variables, "neck.fpn", model.neck.fpn, [f"neck/fpn_{k}" for k in range(6)])
        for pan in ("pan1", "pan2"):
            block = getattr(model.neck, pan)
            _layers_at(sd, variables, f"neck.{pan}.conv1", block.conv1, [f"neck/{pan}/conv1"])
            _layers_at(sd, variables, f"neck.{pan}.conv2", block.conv2, [f"neck/{pan}/conv2"])
            _layers_at(sd, variables, f"neck.{pan}.convs", block.convs, [f"neck/{pan}/convs_{k}" for k in range(5)])
        head = model.head
        for name, names in (("head1", ["head1_0", "head1_1"]), ("pre_head2", ["pre_head2"]),
                            ("head2_1", [f"head2_1_{k}" for k in range(5)]), ("head2_2", ["head2_2_0", "head2_2_1"]),
                            ("pre_head3", ["pre_head3"]), ("head3", [f"head3_{k}" for k in range(7)])):
            _layers_at(sd, variables, f"head.{name}", getattr(head, name), [f"head/{n}" for n in names])
    return sd


def _up_path(sd: Dict[str, torch.Tensor], variables: Mapping, t: str, d: str, up: UpPath) -> None:
    """An :class:`UpPath` at ``t`` from the JAX one at ``d``: the two conv blocks, and a
    transposed conv's kernel flipped in both spatial axes (flax's ``ConvTranspose``
    does not flip it, torch's ``conv_transpose2d`` does), HWIO -> ``(I, O, kh, kw)``."""
    _layers_at(sd, variables, f"{t}.block", up.block, [f"{d}/conv_0", f"{d}/conv_1"])
    if isinstance(up.upsample, nn.ConvTranspose2d):
        node = _node(variables["params"], f"{d}/upconv")
        kernel = np.asarray(node["kernel"], dtype=np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)
        sd[f"{t}.upsample.weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
        sd[f"{t}.upsample.bias"] = _t(node["bias"])


def _encoder(sd: Dict[str, torch.Tensor], variables: Mapping, encoder: nn.Module) -> None:
    """A DynamicUNet's encoder from the JAX one at ``encoder``."""
    if isinstance(encoder, UNetBackbone):
        for i, down in enumerate(encoder):
            _layers_at(sd, variables, f"encoder.{i}", down, [f"encoder/encoder_{i}/conv_0", f"encoder/encoder_{i}/conv_1"])
    elif isinstance(encoder, VGG11Features):
        convs = [n for n in _node(variables["params"], "encoder") if n.startswith("conv_")]
        _layers_at(sd, variables, "encoder", encoder,
                   [f"encoder/{n}" for n in sorted(convs, key=lambda n: tuple(map(int, n.split("_")[1:])))])
    elif isinstance(encoder, ResNet34Features):
        _conv_norm(sd, variables, "encoder.0", "encoder.1", "encoder/stem_0")
        for i, stage in enumerate(list(encoder)[4:]):
            for j, block in enumerate(stage):
                t, d = f"encoder.{4 + i}.{j}", f"encoder/layer_{i}_{j}"
                _conv_norm(sd, variables, f"{t}.conv.0", f"{t}.conv.1", f"{d}/conv_0")
                _conv_norm(sd, variables, f"{t}.conv.3", f"{t}.conv.4", f"{d}/conv_1")
                if block.downsample is not None:
                    _conv_norm(sd, variables, f"{t}.downsample.0", f"{t}.downsample.1", f"{d}/downsample/proj")
    elif isinstance(encoder, ReXNetFeatures):
        _conv_norm(sd, variables, "encoder.0", "encoder.1", "encoder/stem")
        for i, block in enumerate(list(encoder)[3:]):
            _rexblock(sd, variables, f"encoder.{3 + i}.conv", f"encoder/block_{i}", block)
    else:
        raise NotImplementedError(f"no conversion for a DynamicUNet over {type(encoder).__name__}")


def segmentation_state_dict(
    variables: Mapping, model: Union[UNet, _NestedUNet, UNet3p, DynamicUNet]
) -> Dict[str, torch.Tensor]:
    """State dict of a segmentation model (:class:`UNet`, ``UNetp``, ``UNetpp``,
    :class:`UNet3p`, :class:`DynamicUNet` over any of its four encoders) from the JAX
    one's variables. The DynamicUNet's keys are original Holocron's, those that
    ``_convert_dynamic_unet`` reads (``holocron_tpu/models/_torch_convert.py:452-490``:
    ``bridge.0`` the bridge's norm, ``decoder.{k}.upsample``, ``.bn`` and ``.block``,
    ``upsample``, ``classifier``), with the encoder's in its classifier's order; the
    other families' mapping is the port's own (each JAX ``ConvSequence`` to the conv and
    norm of the port's block in the same place)."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    if isinstance(model, DynamicUNet):
        _encoder(sd, variables, model.encoder)
        _norm_at(sd, "bridge.0", variables, "bridge_bn")
        _layers_at(sd, variables, "bridge", model.bridge, ["bridge_0", "bridge_1"])
        for k, block in enumerate(model.decoder):
            d = f"decoder_{k}"
            _layers_at(sd, variables, f"decoder.{k}.upsample", block.upsample, [f"{d}/up_conv"])
            _norm_at(sd, f"decoder.{k}.bn", variables, f"{d}/bn")
            _layers_at(sd, variables, f"decoder.{k}.block", block.block, [f"{d}/conv_0", f"{d}/conv_1"])
        if model.upsample is not None:
            _layers_at(sd, variables, "upsample", model.upsample, ["final_up_conv"])
    else:
        for i, down in enumerate(model.encoder):
            _layers_at(sd, variables, f"encoder.{i}", down, [f"encoder_{i}/conv_0", f"encoder_{i}/conv_1"])
        if isinstance(model, UNet3p):
            for row, block in enumerate(model.decoder):
                d = f"decoder_{row}"
                for k, seq in enumerate(block.downsamples):
                    _layers_at(sd, variables, f"decoder.{row}.downsamples.{k}", seq, [f"{d}/down_{k}"])
                if isinstance(block.skip, nn.Conv2d):
                    _conv_at(sd, f"decoder.{row}.skip", params[d]["skip"])
                for k, seq in enumerate(block.upsamples):
                    _layers_at(sd, variables, f"decoder.{row}.upsamples.{k}", seq, [f"{d}/up_{k}"])
                _layers_at(sd, variables, f"decoder.{row}.block", block.block, [f"{d}/block"])
        else:
            _layers_at(sd, variables, "bridge", model.bridge, ["bridge_0", "bridge_1"])
            if isinstance(model, UNet):
                for k, up in enumerate(model.decoder):
                    _up_path(sd, variables, f"decoder.{k}", f"decoder_{k}", up)
            else:
                for i, level in enumerate(model.decoder):
                    for j, up in enumerate(level):
                        _up_path(sd, variables, f"decoder.{i}.{j}", f"decoder_{i}_{j}", up)
    _conv_at(sd, "classifier", params["classifier"])
    return sd
