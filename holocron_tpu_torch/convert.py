"""JAX-package variables -> the port's ``state_dict``.

The inverse of ``holocron_tpu/models/_torch_convert.py``. Variables are nested dicts
of arrays (numpy, or anything ``np.asarray`` takes), ``{"params": ..., "batch_stats": ...}``.

- conv kernels: HWIO ``(kh, kw, I, O)`` -> OIHW ``(O, I, kh, kw)``
- dense kernels: ``(in, out)`` -> ``(out, in)``
- batch norm: ``scale/bias`` + ``mean/var`` -> ``weight/bias/running_mean/running_var``
  (and ``num_batches_tracked = 0``, which torch keeps and the JAX package does not)
- frozen batch norm: ``scale/bias/mean/var``, all statistics, -> the same four buffers
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from .models.classification.res2net import ScaleConv2d
from .models.classification.resnet import ResNet
from .models.classification.rexnet import ReXNet, SEBlock
from .models.classification.sknet import SKConv2d
from .models.classification.tridentnet import TridentConv2d
from .nn.modules.conv import PyConv2d

__all__ = [
    "add2d_state_dict",
    "involution_state_dict",
    "nn_state_dict",
    "repvgg_state_dict",
    "resnet_state_dict",
    "rexnet_state_dict",
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


def rexnet_state_dict(variables: Mapping, model: ReXNet) -> Dict[str, torch.Tensor]:
    """State dict of a :class:`~holocron_tpu_torch.models.ReXNet` from the JAX
    ``ReXNet``'s variables; the inverse of ``_convert_rexnet``
    (``holocron_tpu/models/_torch_convert.py:197-242``).

    ``features.0``/``.1`` are the stem's conv and norm; each block ``features.{3 + i}``
    holds, in ``conv``, the JAX block ``block_{i}``'s ``expand`` (conv, norm, act; when
    it expands), ``dw`` (conv, norm), ``se`` (``conv.0``/``.1`` fc1's conv and norm,
    ``conv.3`` fc2's conv), the activation and ``project`` (conv, norm); then the
    penultimate conv and norm and ``head.1``.
    """
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}

    def conv_norm(conv_key: str, norm_key: str, path: str) -> None:
        _conv_at(sd, conv_key, _node(params, f"{path}/conv"))
        _norm_at(sd, norm_key, variables, f"{path}/bn")

    conv_norm("features.0", "features.1", "stem")
    blocks = model.features[3:-3]
    for i, block in enumerate(blocks):
        t, d = f"features.{3 + i}.conv", f"block_{i}"
        names = ["expand", "dw"] if block.t != 1 else ["dw"]
        off = 0
        for name in names:
            conv_norm(f"{t}.{off}", f"{t}.{off + 1}", f"{d}/{name}")
            off += 3 if name == "expand" else 2
        if isinstance(block.conv[off], SEBlock):
            conv_norm(f"{t}.{off}.conv.0", f"{t}.{off}.conv.1", f"{d}/se/fc1")
            _conv_at(sd, f"{t}.{off}.conv.3", _node(params, f"{d}/se/fc2/conv"))
            off += 1
        conv_norm(f"{t}.{off + 1}", f"{t}.{off + 2}", f"{d}/project")
    pen = 3 + len(blocks)
    conv_norm(f"features.{pen}", f"features.{pen + 1}", "penultimate")
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
