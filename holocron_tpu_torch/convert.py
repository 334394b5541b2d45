"""JAX-package variables -> the port's ``state_dict``.

The inverse of ``holocron_tpu/models/_torch_convert.py``. Variables are nested dicts
of arrays (numpy, or anything ``np.asarray`` takes), ``{"params": ..., "batch_stats": ...}``.

- conv kernels: HWIO ``(kh, kw, I, O)`` -> OIHW ``(O, I, kh, kw)``
- dense kernels: ``(in, out)`` -> ``(out, in)``
- batch norm: ``scale/bias`` + ``mean/var`` -> ``weight/bias/running_mean/running_var``
  (and ``num_batches_tracked = 0``, which torch keeps and the JAX package does not)
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["add2d_state_dict", "involution_state_dict", "repvgg_state_dict"]


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
