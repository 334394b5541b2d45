"""Model helpers (``holocron_tpu/models/utils.py``): the conv block factory, conv/BN
fusion, the checkpoint metadata factory and the loading of released weights.

Released checkpoints are the reference's ``.pth`` files, read with
``torch.load(weights_only=True)`` (which refuses arbitrary globals, as the JAX
package's own reader does) and loaded as they are: the port's modules keep the
reference's ``state_dict`` key layout. They are cached where the JAX package caches
them, so one downloaded file serves both packages.
"""

import hashlib
import json
import logging
import os
import tempfile
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..nn.modules.downsample import BlurPool2d
from .checkpoints import (Checkpoint, Dataset, Evaluation, LoadingMeta, Metric, PreProcessing, TrainingRecipe,
                          _handle_legacy_pretrained)
from .presets import IMAGENET, IMAGENETTE

__all__ = ["ConvSequence", "conv_sequence", "fold_s2d_kernel", "fuse_conv_bn", "load_pretrained_params",
           "model_from_hf_hub", "space_to_depth_padded"]

logger = logging.getLogger(__name__)


def conv_sequence(
    in_channels: int,
    out_channels: int,
    act_layer: Optional[nn.Module] = None,
    norm_layer: Optional[Callable[[int], nn.Module]] = None,
    drop_layer: Optional[Callable[[], nn.Module]] = None,
    conv_layer: Optional[Callable[..., nn.Module]] = None,
    bn_channels: Optional[int] = None,
    attention_layer: Optional[Callable[[int], nn.Module]] = None,
    blurpool: bool = False,
    **kwargs: Any,
) -> List[nn.Module]:
    """The conv block factory (``ConvSequence``, ``utils.py:44-156``): conv -> norm -> act ->
    blurpool -> attention -> drop, as a list in original Holocron's order, so that a
    ``Sequential`` of it holds the conv at offset 0, the norm at 1 and the activation
    at 2, the offsets the checkpoint converters read.

    Args:
        in_channels, out_channels: the conv's channels
        act_layer: an activation module (e.g. ``nn.ReLU(inplace=True)``), or None
        norm_layer: ``(channels) -> module``, or None
        drop_layer: ``() -> module``, or None
        conv_layer: ``(in_channels, out_channels, **kwargs) -> module`` in place of
            ``nn.Conv2d``
        bn_channels: the norm's (and attention's) channels, when they differ from
            ``out_channels``
        attention_layer: ``(channels) -> module``, or None
        blurpool: move a stride above 1 from the conv into a :class:`BlurPool2d`
        kwargs: the conv's arguments (``kernel_size``, ``stride``, ``padding``,
            ``dilation``, ``groups``, ``bias``); ``bias`` defaults to "no norm"
    """
    kwargs.setdefault("bias", norm_layer is None)
    conv_stride = kwargs.get("stride", 1)
    if blurpool and conv_stride > 1:
        kwargs["stride"] = 1
    channels = bn_channels or out_channels
    layers = [(conv_layer or nn.Conv2d)(in_channels, out_channels, **kwargs)]
    if norm_layer is not None:
        layers.append(norm_layer(channels))
    if act_layer is not None:
        layers.append(act_layer)
    if blurpool and conv_stride > 1:
        layers.append(BlurPool2d(channels, stride=conv_stride))
    if attention_layer is not None:
        layers.append(attention_layer(channels))
    if drop_layer is not None:
        layers.append(drop_layer())
    return layers


class ConvSequence(nn.Sequential):
    """A ``Sequential`` of :func:`conv_sequence`'s layers."""

    def __init__(self, in_channels: int, out_channels: int, **kwargs: Any) -> None:
        super().__init__(*conv_sequence(in_channels, out_channels, **kwargs))


def fuse_conv_bn(
    weight: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    conv_bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algebraic conv+BN fusion, the core of RepVGG reparametrization
    (``holocron_tpu/models/utils.py:159-185``).

    Args:
        weight: OIHW conv weight ``(out_c, in_c, kh, kw)``
        bn_scale, bn_bias, bn_mean, bn_var: BN parameters and statistics, each ``(out_c,)``

    Returns:
        ``(fused_weight, fused_bias)``, in the same operation order as the JAX package.
    """
    if bn_bias.shape[0] != weight.shape[0]:
        raise AssertionError("expected same number of output channels for both `conv` and `bn`")
    scale_factor = bn_scale / torch.sqrt(bn_var + eps)
    fused_bias = bn_bias - scale_factor * bn_mean
    if conv_bias is not None:
        logger.warning("convolution layers placed before batch normalization should not have a bias.")
        fused_bias = fused_bias + scale_factor * conv_bias
    fused_weight = weight * scale_factor.reshape(-1, *([1] * (weight.ndim - 1)))
    return fused_weight, fused_bias


def fold_s2d_kernel(k3: torch.Tensor) -> torch.Tensor:
    """Folds an OIHW ``(O, C, 3, 3)`` stride-2 pad-1 kernel into the equivalent
    ``(O, 4C, 2, 2)`` stride-1 kernel over the space-to-depth(2) input
    (``holocron_tpu/models/utils.py:188-214``, there in HWIO).

    Output pixel ``(i, j)`` reads ``x[2i + d - 1]`` for ``d`` in ``{0, 1, 2}``; writing
    ``2i + d - 1 = 2(i - 1 + u) + a`` gives ``(u, a) = (0, 1)`` for ``d = 0`` and ``(1,
    d - 1)`` otherwise: a 2x2 window over ``z[(a, b, c), p, q] = x[c, 2p + a, 2q + b]``
    (:func:`~holocron_tpu_torch.nn.functional.concat_downsample2d`'s channel order) with
    one zero row and column on top and left (:func:`space_to_depth_padded`). The unused
    ``(u = 0, a = 0)`` taps stay zero, so an integer kernel folds bit for bit."""
    o, c = k3.shape[:2]
    k2 = k3.new_zeros((o, 4 * c, 2, 2))
    for di in range(3):
        u, a = (0, 1) if di == 0 else (1, di - 1)
        for dj in range(3):
            v, b = (0, 1) if dj == 0 else (1, dj - 1)
            ch = (a * 2 + b) * c
            k2[:, ch : ch + c, u, v] = k3[:, :, di, dj]
    return k2


def space_to_depth_padded(x: torch.Tensor, s2d: bool = True, pitch: Optional[int] = None) -> torch.Tensor:
    """The input of a folded 2x2 stride-1 conv (:func:`fold_s2d_kernel`): NHWC ``x`` as
    ``(N, H/2 + 1, W/2 + 1, 4C)``, space-to-depth(2) in
    :func:`~holocron_tpu_torch.nn.functional.concat_downsample2d`'s channel order, with a
    zero row on top and a zero column on the left (``nn.Conv2d`` pads both sides alike),
    written in one copy. ``s2d=False`` takes ``x`` as already rearranged ``(N, H/2, W/2,
    4C)`` and only pads it. ``pitch``: the pixel pitch of the buffer, at least the
    channels (the result is then the view of its first channels, zeros beyond them)."""
    n, h, w, c = x.shape
    if s2d:
        h, w, c = h // 2, w // 2, 4 * c
    pitch = pitch or c
    buf = x.new_empty((n, h + 1, w + 1, pitch))
    buf[:, 0].zero_()
    buf[:, 1:, 0].zero_()
    if pitch != c:
        buf[:, 1:, 1:, c:].zero_()
    dst, src = buf[:, 1:, 1:, :c], x
    if s2d:
        # z[n, p, q, (a, b, ch)] = x[n, 2p + a, 2q + b, ch]
        dst, src = dst.unflatten(3, (2, 2, -1)), x.unflatten(1, (h, 2)).unflatten(3, (w, 2)).permute(0, 1, 3, 2, 4, 5)
    # the runs of channels move as 8-, 4- or 2-byte words where their lengths, strides and
    # offsets allow: a strided copy moves one element a thread (an int8 x_q a byte)
    for word in (torch.int64, torch.int32, torch.int16):
        k = word.itemsize // x.element_size()
        if k > 1 and src.shape[-1] % k == 0 and src.stride(-1) == dst.stride(-1) == 1 and all(
                v % k == 0 for t in (src, dst) for v in (*t.stride()[:-1], t.storage_offset())):
            dst, src = dst.view(word), src.view(word)
            break
    dst.copy_(src)
    return buf[..., :c]


def _download_checkpoint(url: str, sha256: Optional[str] = None, progress: bool = True) -> Path:
    """``url`` in the local checkpoint cache, downloaded there first if it is not yet
    (``utils.py:217-256``), its ``sha256`` checked when one is given (a mismatch deletes
    the file and raises).

    The cache is the JAX package's: ``$HOLOCRON_CACHE_DIR/checkpoints`` (default
    ``~/.cache/holocron_tpu/checkpoints``), each file named
    ``<sha256(url)[:16]>-<basename>``, keyed on the full URL, so that two releases that
    both ship a ``model.pth`` do not share an entry."""
    cache_dir = Path(os.environ.get("HOLOCRON_CACHE_DIR", Path.home() / ".cache/holocron_tpu")) / "checkpoints"
    cache_dir.mkdir(parents=True, exist_ok=True)
    url_key = hashlib.sha256(url.encode()).hexdigest()[:16]
    basename = Path(urllib.parse.urlparse(url).path).name or "checkpoint.pth"
    dest = cache_dir / f"{url_key}-{basename}"
    if not dest.exists():
        if progress:
            logger.info(f"Downloading {url} to {dest}")
        fd, tmp = tempfile.mkstemp(dir=cache_dir)
        try:
            with urllib.request.urlopen(url) as r, os.fdopen(fd, "wb") as f:
                while chunk := r.read(1 << 20):
                    f.write(chunk)
            os.replace(tmp, dest)
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise
    if sha256:
        digest = hashlib.sha256(dest.read_bytes()).hexdigest()
        if digest != sha256:
            dest.unlink()
            raise ValueError(f"checkpoint hash mismatch for {url}: {digest} != {sha256}")
    return dest


def _read_state_dict(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file's state dict on the CPU; ``weights_only`` refuses any global that
    is not a tensor or a plain container."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_state_dict(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Loads ``state_dict`` into the keys of ``model`` it holds. A key that names no
    parameter or buffer of the model raises, and so does a shape that differs; keys of
    the model the file does not hold keep their values (a backbone-only file)."""
    unexpected = model.load_state_dict(state_dict, strict=False).unexpected_keys
    if unexpected:
        raise KeyError(f"the checkpoint holds keys that name nothing in {type(model).__name__}: {unexpected[:8]}")


def load_pretrained_params(
    model: nn.Module,
    url: Optional[str] = None,
    progress: bool = True,
    key_replacement: Optional[Tuple[str, str]] = None,
    key_filter: Optional[str] = None,
    sha256: Optional[str] = None,
) -> None:
    """Loads a released checkpoint into ``model`` (``utils.py:259-304``) and sets
    ``model.pretrained_loaded``.

    The file is fetched into the cache (:func:`_download_checkpoint`; a ``file://`` URL
    serves a local file) and read with ``torch.load(weights_only=True)``. Where there is
    no URL, the download or the read fails, or the hash differs, this warns and leaves
    the model as it was, with ``pretrained_loaded`` False. A trainer checkpoint's
    ``"model"`` entry is unwrapped; then only the keys starting with ``key_filter`` are
    kept, and ``key_replacement`` (``(old, new)``) is applied to each. The keys load as
    :func:`_load_state_dict` says: a key that names nothing in the model raises."""
    model.pretrained_loaded = False
    if url is None:
        logger.warning("Invalid model URL, using default initialization.")
        return
    try:
        state_dict = _read_state_dict(_download_checkpoint(url, sha256=sha256, progress=progress))
    except Exception as e:  # no network, a refused pickle, a hash mismatch
        logger.warning(f"Could not download checkpoint from {url} ({e}), using default initialization.")
        return
    if isinstance(state_dict, dict) and "model" in state_dict and not any("." in k for k in state_dict):
        state_dict = state_dict["model"]  # a trainer checkpoint not stripped by clean_checkpoint
    if isinstance(key_filter, str):
        state_dict = {k: v for k, v in state_dict.items() if k.startswith(key_filter)}
    if isinstance(key_replacement, tuple):
        state_dict = {k.replace(*key_replacement): v for k, v in state_dict.items()}
    _load_state_dict(model, state_dict)
    model.pretrained_loaded = True


def model_from_hf_hub(repo_id: str, device: Union[str, torch.device] = "cuda", **kwargs: Any) -> nn.Module:
    """A classifier and its weights from the HuggingFace hub (``utils.py:307-329``):
    ``config.json`` names the architecture and the classes, ``pytorch_model.bin`` holds
    the state dict. ``kwargs`` go to ``hf_hub_download``; the model is built on
    ``device``, the card unless the caller asks for the CPU."""
    from huggingface_hub import hf_hub_download

    from . import classification

    with Path(hf_hub_download(repo_id, filename="config.json", **kwargs)).open("rb") as f:
        cfg = json.load(f)
    model = classification.__dict__[cfg["arch"]](num_classes=len(cfg["classes"]), pretrained=False, device=device)
    if model.default_cfg is None:
        model.default_cfg = _checkpoint_from_hub_config(cfg)
    _load_state_dict(model, _read_state_dict(hf_hub_download(repo_id, filename="pytorch_model.bin", **kwargs)))
    return model


def _configure_model(model: nn.Module, checkpoint: Optional[Checkpoint], progress: bool = True,
                     default_cfg: Optional[Any] = None) -> nn.Module:
    """Sets ``default_cfg`` (``checkpoint``, else the family's legacy dict
    ``default_cfg``) and ``pretrained_loaded``, and loads ``checkpoint``'s weights
    (``utils.py:332-344``; its sha256 is checked when it is one)."""
    model.default_cfg = checkpoint if checkpoint is not None else default_cfg
    model.pretrained_loaded = False
    if isinstance(checkpoint, Checkpoint):
        sha = checkpoint.meta.sha256
        load_pretrained_params(model, checkpoint.meta.url, progress=progress,
                               sha256=sha if isinstance(sha, str) and len(sha) == 64 else None)
    return model


def _configure_legacy(model: nn.Module, cfg: Dict[str, Any], pretrained: bool, checkpoint: Optional[Checkpoint],
                      progress: bool = True) -> nn.Module:
    """The factories whose default weights sit in a legacy ``default_cfgs`` dict (the
    JAX package's ``model.default_cfg = default_cfgs[arch]`` then
    ``load_pretrained_params(model, default_cfgs[arch]["url"])``): an explicit
    ``checkpoint`` loads as :func:`_configure_model` loads it; ``pretrained`` loads
    ``cfg["url"]`` (a None URL warns)."""
    _configure_model(model, checkpoint, progress, default_cfg=cfg)
    if pretrained and checkpoint is None:
        load_pretrained_params(model, cfg.get("url"), progress)
    return model


def _pretrained(model: nn.Module, pretrained: bool, checkpoint: Optional[Checkpoint], progress: bool,
                default: Union[Checkpoint, Dict[str, Any], None] = None) -> nn.Module:
    """What every factory does with ``pretrained``, ``checkpoint`` and ``progress``:
    ``default`` is the family's default :class:`Checkpoint` (``pretrained=True`` maps to
    it, :func:`_handle_legacy_pretrained`), a legacy ``default_cfgs`` dict
    (:func:`_configure_legacy`), or None (``pretrained=True`` warns)."""
    if isinstance(default, dict):
        return _configure_legacy(model, default, pretrained, checkpoint, progress)
    return _configure_model(model, _handle_legacy_pretrained(pretrained, checkpoint, default), progress)


def _checkpoint_from_hub_config(hub_config: dict) -> Checkpoint:
    return Checkpoint(
        evaluation=Evaluation(dataset=Dataset.IMAGENETTE, results={}),
        meta=LoadingMeta(url="N/A", sha256="N/A", size=0, num_params=0, arch=hub_config["arch"],
                         categories=hub_config["classes"]),
        pre_processing=PreProcessing(input_shape=tuple(hub_config["input_shape"]), mean=hub_config["mean"],
                                     std=hub_config["std"]),
        recipe=TrainingRecipe(commit=None, script="references/classification/train.py", args=None),
    )


def _checkpoint(
    arch: str,
    url: str,
    acc1: float,
    acc5: float,
    sha256: str,
    size: int,
    num_params: int,
    commit: Optional[str] = None,
    train_args: Optional[str] = None,
    dataset: Dataset = Dataset.IMAGENETTE,
) -> Checkpoint:
    """A checkpoint entry (``utils.py:365-387``); ``input_shape`` is channel-first."""
    preset = IMAGENETTE if dataset == Dataset.IMAGENETTE else IMAGENET
    return Checkpoint(
        evaluation=Evaluation(dataset=dataset, results={Metric.TOP1_ACC: acc1, Metric.TOP5_ACC: acc5}),
        meta=LoadingMeta(
            url=url, sha256=sha256, size=size, num_params=num_params, arch=arch, categories=preset.classes
        ),
        pre_processing=PreProcessing(input_shape=(3, 224, 224), mean=preset.mean, std=preset.std),
        recipe=TrainingRecipe(commit=commit, script="references/classification/train.py", args=train_args),
    )
