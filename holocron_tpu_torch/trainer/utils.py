"""Parameter freezing and param groups (``holocron_tpu/trainer/utils.py``).

As in the JAX package, freezing is a trainability mask (``{parameter name: bool}``)
that the trainer applies in its update, not ``requires_grad`` mutation: gradients are
still computed for every parameter, and a frozen one gets a zero update.
"""

from typing import Dict, List, Optional, Tuple

from torch import nn

__all__ = ["freeze_bn", "freeze_model", "split_normalization_params"]

_NORM_TYPES = (nn.modules.batchnorm._NormBase, nn.LayerNorm, nn.GroupNorm, nn.LocalResponseNorm)


def freeze_model(model: nn.Module, last_frozen_layer: Optional[str] = None) -> Dict[str, bool]:
    """Trainability mask that freezes every parameter up to, and including, the ones
    whose name starts with ``last_frozen_layer`` (``utils.py:86-120``). Parameters are
    taken in registration order, which is forward order for the port's models (the
    original Holocron's assumption)."""
    names = [name for name, _ in model.named_parameters()]
    if last_frozen_layer is None:
        return {name: True for name in names}
    if not any(name.startswith(last_frozen_layer) for name in names):
        raise ValueError(f"Unable to locate child module {last_frozen_layer}")
    mask = {}
    layer_reached = done = False
    for name in names:
        matches = name.startswith(last_frozen_layer)
        mask[name] = done or (layer_reached and not matches)
        if matches:
            layer_reached = True
        elif layer_reached:
            done = True
    return mask


def freeze_bn(model: nn.Module, trainable: Dict[str, bool]) -> List[nn.Module]:
    """The normalization modules whose running statistics must stay as they are: those
    with statistics and parameters, none of them trainable (``utils.py:130-156``)."""
    frozen = []
    for name, module in model.named_modules():
        if not isinstance(module, nn.modules.batchnorm._NormBase) or not module.track_running_stats:
            continue
        params = [f"{name}.{p}" if name else p for p, _ in module.named_parameters(recurse=False)]
        if params and not any(trainable[p] for p in params):
            frozen.append(module)
    return frozen


def split_normalization_params(model: nn.Module) -> Tuple[List[str], List[str]]:
    """``(norm, other)``: the names of the parameters of normalization layers and of
    all others, the two groups of per-group weight decay (``utils.py:175-181``)."""
    norm = set()
    for name, module in model.named_modules():
        if isinstance(module, _NORM_TYPES):
            norm.update(f"{name}.{p}" if name else p for p, _ in module.named_parameters(recurse=False))
    names = [name for name, _ in model.named_parameters()]
    return [n for n in names if n in norm], [n for n in names if n not in norm]
