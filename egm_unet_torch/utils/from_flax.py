"""Weight bridge: a flax variables tree of numpy arrays -> the port's
``state_dict``.

The port's modules carry the flax names, so the mapping is by path: the
parameter ``a.b.kernel`` of a port ``Conv`` module is the flax leaf
``a/b/Conv_0/kernel`` (the flax wrapper holds one core ``nn.Conv``; a module
names that inner child in its ``flax_child`` attribute, as ``LayerNormF32``
names ``LayerNorm_0``), every other parameter ``a.b.name`` is ``a/b/name``.
Conv kernels stay HWIO, ``Dense`` kernels [in, out], embeddings and bare
parameters (``class_embedding``, ``proj``, ``trans_conv_kernel``, ...) and
the MCA gate kernels ``(k,)`` as they are.  An unfolded tree (one with
``batch_stats``) is folded first.  A leaf that is missing, consumed twice,
of the wrong shape or left unconsumed raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from egm_unet_torch.models.fold_bn import fold_bn_variables


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = v
    return flat


def flax_path(model: nn.Module, key: str) -> str:
    """The flax params path of the port's state_dict entry ``key``."""
    mod_path, _, name = key.rpartition(".")
    parts = mod_path.split(".") if mod_path else []
    child = getattr(model.get_submodule(mod_path), "flax_child", None)
    if child:
        parts.append(child)
    return "/".join(parts + [name])


def state_dict_from_flax(model: nn.Module,
                         variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if variables.get("batch_stats"):
        variables = fold_bn_variables(variables)
    leaves = _flatten(variables["params"])
    consumed = set()
    state = {}
    for key, ref in model.state_dict().items():
        path = flax_path(model, key)
        if path in consumed:
            raise ValueError(f"flax leaf {path!r} consumed twice (again by {key!r})")
        if path not in leaves:
            raise KeyError(f"flax tree has no leaf {path!r} for {key!r}")
        arr = np.asarray(leaves[path], dtype=np.float32)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path!r}: shape {arr.shape} != {tuple(ref.shape)} "
                             f"of {key!r}")
        state[key] = torch.from_numpy(arr.copy())
        consumed.add(path)
    unused = sorted(set(leaves) - consumed)
    if unused:
        raise ValueError(f"{len(unused)} flax leaves not consumed, e.g. "
                         f"{unused[:5]}")
    return state


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    model.load_state_dict(state_dict_from_flax(model, variables))
    return model
