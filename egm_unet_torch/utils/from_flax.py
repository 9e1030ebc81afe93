"""Weight bridge between a flax variables tree of numpy arrays and the port's
``state_dict``, both ways.

The port's modules carry the flax names, so the mapping is by path: the
parameter ``a.b.kernel`` of a port ``Conv`` module is the flax leaf
``a/b/Conv_0/kernel`` (the flax wrapper holds one core ``nn.Conv``; a module
names that inner child in its ``flax_child`` attribute, as ``BatchNorm``
names ``BatchNorm_0`` and ``LayerNormF32`` names ``LayerNorm_0``), every
other parameter ``a.b.name`` is ``a/b/name``.  Parameters come from the
``params`` collection, buffers (the BatchNorm ``mean`` and ``var``) from
``batch_stats``; the RN CLIP tower's eval BatchNorms keep ``mean`` and
``var`` as parameters, as the JAX package keeps them in ``params``.  Conv kernels stay HWIO, ``Dense`` kernels [in, out],
embeddings and bare parameters (``class_embedding``, ``proj``,
``trans_conv_kernel``, ...) and the MCA gate kernels ``(k,)`` as they are.

A tree with ``batch_stats`` loads into the training graph (``fold_bn=False``)
as it is, and into a folded graph after ``models/fold_bn.py`` folds it.  A
leaf that is missing, consumed twice, of the wrong shape or left unconsumed
raises.

The int8 scales of the JAX package's ``quant_scales`` collection are not
part of a ``state_dict``: ``quant_scales_from_flax`` flattens that
collection into the port's mapping (flax path -> float, ``ops/quant.py``)
and ``flax_quant_scales`` nests the mapping back.
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
    """The flax path of the port's state_dict entry ``key`` within its
    collection."""
    mod_path, _, name = key.rpartition(".")
    parts = mod_path.split(".") if mod_path else []
    child = getattr(model.get_submodule(mod_path), "flax_child", None)
    if child:
        parts.append(child)
    return "/".join(parts + [name])


def _collections(model: nn.Module) -> Dict[str, str]:
    """state_dict key -> the flax collection it belongs to."""
    buffers = {k for k, _ in model.named_buffers()}
    return {k: "batch_stats" if k in buffers else "params"
            for k in model.state_dict()}


def state_dict_from_flax(model: nn.Module,
                         variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    colls = _collections(model)
    if "batch_stats" not in colls.values() and variables.get("batch_stats"):
        variables = fold_bn_variables(variables)
    leaves = {(c, p): v for c in ("params", "batch_stats")
              for p, v in _flatten(variables.get(c, {})).items()}
    consumed = set()
    state = {}
    for key, ref in model.state_dict().items():
        leaf = (colls[key], flax_path(model, key))
        if leaf in consumed:
            raise ValueError(f"flax leaf {leaf!r} consumed twice (again by {key!r})")
        if leaf not in leaves:
            raise KeyError(f"flax tree has no leaf {leaf!r} for {key!r}")
        arr = np.asarray(leaves[leaf], dtype=np.float32)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{leaf!r}: shape {arr.shape} != {tuple(ref.shape)} "
                             f"of {key!r}")
        state[key] = torch.from_numpy(arr.copy())
        consumed.add(leaf)
    unused = sorted(set(leaves) - consumed)
    if unused:
        raise ValueError(f"{len(unused)} flax leaves not consumed, e.g. "
                         f"{unused[:5]}")
    return state


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    model.load_state_dict(state_dict_from_flax(model, variables))
    return model


def flax_from_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor] = None
                         ) -> Dict[str, Dict[str, Any]]:
    """The inverse bridge: ``state`` (default ``model.state_dict()``) as a
    nested flax tree of float32 numpy arrays (copies, not views), ``{"params": ...,
    "batch_stats": ...}`` (``batch_stats`` empty for a folded graph).  Fold
    the tree of a training graph with ``models.fold_bn.fold_bn_variables``
    and load it into the folded graph with ``load_flax_variables``."""
    state = model.state_dict() if state is None else state
    colls = _collections(model)
    tree: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        node = tree[colls[key]]
        *parents, name = flax_path(model, key).split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = value.detach().float().cpu().numpy().copy()
    return tree


def quant_scales_from_flax(tree: Mapping[str, Any]) -> Dict[str, float]:
    """A flax ``quant_scales`` collection as the port's flat scale mapping:
    ``{"down1/conv1/Conv_0/act_scale": 0.0123, ...}``, float32 values."""
    return {path: float(np.float32(np.asarray(v))) for path, v in _flatten(tree).items()}


def flax_quant_scales(scales: Mapping[str, float]) -> Dict[str, Any]:
    """The inverse: the port's scale mapping as a nested flax collection of
    float32 numpy scalars."""
    tree: Dict[str, Any] = {}
    for path, value in scales.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = np.asarray(value, np.float32)
    return tree
