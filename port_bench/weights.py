"""Seeded weights for a state dict's names and shapes, made on the device in
one draw: one ``randn`` of every leaf's elements from a generator on the
device, sliced, scaled and shifted per leaf by its role.

The roles keep a random network's activations at scale through depth, so
that its logits are far from ties where rounding does not reach: He-normal
conv kernels, 1/fan_in linear kernels, BatchNorm statistics and scales near
their neutral values but not at them (the folding must matter).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

Shapes = Mapping[str, Tuple[int, ...]]


def leaf_rule(name: str, shape: tuple) -> Tuple[float, float, str]:
    """``(scale, shift, transform)`` of a standard normal draw for the leaf
    ``name`` of ``shape``: value = transform(draw) * scale + shift."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "var":  # BatchNorm running variance: positive, about 1
        return 0.25, 0.0, "exp"
    if leaf == "mean":  # BatchNorm running mean
        return 0.1, 0.0, ""
    if leaf == "scale":  # BatchNorm / LayerNorm scale, the RGA's scalar
        return 0.1, 1.0, ""
    if leaf in ("bias", "down_bias", "trans_conv_bias") or leaf.startswith("conv") and leaf.endswith("_bias"):
        return 0.05, 0.0, ""
    if leaf == "weight":  # the MCA gates' blend weights
        return 1.0, 0.0, ""
    if leaf == "conv":  # the MCA gates' 1-D kernels
        return 0.5, 0.0, ""
    if leaf == "logit_scale":
        return 0.0, math.log(1 / 0.07), ""
    if leaf in ("embedding", "positional_embedding_res") or (
            leaf == "positional_embedding" and "visual" not in name):
        return 0.02, 0.0, ""
    if leaf in ("class_embedding", "positional_embedding", "proj", "text_projection"):
        return shape[0] ** -0.5, 0.0, ""
    if leaf in ("trans_conv_kernel", "up_kernel"):  # stride == kernel: fan_in is C_in
        return shape[0] ** -0.5, 0.0, ""
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else 1
    gain = 2.0 if len(shape) == 4 else 1.0  # convs feed ReLUs; linears LayerNorms
    return math.sqrt(gain / fan_in), 0.0, ""


def make_weights(shapes: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for ``shapes`` (name -> shape), drawn from ``seed`` on
    ``device``: the same seed gives the same weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    total = sum(math.prod(s) for s in shapes.values())
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, shift, tf = leaf_rule(name, tuple(shape))
        v = draw[off:off + n].view(shape)
        off += n
        if tf == "exp":
            v = torch.exp(v * scale)
        else:
            v = v * scale + shift
        out[name] = v
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
