"""Inference-time BatchNorm folding on a flax variables tree of numpy arrays
(port of ``egm_unet_tpu/models/fold_bn.py``):

    y = ((x*W + b) - mean) * gamma/sqrt(var+eps) + beta
      =  x * (W * f) + ((b - mean) * f + beta),   f = gamma/sqrt(var+eps)

Within one parent module the flax names pair ``Conv_i`` with
``BatchNorm_i``; each is a wrapper holding one core module.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _fold_pair(conv_params, bn_params, bn_stats, eps: float):
    factor = (np.asarray(bn_params["scale"], np.float32)
              / np.sqrt(np.asarray(bn_stats["var"], np.float32) + np.float32(eps)))
    kernel = np.asarray(conv_params["kernel"], np.float32) * factor  # HWIO
    bias = np.asarray(conv_params.get("bias", 0.0), np.float32)
    bias = ((bias - np.asarray(bn_stats["mean"], np.float32)) * factor
            + np.asarray(bn_params["bias"], np.float32))
    return {"kernel": kernel, "bias": bias}


def fold_bn_variables(variables: Mapping[str, Any], eps: float = 1e-5):
    """{'params', 'batch_stats'} of a BN graph -> {'params'} of the folded
    graph."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def fold(p, s):
        if not isinstance(p, Mapping):
            return p
        out = {}
        bn_keys = [k for k in p if k.startswith("BatchNorm_")]
        for k, node in p.items():
            if k not in bn_keys:
                out[k] = fold(node, s.get(k, {}) if isinstance(s, Mapping) else {})
        for k in bn_keys:
            conv_key = "Conv_" + k.split("_", 1)[1]
            if conv_key not in p:
                raise ValueError(f"BatchNorm {k!r} has no sibling {conv_key!r} "
                                 "to fold into")
            out[conv_key] = {"Conv_0": _fold_pair(
                dict(out[conv_key]["Conv_0"]), p[k]["BatchNorm_0"],
                s[k]["BatchNorm_0"], eps)}
        return out

    return {"params": fold(params, stats)}
