"""Model registry: every configuration of the JAX package's
``models/registry.py`` (vanilla UNet, the GRFB-UNet baseline, EGM-UNet and
its A/B/C ablation grid), BN folded."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from egm_unet_torch.models.egm_unet import EGMUNet
from egm_unet_torch.models.unet import UNet

# name -> EGMUNet kwargs (block, use_rga, use_mca)
MODEL_CONFIGS = {
    "egm_unet": dict(block="edge", use_rga=True, use_mca=True),  # A+B+C
    "egm_unet_a": dict(block="edge", use_rga=False, use_mca=False),
    "egm_unet_b": dict(block=None, use_rga=True, use_mca=False),
    "egm_unet_c": dict(block=None, use_rga=False, use_mca=True),
    "egm_unet_ab": dict(block="edge", use_rga=True, use_mca=False),
    "egm_unet_ac": dict(block="edge", use_rga=False, use_mca=True),
    "egm_unet_bc": dict(block=None, use_rga=True, use_mca=True),
    "grfb_unet": dict(block="grfb", use_rga=False, use_mca=False),
}


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator`` (on the CPU), module by module
    in registration order, so one seed gives one model."""
    for mod in model.modules():
        reset = getattr(mod, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model


def create_model(name: str = "egm_unet", num_classes: int = 2, base_c: int = 32,
                 generator: Optional[torch.Generator] = None,
                 bilinear: bool = True, conv_impl: str = "gemm",
                 upsample_impl: str = "matmul") -> nn.Module:
    """The BN-folded inference graph of ``name`` (the only graph ported; fold
    BN statistics with ``models.fold_bn.fold_bn_variables``).  Load weights
    with ``utils.from_flax.load_flax_variables``, or draw them from
    ``generator``.  ``bilinear=False`` (``"unet"`` only) selects the
    transposed-conv decoder.  ``conv_impl`` (``"gemm"`` | ``"pair"``) and
    ``upsample_impl`` (``"matmul"`` | ``"fused"``) pick the kernels of every
    ``DoubleConv`` and ``Up`` (``nn.layers.DoubleConv``); parameters and
    state dicts are the same on every route."""
    impls = dict(conv_impl=conv_impl, upsample_impl=upsample_impl)
    if name == "unet":
        model = UNet(num_classes=num_classes, bilinear=bilinear, base_c=base_c,
                     **impls)
    elif name in MODEL_CONFIGS:
        if not bilinear:
            raise ValueError("the EGM-UNet family has the bilinear decoder only")
        model = EGMUNet(num_classes=num_classes, base_c=base_c, **impls,
                        **MODEL_CONFIGS[name])
    else:
        raise ValueError(f"unknown model {name!r}; choose from "
                         f"{['unet', *MODEL_CONFIGS]}")
    if generator is not None:
        init_weights(model, generator)
    return model
