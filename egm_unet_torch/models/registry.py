"""Model registry: every configuration of the JAX package's
``models/registry.py`` (vanilla UNet, the GRFB-UNet baseline, EGM-UNet and
its A/B/C ablation grid), BN folded for inference or with BatchNorm for
training."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from egm_unet_torch.models.egm_unet import EGMUNet
from egm_unet_torch.models.unet import UNet, Up
from egm_unet_torch.nn.attention import MCAGate
from egm_unet_torch.nn.grfb import FusionConv
from egm_unet_torch.nn.layers import Conv, torch_bias_init, torch_kernel_init, uniform_

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


def init_reference(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The initialisation a training run of the reference starts from, as
    the JAX package's flax initialisers draw it: every conv kernel and bias
    uniform in +-1/sqrt(fan_in) (PyTorch's default for ``Conv2d``), the
    transposed conv's kernel in +-1/sqrt(4 in1), BatchNorm scale 1, bias 0,
    mean 0, var 1, the MCA blend weights uniform in [0, 1) and gate kernels
    in +-1/sqrt(k), the RGA scale 1.  Drawn from ``generator`` module by
    module in registration order."""
    for mod in model.modules():
        if isinstance(mod, Conv):
            torch_kernel_init(mod.kernel, generator)
            if mod.bias is not None:
                torch_bias_init(mod.bias, generator, mod.kernel[..., 0].numel())
        elif isinstance(mod, FusionConv):
            for name, p in mod.named_parameters(recurse=False):
                fan = (p.shape[0] * p.shape[1] * p.shape[2] if p.ndim == 4
                       else getattr(mod, name.replace("bias", "kernel"))[..., 0].numel())
                uniform_(p, 1.0 / math.sqrt(fan), generator)
        elif isinstance(mod, MCAGate):
            with torch.no_grad():
                mod.weight.copy_(torch.rand(2, generator=generator))
            uniform_(mod.conv, 1.0 / math.sqrt(mod.conv.numel()), generator)
        elif isinstance(mod, Up):
            if not mod.bilinear:
                uniform_(mod.up_kernel, 0.5 / math.sqrt(mod.up_kernel.shape[0]),
                         generator)
        elif hasattr(mod, "reset_parameters"):  # BatchNorm, RGA's scale
            mod.reset_parameters(generator)
    return model


def create_model(name: str = "egm_unet", num_classes: int = 2, base_c: int = 32,
                 generator: Optional[torch.Generator] = None,
                 bilinear: bool = True, conv_impl: str = "gemm",
                 upsample_impl: str = "matmul", fold_bn: bool = True,
                 remat=False) -> nn.Module:
    """The graph of ``name``.  ``fold_bn=True`` (default): the BN-folded
    inference graph on the hand-written kernels; fold BN statistics with
    ``models.fold_bn.fold_bn_variables``.  ``fold_bn=False``: the training
    graph, conv -> BatchNorm -> ReLU in plain PyTorch, whose ``train()`` /
    ``eval()`` modes are flax's ``train=True`` / ``False``.

    Load weights with ``utils.from_flax.load_flax_variables``, or draw them
    from ``generator``: ``init_weights`` for the folded graph,
    ``init_reference`` (where a training run starts) for the training graph.
    ``bilinear=False`` (``"unet"`` only) selects the transposed-conv decoder.
    ``conv_impl`` (``"gemm"`` | ``"pair"``) and ``upsample_impl``
    (``"matmul"`` | ``"fused"``) pick the kernels of every ``DoubleConv`` and
    ``Up`` of the folded graph (``nn.layers.DoubleConv``); parameters and
    state dicts are the same on every route.  ``remat`` (``False`` | ``True``
    | ``"stage"`` | ``"fine"``) checkpoints the EGM family's stages for
    training (``models.egm_unet.EGMUNet``); the vanilla UNet ignores it, as
    the JAX registry does."""
    impls = dict(conv_impl=conv_impl, upsample_impl=upsample_impl, fold_bn=fold_bn)
    if name == "unet":
        model = UNet(num_classes=num_classes, bilinear=bilinear, base_c=base_c,
                     **impls)
    elif name in MODEL_CONFIGS:
        if not bilinear:
            raise ValueError("the EGM-UNet family has the bilinear decoder only")
        model = EGMUNet(num_classes=num_classes, base_c=base_c, remat=remat,
                        **impls, **MODEL_CONFIGS[name])
    else:
        raise ValueError(f"unknown model {name!r}; choose from "
                         f"{['unet', *MODEL_CONFIGS]}")
    if generator is not None:
        (init_weights if fold_bn else init_reference)(model, generator)
    return model
