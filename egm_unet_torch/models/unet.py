"""Vanilla UNet and its decoder stage ``Up`` (port of
``egm_unet_tpu/models/unet.py``), BN folded or with BatchNorm for training
(``fold_bn``, ``nn/layers.py``).

Under a spatial group (``parallel.use_spatial_group``, whose height is the
input's) the training graph runs on this rank's rows of the image: each
stage runs in the scope of its own global height (``stage_scopes``), the
2x2 pools hand over to the next stage's rows, and ``Up`` upsamples and pads
in global rows (``nn.layers.up_to_match``).  The folded graph refuses a
spatial group (ValueError): the JAX package row-splits the BatchNorm graph
only, and the serving kernels take whole maps."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn

from egm_unet_torch.nn.layers import Conv, DoubleConv, pad_to_match, uniform_
from egm_unet_torch.ops.conv import conv_transpose2d_nonoverlap
from egm_unet_torch.ops.pooling import max_pool2d
from egm_unet_torch.ops.resize import upsample2x_bilinear_align_corners
from egm_unet_torch.parallel.mesh import at_height, spatial


def stage_scopes(model: nn.Module, fold_bn: bool):
    """``scope(k)``: the context of stage k of a UNet (global height
    ``H >> k`` of the spatial scope's H; a no-op context without a spatial
    group).  Refuses the folded graph under a spatial group."""
    sp = spatial()
    if sp is None:
        return lambda k: contextlib.nullcontext()
    if fold_bn:
        raise ValueError(f"{type(model).__name__}: the folded (serving) graph does not "
                         f"run row-split; build the training graph (fold_bn=False)")
    return lambda k: at_height(sp.height >> k)


class Up(nn.Module):
    """Upsample x1 + pad + concat([x2, x1]) + DoubleConv.

    ``bilinear=True``: 2x bilinear (align_corners) upsample.  When x2 is
    exactly twice x1's size (every bucketed serving shape) the upsample,
    concat and first conv are one ``up_concat_conv`` launch on the default
    route (``DoubleConv`` lists the others); otherwise the upsampled x1 (by
    ``upsample_impl``) is padded to x2 first.  ``bilinear=False``: a 2x2 / stride 2
    transposed conv ``up_kernel`` (in1, 2, 2, in1 // 2), a per-pixel matmul
    and pixel shuffle.  ``fold_bn`` and ``fine_remat`` go to the
    ``DoubleConv``."""

    def __init__(self, in1: int, in2: int, features: int, bilinear: bool = True,
                 conv_impl: str = "gemm", upsample_impl: str = "matmul",
                 fold_bn: bool = True, fine_remat: bool = False):
        super().__init__()
        self.bilinear = bilinear
        self.upsample_impl = upsample_impl
        impls = dict(conv_impl=conv_impl, upsample_impl=upsample_impl,
                     fold_bn=fold_bn, fine_remat=fine_remat)
        if bilinear:
            self.DoubleConv_0 = DoubleConv(in1 + in2, features,
                                           mid_features=(in1 + in2) // 2, **impls)
        else:
            self.up_kernel = nn.Parameter(torch.zeros(in1, 2, 2, in1 // 2))
            self.DoubleConv_0 = DoubleConv(in1 // 2 + in2, features, **impls)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if not self.bilinear:
            uniform_(self.up_kernel, 1.0 / math.sqrt(self.up_kernel.shape[0]), generator)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        split = spatial() is not None  # row-split: the pad in global rows
        if split and not self.bilinear:
            raise ValueError("the transposed-conv decoder (bilinear=False) does not "
                             "run row-split")
        if self.bilinear:
            if split or (x2.shape[1] == 2 * x1.shape[1] and x2.shape[2] == 2 * x1.shape[2]):
                return self.DoubleConv_0(up_pair=(x2, x1))
            x1 = upsample2x_bilinear_align_corners(x1, self.upsample_impl)
        else:
            x1 = conv_transpose2d_nonoverlap(x1, self.up_kernel)
        x1 = pad_to_match(x1, x2)
        return self.DoubleConv_0(torch.cat([x2, x1], dim=-1))


class UNet(nn.Module):
    """Input NHWC float; returns ``{"out": float32 logits}``."""

    def __init__(self, in_channels: int = 3, num_classes: int = 2,
                 bilinear: bool = True, base_c: int = 64,
                 conv_impl: str = "gemm", upsample_impl: str = "matmul",
                 fold_bn: bool = True):
        super().__init__()
        c = base_c
        factor = 2 if bilinear else 1
        impls = dict(conv_impl=conv_impl, upsample_impl=upsample_impl,
                     fold_bn=fold_bn)
        self.in_conv = DoubleConv(in_channels, c, **impls)
        self.down1 = DoubleConv(c, 2 * c, **impls)
        self.down2 = DoubleConv(2 * c, 4 * c, **impls)
        self.down3 = DoubleConv(4 * c, 8 * c, **impls)
        self.down4 = DoubleConv(8 * c, 16 * c // factor, **impls)
        self.up1 = Up(16 * c // factor, 8 * c, 8 * c // factor, bilinear, **impls)
        self.up2 = Up(8 * c // factor, 4 * c, 4 * c // factor, bilinear, **impls)
        self.up3 = Up(4 * c // factor, 2 * c, 2 * c // factor, bilinear, **impls)
        self.up4 = Up(2 * c // factor, c, c, bilinear, **impls)
        self.out_conv = Conv(c, num_classes, 1)
        self.fold_bn = fold_bn

    def forward(self, x: torch.Tensor) -> dict:
        at = stage_scopes(self, self.fold_bn)
        with at(0):
            x1 = self.in_conv(x)
            p = max_pool2d(x1)  # a pool reads the rows of the stage above
        with at(1):
            x2 = self.down1(p)
            p = max_pool2d(x2)
        with at(2):
            x3 = self.down2(p)
            p = max_pool2d(x3)
        with at(3):
            x4 = self.down3(p)
            p = max_pool2d(x4)
        with at(4):
            x5 = self.down4(p)
        with at(3):
            x = self.up1(x5, x4)
        with at(2):
            x = self.up2(x, x3)
        with at(1):
            x = self.up3(x, x2)
        with at(0):
            x = self.up4(x, x1)
            return {"out": self.out_conv(x).float()}
