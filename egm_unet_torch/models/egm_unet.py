"""EGM-UNet / GRFB-UNet with the composable A/B/C ablation modules (port of
``egm_unet_tpu/models/egm_unet.py``), BN folded for inference or with
BatchNorm for training (``fold_bn``, ``nn/layers.py``).

- A ``block='edge'``: EdgeEnhancedGRFB after each encoder DoubleConv1.
- A' ``block='grfb'``: the original GRFB block instead (GRFB-UNet baseline).
- B ``use_rga``: RecursiveGatedAttention at the bottleneck.
- C ``use_mca``: MCALayer between the two convs of each DoubleConv1.

Under a spatial group the training graph runs row-split, each stage in the
scope of its height, as ``models/unet.py`` describes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from egm_unet_torch.models.unet import Up, stage_scopes
from egm_unet_torch.nn.attention import MCALayer, RecursiveGatedAttention
from egm_unet_torch.nn.grfb import GRFB, EdgeEnhancedGRFB
from egm_unet_torch.nn.layers import Conv, ConvBNReLU, DoubleConv, call_maybe_remat
from egm_unet_torch.ops.pooling import max_pool2d
from egm_unet_torch.ops.quant import qstore

REMAT_MODES = (False, True, "stage", "fine")


class DoubleConv1(nn.Module):
    """Encoder stage: ConvBNReLU [-> MCALayer] -> ConvBNReLU [-> EGRFB or
    GRFB].  ``fine_remat`` checkpoints each ConvBNReLU and each GRFB
    branch."""

    def __init__(self, in_ch: int, features: int, block: Optional[str] = "edge",
                 use_mca: bool = True, fold_bn: bool = True,
                 fine_remat: bool = False):
        super().__init__()
        if block not in ("edge", "grfb", None):
            raise ValueError(f"unknown block {block!r}")
        self.fine_remat = fine_remat
        grfb = dict(fold_bn=fold_bn, fine_remat=fine_remat)
        self.conv1 = ConvBNReLU(in_ch, features, fold_bn)
        self.mca = MCALayer(features, fused=fold_bn) if use_mca else None
        self.conv2 = ConvBNReLU(features, features, fold_bn)
        self.egrfb = (EdgeEnhancedGRFB(features, features, **grfb)
                      if block == "edge" else None)
        self.grfb = GRFB(features, features, **grfb) if block == "grfb" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = call_maybe_remat(self.fine_remat, self.conv1, x)
        if self.mca is not None:
            x = self.mca(x)
        x = call_maybe_remat(self.fine_remat, self.conv2, x)
        if self.egrfb is not None:
            x = self.egrfb(x)
        if self.grfb is not None:
            x = self.grfb(x)
        return x


class EGMUNet(nn.Module):
    """``block='edge', use_rga=True, use_mca=True`` is the published A+B+C
    configuration; the decoder is the bilinear one.  ``conv_impl`` and
    ``upsample_impl`` pick the route of the stem and decoder ``DoubleConv``s
    of the folded graph (``nn.layers.DoubleConv``); the encoder stages hold
    an MCALayer between their convs and always take ``conv3x3_gemm``.
    ``remat`` (training graph): ``True`` / ``"stage"`` checkpoints the stem,
    each encoder stage and each decoder stage; ``"fine"`` also each
    ConvBNReLU and GRFB branch inside them.  Input NHWC float with 3
    channels; returns ``{"out": float32 logits}``."""

    def __init__(self, num_classes: int = 2, base_c: int = 32,
                 block: Optional[str] = "edge", use_rga: bool = True,
                 use_mca: bool = True, conv_impl: str = "gemm",
                 upsample_impl: str = "matmul", fold_bn: bool = True,
                 remat=False):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat {remat!r}; choose from {REMAT_MODES}")
        c = base_c
        self.remat = bool(remat)
        fine = remat == "fine"
        impls = dict(conv_impl=conv_impl, upsample_impl=upsample_impl,
                     fold_bn=fold_bn, fine_remat=fine)
        self.in_conv = DoubleConv(3, c, **impls)

        def down(cin, cout):
            return DoubleConv1(cin, cout, block=block, use_mca=use_mca,
                               fold_bn=fold_bn, fine_remat=fine)

        self.down1 = down(c, 2 * c)
        self.down2 = down(2 * c, 4 * c)
        self.down3 = down(4 * c, 8 * c)
        self.down4 = down(8 * c, 8 * c)
        self.attn1 = RecursiveGatedAttention(dim=8 * c) if use_rga else None
        self.up1 = Up(8 * c, 8 * c, 4 * c, **impls)
        self.up2 = Up(4 * c, 4 * c, 2 * c, **impls)
        self.up3 = Up(2 * c, 2 * c, c, **impls)
        self.up4 = Up(c, c, c, **impls)
        self.out_conv = Conv(c, num_classes, 1)
        self.fold_bn = fold_bn

    def forward(self, x: torch.Tensor) -> dict:
        stage = lambda mod, *args: call_maybe_remat(self.remat, mod, *args)
        # the pooled maps are int8 storage sites ``:pool1`` .. ``:pool4``
        pool = lambda v, tag: qstore(self, max_pool2d(v), tag)
        at = stage_scopes(self, self.fold_bn)
        with at(0):
            x1 = stage(self.in_conv, x)
            p = pool(x1, "pool1")  # a pool reads the rows of the stage above
        with at(1):
            x2 = stage(self.down1, p)
            p = pool(x2, "pool2")
        with at(2):
            x3 = stage(self.down2, p)
            p = pool(x3, "pool3")
        with at(3):
            x4 = stage(self.down3, p)
            p = pool(x4, "pool4")
        with at(4):
            x5 = stage(self.down4, p)
            if self.attn1 is not None:
                x5 = self.attn1(x5)
        with at(3):
            x = stage(self.up1, x5, x4)
        with at(2):
            x = stage(self.up2, x, x3)
        with at(1):
            x = stage(self.up3, x, x2)
        with at(0):
            x = stage(self.up4, x, x1)
            return {"out": self.out_conv(x).float()}
