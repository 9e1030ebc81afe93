"""GRFB blocks (port of ``egm_unet_tpu/nn/grfb.py``): the edge-enhanced
variant (module "A") with its FusionConv, and the original receptive-field
block of the GRFB-UNet baseline; BN folded, or with BatchNorm for training
(``fold_bn``, ``nn/layers.py``).  ``fine_remat`` checkpoints each branch
(the JAX package's per-branch ``nn.remat``)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.nn.attention import ChannelAttention, SpatialAttention
from egm_unet_torch.nn.layers import (BasicConv, Conv, EdgeAwareFeatureEnhancer,
                                      remat, uniform_)
from egm_unet_torch.ops.conv import conv2d
from egm_unet_torch.ops.quant import qstore


class FusionConv(nn.Module):
    """concat -> 1x1 down to features/4 -> (3x3 + 5x5 + 7x7) x spatial attn,
    with channel attention: up(res + s * c).

    The block calls it with the same tensor twice, so the 1x1 over
    ``cat([x, x])`` folds to ``x @ (W_top + W_bottom)``; the three SAME convs
    fold into one 7x7 whose kernel is ``W7 + pad(W5) + pad(W3)``.  The
    parameters keep the reference shapes (``down_kernel`` has 2 * in_ch
    input rows), so that gradients and updates reach each of them; the
    block has no BatchNorm and is the same in both graphs."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        dim = features // 4
        self.in_ch = in_ch
        self.down_kernel = nn.Parameter(torch.zeros(1, 1, 2 * in_ch, dim))
        self.down_bias = nn.Parameter(torch.zeros(dim))
        for k in (3, 5, 7):
            setattr(self, f"conv{k}_kernel", nn.Parameter(torch.zeros(k, k, dim, dim)))
            setattr(self, f"conv{k}_bias", nn.Parameter(torch.zeros(dim)))
        self.spatial = SpatialAttention()
        self.channel = ChannelAttention(dim)
        self.up = Conv(dim, features, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan = 2 * self.in_ch
        uniform_(self.down_kernel, math.sqrt(6.0 / fan), generator)
        uniform_(self.down_bias, 1.0 / math.sqrt(fan), generator)
        dim = self.down_bias.shape[0]
        for k in (3, 5, 7):
            uniform_(getattr(self, f"conv{k}_kernel"), math.sqrt(2.0 / (dim * k * k)),
                     generator)
            uniform_(getattr(self, f"conv{k}_bias"), 1.0 / math.sqrt(dim * k * k),
                     generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1]
        w_eff = self.down_kernel[:, :, :half] + self.down_kernel[:, :, half:]
        x = conv2d(x, w_eff) + self.down_bias.to(x.dtype)
        res = x
        w_merged = (self.conv7_kernel
                    + F.pad(self.conv5_kernel, (0, 0, 0, 0, 1, 1, 1, 1))
                    + F.pad(self.conv3_kernel, (0, 0, 0, 0, 2, 2, 2, 2)))
        s = conv2d(x, w_merged, padding=3) + (
            self.conv3_bias + self.conv5_bias + self.conv7_bias).to(x.dtype)
        s = s * self.spatial(s)
        c = self.channel(x)
        return qstore(self, self.up(res + s * c), "out", signed=True)


class EdgeEnhancedGRFB(nn.Module):
    """Input edge-enhance -> three dilated branches (d = visual, 2*visual,
    3*visual) -> concat with the input -> FusionConv -> residual scaled by
    0.1 -> ReLU -> target enhancer (out *= 1 + mean_c(sigmoid(conv3x3(out)))).
    Stride 1, as every call site of the model."""

    def __init__(self, in_ch: int, features: int, visual: int = 12,
                 fold_bn: bool = True, fine_remat: bool = False):
        super().__init__()
        inter = max(in_ch // 8, 4)
        v = visual
        self.fine_remat = fine_remat
        BC = lambda *a, **k: BasicConv(*a, fold_bn=fold_bn, **k)
        self.edge_enhancer = EdgeAwareFeatureEnhancer(in_ch, fold_bn)
        self.dir0 = BC(in_ch, 2 * inter, 1)
        self.dir1 = BC(2 * inter, 2 * inter, 3, padding=v, dilation=v, relu=False)
        self.dir2 = BC(2 * inter, 2 * inter, 1)
        self.edge0 = BC(in_ch, inter, 1)
        self.edge_eafe = EdgeAwareFeatureEnhancer(inter, fold_bn)
        self.edge1 = BC(inter, 2 * inter, 3, padding=1, groups=inter)
        self.edge2 = BC(2 * inter, 2 * inter, 3, padding=2 * v, dilation=2 * v,
                        relu=False)
        self.edge3 = BC(2 * inter, 2 * inter, 1)
        self.ctx0 = BC(in_ch, inter, 3, padding=1)
        self.ctx1 = BC(inter, 2 * inter, 3, padding=1, groups=2)
        self.ctx2 = BC(2 * inter, 2 * inter, 3, padding=3 * v, dilation=3 * v,
                       relu=False)
        self.ctx3 = BC(2 * inter, 2 * inter, 1)
        self.fusion = FusionConv(in_ch + 6 * inter, features)
        self.shortcut = BC(in_ch, features, 1, relu=False)
        self.target_enhancer = Conv(features, 3, 3, padding=1)

    def _dir(self, xe):
        return self.dir2(self.dir1(self.dir0(xe)))

    def _edge(self, xe):
        return self.edge3(self.edge2(self.edge1(self.edge_eafe(self.edge0(xe)))))

    def _ctx(self, xe):
        return self.ctx3(self.ctx2(self.ctx1(self.ctx0(xe))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # int8 storage sites (ops/quant.py): xe, res, enh
        xe = qstore(self, self.edge_enhancer(x), "xe")
        branches = (self._dir, self._edge, self._ctx)
        if self.fine_remat:
            d, e, c = (remat(self, b, xe) for b in branches)
        else:
            d, e, c = (b(xe) for b in branches)
        out = self.fusion(torch.cat([x, d, e, c], dim=-1))
        out = qstore(self, F.relu(out * 0.1 + self.shortcut(x)), "res")
        tw = torch.sigmoid(self.target_enhancer(out))
        return qstore(self, out * (1.0 + tw.mean(dim=-1, keepdim=True)), "enh")


class GRFB(nn.Module):
    """The original GRFB block (GRFB-UNet baseline): three dilated branches
    (d = visual, 2*visual, 3*visual), concat with the input, 1x1 linear,
    residual scaled by 0.1, ReLU.  Stride 1, as every call site of the
    model."""

    def __init__(self, in_ch: int, features: int, visual: int = 12,
                 fold_bn: bool = True, fine_remat: bool = False):
        super().__init__()
        inter = in_ch // 8
        v = visual
        self.fine_remat = fine_remat
        BC = lambda *a, **k: BasicConv(*a, fold_bn=fold_bn, **k)
        self.b0_0 = BC(in_ch, 2 * inter, 1)
        self.b0_1 = BC(2 * inter, 2 * inter, 3, padding=v, dilation=v, relu=False)
        self.b0_2 = BC(2 * inter, 2 * inter, 1)
        self.b1_0 = BC(in_ch, inter, 1)
        self.b1_1 = BC(inter, 2 * inter, 3, padding=1, groups=inter)
        self.b1_2 = BC(2 * inter, 2 * inter, 1)
        self.b1_3 = BC(2 * inter, 2 * inter, 3, padding=2 * v, dilation=2 * v,
                       relu=False)
        self.b1_4 = BC(2 * inter, 2 * inter, 1)
        self.b2_0 = BC(in_ch, inter, 1)
        self.b2_1 = BC(inter, 2 * inter, 3, padding=1, groups=inter)
        self.b2_2 = BC(2 * inter, 2 * inter, 1)
        self.b2_3 = BC(2 * inter, 2 * inter, 3, padding=1, groups=2 * inter)
        self.b2_4 = BC(2 * inter, 2 * inter, 1)
        self.b2_5 = BC(2 * inter, 2 * inter, 3, padding=3 * v, dilation=3 * v,
                       relu=False)
        self.b2_6 = BC(2 * inter, 2 * inter, 1)
        self.conv_linear = BC(in_ch + 6 * inter, features, 1, relu=False)
        self.shortcut = BC(in_ch, features, 1, relu=False)

    def _branch(self, i: int, n: int, x: torch.Tensor) -> torch.Tensor:
        for j in range(n):
            x = getattr(self, f"b{i}_{j}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spans = ((0, 3), (1, 5), (2, 7))
        if self.fine_remat:
            b0, b1, b2 = (remat(self, self._branch, i, n, x) for i, n in spans)
        else:
            b0, b1, b2 = (self._branch(i, n, x) for i, n in spans)
        out = self.conv_linear(torch.cat([x, b0, b1, b2], dim=-1))
        return qstore(self, F.relu(out * 0.1 + self.shortcut(x)), "out")
