"""Conv blocks of the BN-folded inference graph, NHWC (port of
``egm_unet_tpu/nn/layers.py``).

Only the folded forms exist here: every conv that the JAX graph follows with
a BatchNorm carries the folded bias instead (``models/fold_bn.py``).  Module
and parameter names mirror the flax tree (``Conv_0``, ``ConvBNReLU_0``,
``kernel``, ``bias``, ...) so ``utils/from_flax.py`` maps one onto the other
by name.

Every 3x3 / stride 1 / pad 1 / dilation 1 / groups 1 conv of a ConvBNReLU
or BasicConv goes through the ``conv3x3_gemm`` kernel, at any channel count;
the decoder's first conv (``up_pair``) goes through ``up_concat_conv``.
``DoubleConv`` has two alternative routes, chosen when the model is built:
``conv_impl="pair"`` sends both of its convs through one
``conv3x3_pair_gemm`` launch, and ``upsample_impl="fused"`` upsamples the
decoder's low-resolution input with ``upsample2x_fused`` before the concat.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.ops.conv import conv2d
from egm_unet_torch.ops.cuda.conv3x3 import conv3x3_gemm, conv3x3_pair_gemm
from egm_unet_torch.ops.cuda.upconv import up_concat_conv
from egm_unet_torch.ops.pooling import avg_pool2d
from egm_unet_torch.ops.resize import (UPSAMPLE_IMPLS,
                                       upsample2x_bilinear_align_corners)

CONV_IMPLS = ("gemm", "pair")


def _pair(v):
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)


class Conv(nn.Module):
    """Conv2d with an HWIO ``kernel`` (kh, kw, in_ch // groups, features)
    and an optional ``bias``; integer symmetric zero padding."""

    flax_child = "Conv_0"  # the flax wrapper holds one core nn.Conv
    casts_with_compute_dtype = True

    def __init__(self, in_ch: int, features: int, kernel_size=3, stride=1,
                 padding=0, dilation=1, groups: int = 1, use_bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.dilation, self.groups = _pair(dilation), groups
        self.kernel = nn.Parameter(torch.zeros(kh, kw, in_ch // groups, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def is_plain3x3(self) -> bool:
        return (tuple(self.kernel.shape[:2]) == (3, 3) and self.stride == (1, 1)
                and self.padding == (1, 1) and self.dilation == (1, 1)
                and self.groups == 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-uniform kernel (keeps activations at scale through the ReLU
        stack of a model with random weights), small uniform bias."""
        fan_in = self.kernel[..., 0].numel()
        uniform_(self.kernel, math.sqrt(6.0 / fan_in), generator)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.kernel, self.bias, stride=self.stride,
                      padding=self.padding, dilation=self.dilation,
                      groups=self.groups)


class CoreConv(Conv):
    """A ``Conv`` whose flax counterpart is a bare ``nn.Conv`` (its leaves
    are ``name/kernel``, not ``name/Conv_0/kernel``)."""

    flax_child = None


class Dense(nn.Module):
    """``x @ kernel + bias`` with ``kernel`` [in, out] as flax ``nn.Dense``
    stores it.  The input is cast to the kernel's dtype, which is the
    module's compute dtype (``cast_weights``)."""

    casts_with_compute_dtype = True

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Variance 1 / fan_in, so unit-variance inputs stay at scale."""
        fan_in = self.kernel.shape[0]
        uniform_(self.kernel, math.sqrt(3.0 / fan_in), generator)
        if self.bias is not None:
            uniform_(self.bias, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.kernel.dtype), self.kernel.t(), self.bias)


class LayerNorm(nn.Module):
    """LayerNorm (eps 1e-5) in float32 with float32 parameters ``scale`` and
    ``bias`` whatever the compute dtype; the result stays float32, as flax
    ``nn.LayerNorm(dtype=float32)`` leaves it."""

    def __init__(self, width: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale.dtype != torch.float32:
            raise TypeError("LayerNorm parameters must stay float32; cast the "
                            "model with nn.layers.cast_weights, not .to(dtype)")
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, 1e-5)


def cast_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the matmul and conv weights (``Dense``, ``Conv``) to the compute
    dtype ``dtype``, in place.  Every other parameter (LayerNorm scales,
    embeddings, positional tables, output projections) stays float32 and is
    cast where it is used, as the JAX modules keep ``param_dtype=float32``
    and compute LayerNorm and the projections in float32.  Use this, not
    ``model.to(dtype)``, on the transformer models."""
    for mod in model.modules():
        if getattr(mod, "casts_with_compute_dtype", False):
            for p in mod.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


class BasicConv(nn.Module):
    """Folded conv -> (BN) -> ReLU of the GRFB blocks."""

    def __init__(self, in_ch: int, features: int, kernel_size=3, stride=1,
                 padding=0, dilation=1, groups: int = 1, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.Conv_0 = Conv(in_ch, features, kernel_size, stride, padding,
                           dilation, groups, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.Conv_0
        if conv.is_plain3x3():
            return conv3x3_gemm(x.contiguous(), conv.kernel, conv.bias,
                                relu=self.relu)
        x = conv(x)
        return F.relu(x) if self.relu else x


def pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad x1 spatially to x2's H/W, split as the reference splits."""
    dy = x2.shape[1] - x1.shape[1]
    dx = x2.shape[2] - x1.shape[2]
    if dy == 0 and dx == 0:
        return x1
    return F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


class ConvBNReLU(nn.Module):
    """Folded conv3x3 -> ReLU, one half of DoubleConv.  ``up_pair=(x2, x1)``
    is the decoder form ``relu(conv3x3(concat([x2, up2x(x1)])))``, x2
    exactly twice x1's size, in one ``up_concat_conv`` launch."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, 3, padding=1, use_bias=True)

    def forward(self, x: Optional[torch.Tensor] = None, *,
                up_pair=None) -> torch.Tensor:
        k, b = self.Conv_0.kernel, self.Conv_0.bias
        if up_pair is not None:
            x2, x1 = up_pair
            return up_concat_conv(x2.contiguous(), x1.contiguous(), k, b)
        return conv3x3_gemm(x.contiguous(), k, b, relu=True)


class DoubleConv(nn.Module):
    """(conv3x3 -> ReLU) x 2 with an optional mid width.  ``up_pair=(x2,
    x1)`` is the decoder form on ``concat([x2, up2x(x1)])``, x2 exactly twice
    x1's size.

    Routes (the parameters are the same on all of them):

    - ``conv_impl="gemm"``, ``upsample_impl="matmul"`` (default): one
      ``conv3x3_gemm`` launch per conv; with ``up_pair`` the first is one
      ``up_concat_conv`` launch.
    - ``conv_impl="pair"``: both convs in one ``conv3x3_pair_gemm`` launch;
      with ``up_pair`` the upsample (by ``upsample_impl``) and the concat
      come first, as plain tensor ops.
    - ``conv_impl="gemm"``, ``upsample_impl="fused"``: with ``up_pair``,
      ``upsample2x_fused``, concat, then two ``conv3x3_gemm`` launches.
    """

    def __init__(self, in_ch: int, features: int, mid_features: Optional[int] = None,
                 conv_impl: str = "gemm", upsample_impl: str = "matmul"):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv impl {conv_impl!r}; choose from "
                             f"{list(CONV_IMPLS)}")
        if upsample_impl not in UPSAMPLE_IMPLS:
            raise ValueError(f"unknown upsample impl {upsample_impl!r}; choose "
                             f"from {list(UPSAMPLE_IMPLS)}")
        self.conv_impl, self.upsample_impl = conv_impl, upsample_impl
        mid = mid_features or features
        self.ConvBNReLU_0 = ConvBNReLU(in_ch, mid)
        self.ConvBNReLU_1 = ConvBNReLU(mid, features)

    def forward(self, x: Optional[torch.Tensor] = None, *,
                up_pair=None) -> torch.Tensor:
        if up_pair is not None and (self.conv_impl == "pair"
                                    or self.upsample_impl == "fused"):
            x2, x1 = up_pair
            up = upsample2x_bilinear_align_corners(x1, self.upsample_impl)
            x, up_pair = torch.cat([x2, up], dim=-1), None
        if self.conv_impl == "pair":
            c1, c2 = self.ConvBNReLU_0.Conv_0, self.ConvBNReLU_1.Conv_0
            return conv3x3_pair_gemm(x.contiguous(), c1.kernel, c1.bias,
                                     c2.kernel, c2.bias)
        return self.ConvBNReLU_1(self.ConvBNReLU_0(x, up_pair=up_pair))


class EdgeAwareFeatureEnhancer(nn.Module):
    """edge = x - AvgPool3x3(x); w = sigmoid(conv1x1(edge)); out = w*x + x."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = Conv(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        edge = x - avg_pool2d(x, 3, 1, 1)
        w = torch.sigmoid(self.Conv_0(edge))
        return w * x + x
