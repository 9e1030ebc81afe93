"""Auxiliary modules the reference defines but never wires into the live
graph (port of ``egm_unet_tpu/nn/extra.py``; the reference's
src/EGM-UNet.py:56-340 and its dead ``SoftPooling2D``), NHWC.  None appears
in the EGM-UNet forward; they are here for experiments that use them.

Parameter names mirror the flax tree (``conv``, ``gn.scale``,
``edge_fusion0.Conv_0.kernel``, ``bn1.BatchNorm_0.mean``, ...), so
``utils/from_flax.py`` bridges their weights.  ``HEGDC`` carries two
BatchNorms: ``module.train()`` is flax's ``train=True`` (batch statistics,
running ones updated), ``module.eval()`` its ``train=False``.

``sobel_conv`` computes what the JAX function computes, the sum of the
depthwise Sobel x and y responses.  The reference's ``SobelConv`` selects
depth slice 0 of a Conv3d with depth padding 1, which is the zero-pad
window, so the reference module returns zeros (PARITY.md); the JAX package
implements the evident intent instead, and so does the port.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.nn.layers import BatchNorm, Conv, torch_kernel_init
from egm_unet_torch.ops.conv import conv2d, depthwise_conv2d

SCHARR_X = ((3.0, 0.0, -3.0), (10.0, 0.0, -10.0), (3.0, 0.0, -3.0))
SCHARR_Y = ((3.0, 10.0, 3.0), (0.0, 0.0, 0.0), (-3.0, -10.0, -3.0))
SOBEL_KY = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def _stencil(kernel, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(kernel, dtype=x.dtype, device=x.device)


def _depthwise(kernel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A 3x3 stencil applied to every channel of ``x`` with zero padding 1."""
    c = x.shape[-1]
    return depthwise_conv2d(x, kernel[:, :, None, None].expand(3, 3, 1, c), padding=1)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (eps 1e-5) over [B, L, C]: statistics per sample
    and group of C / groups channels over L; float32 ``scale``, ``bias``."""

    def __init__(self, channels: int, num_groups: int = 16, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().transpose(1, 2), self.num_groups, self.scale,
                         self.bias, self.eps)
        return y.transpose(1, 2)


class ELA(nn.Module):
    """Efficient Local Attention: per-axis mean squeeze -> a shared depthwise
    1-D conv (kernel ``conv``, (k, 1, 1, C)) -> GroupNorm(16) -> sigmoid
    gates multiplied along H and W."""

    def __init__(self, channels: int, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Parameter(torch.zeros(kernel_size, 1, 1, channels))
        self.gn = GroupNorm(channels, 16)

    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_kernel_init(self.conv, generator)

    def _gate(self, v: torch.Tensor) -> torch.Tensor:
        """[B, L, C] -> sigmoid(GN(dwconv1d(v))), the conv in float32."""
        k, c = self.conv.shape[0], self.conv.shape[-1]
        w = self.conv.float().reshape(k, c).t()[:, None, :]  # [C, 1, k]
        y = F.conv1d(v.float().transpose(1, 2), w, padding=k // 2, groups=c)
        return torch.sigmoid(self.gn(y.transpose(1, 2).to(v.dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_h = self._gate(x.mean(dim=2))[:, :, None, :]  # gate along H
        x_w = self._gate(x.mean(dim=1))[:, None, :, :]  # gate along W
        return x * x_h * x_w


def scharr_conv(x: torch.Tensor) -> torch.Tensor:
    """Per-channel Scharr edge strength sqrt(gx^2 + gy^2), zero padding 1."""
    gx = _depthwise(_stencil(SCHARR_X, x), x)
    gy = _depthwise(_stencil(SCHARR_Y, x), x)
    return torch.sqrt(gx ** 2 + gy ** 2)


def sobel_conv(x: torch.Tensor) -> torch.Tensor:
    """Sum of the per-channel Sobel x and y responses, zero padding 1 (the
    JAX function; see the module docstring for the reference's zeros)."""
    ky = _stencil(SOBEL_KY, x)
    return _depthwise(ky.t().contiguous(), x) + _depthwise(ky, x)


class WConv2d(nn.Module):
    """Density-weighted conv: the kernel ``weight`` scaled elementwise by
    Phi = outer(a, a), a = [den..., 1, reversed(den)...], and the output by
    the learnable ``alpha``."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 den: Sequence[float] = (0.5,), stride: int = 1, padding: int = 1):
        super().__init__()
        if 2 * len(den) + 1 != kernel_size:
            raise ValueError(f"den {tuple(den)} gives Phi {2 * len(den) + 1} != "
                             f"kernel {kernel_size}")
        self.den, self.stride, self.padding = tuple(den), stride, padding
        self.weight = nn.Parameter(torch.zeros(kernel_size, kernel_size, in_ch, features))
        self.alpha = nn.Parameter(torch.ones(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-normal on fan_out, truncated at two deviations (flax's
        ``variance_scaling(2, "fan_out", "truncated_normal")``); alpha 1."""
        k, _, _, out = self.weight.shape
        std = math.sqrt(2.0 / (k * k * out)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.alpha.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        den = torch.tensor(self.den, dtype=torch.float32, device=x.device)
        a = torch.cat([den, torch.ones(1, device=x.device), den.flip(0)])
        phi = torch.outer(a, a)[:, :, None, None]
        y = conv2d(x, (self.weight * phi).to(x.dtype), stride=self.stride,
                   padding=self.padding)
        return y * self.alpha.to(x.dtype)


class HEGDC(nn.Module):
    """Hybrid Edge-Guided Double Conv: a frozen Scharr + Sobel edge bank on
    the channel mean, dynamic-norm fusion with gamma 0.5, 5 -> 8 -> mid
    sigmoid edge weights, a density-modulated first conv (``conv1_kernel``
    scaled by sigmoid(``den``)) -> BatchNorm -> ReLU, the edge-guided
    modulation times ``alpha``, then conv -> BatchNorm -> ReLU."""

    def __init__(self, in_ch: int, features: int, mid_features: Optional[int] = None,
                 den: float = 0.5):
        super().__init__()
        mid = mid_features or features
        self.init_den = den
        self.edge_fusion0 = Conv(5, 8, 1)
        self.edge_fusion1 = Conv(8, mid, 1)
        self.den = nn.Parameter(torch.tensor([den]))
        self.alpha = nn.Parameter(torch.ones(()))
        self.conv1_kernel = nn.Parameter(torch.zeros(3, 3, in_ch, mid))
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv(mid, features, 3, padding=1, use_bias=False)
        self.bn2 = BatchNorm(features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.den.fill_(self.init_den)
            self.alpha.fill_(1.0)
        torch_kernel_init(self.conv1_kernel, generator)

    @staticmethod
    def _edge_bank(x: torch.Tensor) -> torch.Tensor:
        """(3, 3, 1, 4): Scharr x, y over 16, Sobel x, y over 4."""
        sx, sy, ky = (_stencil(k, x) for k in (SCHARR_X, SCHARR_Y, SOBEL_KY))
        return torch.stack([sx / 16.0, sy / 16.0, ky.t() / 4.0, ky / 4.0],
                           dim=-1)[:, :, None, :]

    @staticmethod
    def _dynamic_norm_fusion(sx, sy, gx, gy):
        """Min-max over the whole batch, as the reference normalises."""
        scharr = torch.sqrt(sx ** 2 + sy ** 2 + 1e-6)
        scharr = (scharr - scharr.min()) / (scharr.max() - scharr.min() + 1e-6)
        scharr = torch.pow(scharr, 0.5)  # gamma correction
        sobel = gx.abs() + gy.abs()
        sobel = (sobel - sobel.min()) / (sobel.max() - sobel.min() + 1e-6)
        a = torch.sigmoid(scharr.mean() - sobel.mean())
        return a * scharr + (1 - a) * sobel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():  # the frozen edge bank
            edges = conv2d(x.mean(dim=-1, keepdim=True), self._edge_bank(x), padding=1)
            fused = self._dynamic_norm_fusion(edges[..., 0:1], edges[..., 1:2],
                                              edges[..., 2:3], edges[..., 3:4])
        all_edges = torch.cat([edges, fused], dim=-1)  # [B, H, W, 5]
        ew = self.edge_fusion1(F.relu(self.edge_fusion0(all_edges)))
        edge_weights = torch.sigmoid(ew)

        phi = torch.sigmoid(self.den[0])
        y = conv2d(x, (self.conv1_kernel * phi).to(x.dtype), padding=1)
        y = F.relu(self.bn1(y))
        y = y * edge_weights * self.alpha.to(y.dtype)
        return F.relu(self.bn2(self.conv2(y)))


def soft_pooling_2d(x: torch.Tensor) -> torch.Tensor:
    """Global exponential-weighted (soft) pool over H and W: [B, H, W, C] ->
    [B, 1, 1, C] of sum(e^x * x) / sum(e^x), as a softmax over the spatial
    axes (no overflow for large activations), in float32."""
    b, h, w, c = x.shape
    flat = x.float().reshape(b, h * w, c)
    out = (torch.softmax(flat, dim=1) * flat).sum(dim=1)
    return out.reshape(b, 1, 1, c).to(x.dtype)
