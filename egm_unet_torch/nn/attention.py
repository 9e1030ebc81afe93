"""Attention modules of the EGM-UNet family, NHWC (port of
``egm_unet_tpu/nn/attention.py``).

In the inference graph the MCALayer's three gate vectors are one
``mca_gates`` call (kernel K7 on the card) and everything after them one
``mca_fused`` launch; the training graph takes the plain, differentiable
``mca_gates_plain`` (each ``MCAGate``) and ``mca_plain``.
While calibrating int8 scales, or where its ``xout`` storage site is active
(``ops/quant.py``), the layer takes the JAX package's unfused route instead:
the three gated tensors averaged into ``x_out``, its storage site, then the
enhancement in plain tensor ops.

Under a spatial group (``parallel/halo.py``) each rank holds rows of the
map: the MCA gates take the plain route, whose reductions over H, like
ChannelAttention's pools, sum (and take the maximum) over the group; the H
gate's 1-D conv and every window op fetch their halos.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.nn.layers import Conv, uniform_
from egm_unet_torch.ops.cuda.gates import gate_plain, mca_gates
from egm_unet_torch.ops.cuda.mca import mca_fused, mca_plain
from egm_unet_torch.ops.pooling import avg_pool2d, max_pool2d, min_pool2d
from egm_unet_torch.ops.quant import current_quant_mode, qstore, site_active
from egm_unet_torch.ops.shuffle import channel_shuffle
from egm_unet_torch.parallel.halo import spatial_max, spatial_sum
from egm_unet_torch.parallel.mesh import spatial


def mca_kernel_size(channels: int) -> int:
    """k = round(|log2(C) - 1| / 1.5) forced odd."""
    temp = round(abs((math.log2(channels) - 1) / 1.5))
    k = temp if temp % 2 else temp - 1
    return max(k, 1)


class MCAGate(nn.Module):
    """One coordinate-attention gate along ``axis`` (1=H, 2=W, 3=C of NHWC):
    avg and std (centred two-pass, Bessel factor n/(n-1)) over the other two
    axes, blended as 0.5*(avg+std) + sigmoid(w0)*avg + sigmoid(w1)*std, a
    length-k zero-padded 1-D conv, sigmoid.  Statistics in float32; returns
    the float32 gate vector [B, L], which ``mca_fused`` applies."""

    def __init__(self, axis: int, k_size: int = 3):
        super().__init__()
        self.axis = axis
        self.weight = nn.Parameter(torch.zeros(2))
        self.conv = nn.Parameter(torch.zeros(k_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(torch.rand(2, generator=generator))
        uniform_(self.conv, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gate_plain(x, self.axis, self.weight, self.conv)


class MCALayer(nn.Module):
    """Enhanced multi-dimension coordinate attention (module "C"): the three
    gates, then the enhancement (``ops/cuda/mca.py``).  ``fused=True`` (the
    inference graph): the gates by ``mca_gates`` (K7 on the card) and the
    fused enhancement kernel; ``fused=False`` (the training graph, on every
    device) or a spatial group: each ``MCAGate`` and the plain composite,
    which autograd differentiates."""

    def __init__(self, channels: int, fused: bool = True):
        super().__init__()
        self.fused = fused
        self.h_cw = MCAGate(axis=1, k_size=3)
        self.w_hc = MCAGate(axis=2, k_size=3)
        self.c_hw = MCAGate(axis=3, k_size=mca_kernel_size(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if self.fused and spatial() is None:
            gates = mca_gates(x, [(g.weight, g.conv) for g in
                                  (self.h_cw, self.w_hc, self.c_hw)])
        else:
            gates = self.h_cw(x), self.w_hc(x), self.c_hw(x)
        if self.fused and (current_quant_mode() == "calibrate"
                           or site_active(self, "xout")):
            return qstore(self, mca_unfused(self, x, *gates), "out")
        enhance = mca_fused if self.fused else mca_plain
        return qstore(self, enhance(x, *gates, groups=4), "out")


def mca_unfused(layer: nn.Module, x: torch.Tensor, g_h: torch.Tensor,
                g_w: torch.Tensor, g_c: torch.Tensor) -> torch.Tensor:
    """The JAX package's unfused MCALayer route, op by op in x's dtype: each
    gate applied to x, ``x_out`` their mean (storage site ``xout`` of
    ``layer``), then ``0.4 x_out + 0.2 (max3 - min3) + 0.2 avg3((x_out -
    avg3 x_out)^2) + 0.1 (1.1 x_out) + 0.1 shuffle(x_out)``."""
    dt = x.dtype
    x_h = x * g_h.to(dt)[:, :, None, None]
    x_w = x * g_w.to(dt)[:, None, :, None]
    x_c = x * g_c.to(dt)[:, None, None, :]
    x_out = qstore(layer, (x_c + x_h + x_w) / 3.0, "xout")
    local_range = max_pool2d(x_out, 3, 1, 1) - min_pool2d(x_out, 3, 1, 1)
    mean = avg_pool2d(x_out, 3, 1, 1)
    local_variance = avg_pool2d((x_out - mean) ** 2, 3, 1, 1)
    freq = x_out * torch.tensor(1.1, dtype=dt)
    return (0.4 * x_out + 0.2 * local_range + 0.2 * local_variance + 0.1 * freq
            + 0.1 * channel_shuffle(x_out, 4))


class RecursiveGatedAttention(nn.Module):
    """Module "B": recursive gating at the bottleneck (gnconv-style, order 2,
    gate reduction 8, 3x3 depthwise conv); exact GELU."""

    def __init__(self, dim: int):
        super().__init__()
        order, reduction = 2, 8
        split = [dim // (2 ** i) for i in range(1, order)]
        split.append(dim // (2 ** (order - 1)))
        split.reverse()
        if sum(split) > dim:
            split[-1] = dim - sum(split[:-1])
        self.split = tuple(split)
        total = sum(split)
        self.proj_in = Conv(dim, split[0] + total, 1)
        self.scale = nn.Parameter(torch.ones(()))
        self.dwconv = Conv(total, total, 3, padding=1, groups=total)
        for i, size in enumerate(split):
            hidden = max(size // reduction, 8)
            setattr(self, f"gate{i}_down", Conv(size, hidden, 1))
            setattr(self, f"gate{i}_up", Conv(hidden, 1, 1))
            if i < len(split) - 1:
                setattr(self, f"transform{i}", Conv(size, split[i + 1], 1))
        self.proj_out = Conv(split[-1], dim, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = self.split
        fused = self.proj_in(x)
        base, gates = fused[..., :split[0]], fused[..., split[0]:]
        gates = self.dwconv(gates) * self.scale.to(gates.dtype)
        out = base
        offset = 0
        for i, size in enumerate(split):
            g = gates[..., offset:offset + size]
            offset += size
            gm = F.gelu(getattr(self, f"gate{i}_down")(g), approximate="none")
            out = out * torch.sigmoid(getattr(self, f"gate{i}_up")(gm))
            if i < len(split) - 1:
                out = getattr(self, f"transform{i}")(out)
        return self.proj_out(out)


class ChannelAttention(nn.Module):
    """sigmoid(MLP(avgpool) + MLP(maxpool)), reduction 4, no biases."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc_down = Conv(channels, channels // 4, 1, use_bias=False)
        self.fc_up = Conv(channels // 4, channels, 1, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sp = spatial()
        if sp is None:
            avg = x.mean(dim=(1, 2), keepdim=True)
            mx = x.amax(dim=(1, 2), keepdim=True)
        else:  # this rank's rows: sum and max over the spatial group
            n = sp.height * x.shape[2]
            avg = (spatial_sum(x.float().sum(dim=(1, 2), keepdim=True)) / n).to(x.dtype)
            mx = spatial_max(x.amax(dim=(1, 2), keepdim=True))
        mlp = lambda v: self.fc_up(F.relu(self.fc_down(v)))
        return torch.sigmoid(mlp(avg) + mlp(mx))


class SpatialAttention(nn.Module):
    """sigmoid(conv7x7([mean_c; max_c]))."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(2, 1, 7, padding=3, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.cat([x.mean(dim=-1, keepdim=True),
                       x.amax(dim=-1, keepdim=True)], dim=-1)
        return torch.sigmoid(self.Conv_0(s))
