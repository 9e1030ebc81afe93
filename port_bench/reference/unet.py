"""Plain PyTorch reference of EGM-UNet (A+B+C) and GRFB-UNet with BatchNorm
unfolded: conv -> BatchNorm -> ReLU, NHWC activations, HWIO kernels.

Written from the published description (feiyeha/EGM-Unet; SURVEY.md of this
repository) in the form the port's training graph names its leaves, so one
state dict fits both.  No kernel, no folding, no cast: float32 (or whatever
dtype the weights and input carry); BatchNorm normalises with the running
statistics.  ``low_precision`` rounds every convolution's operands to a
lower dtype, for the bfloat16 cell's control.

Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _pair(v):
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def conv_nhwc(x, kernel, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """``kernel`` (kh, kw, in // groups, out)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias,
                 stride=stride, padding=padding, dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1)


def fake_quant(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and back (a float8 is scaled per tensor
    into its range first, as float8 GEMMs take their operands)."""
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        scale = torch.finfo(dtype).max / t.abs().amax().float().clamp_min(1e-12)
        return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)
    return t.to(dtype).to(t.dtype)


@contextlib.contextmanager
def low_precision(dtype):
    """Inside, every reference convolution's input and kernel are rounded to
    ``dtype``, as a program computing its convolutions in that precision
    would see them; the sums stay in the operands' own dtype."""
    global conv_nhwc
    exact = conv_nhwc

    def rounded(x, kernel, *a, **k):
        return exact(fake_quant(x, dtype), fake_quant(kernel, dtype), *a, **k)
    conv_nhwc = rounded
    try:
        yield
    finally:
        conv_nhwc = exact


def pool_nhwc(fn, x, *args, **kwargs):
    return fn(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)


def max3(x):
    return pool_nhwc(F.max_pool2d, x, 3, 1, 1)


def avg3(x):
    return pool_nhwc(F.avg_pool2d, x, 3, 1, 1, count_include_pad=True)


def upsample2x(x):
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``."""
    return pool_nhwc(F.interpolate, x, scale_factor=2, mode="bilinear",
                     align_corners=True)


class Conv(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, padding=0, dilation=1, groups=1,
                 bias=True):
        super().__init__()
        kh, kw = _pair(k)
        self.kernel = nn.Parameter(torch.zeros(kh, kw, cin // groups, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups

    def forward(self, x):
        return conv_nhwc(x, self.kernel, self.bias, self.stride, self.padding,
                         self.dilation, self.groups)


class BatchNorm(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        return ((xs - self.mean) * (self.scale * torch.rsqrt(self.var + self.eps))
                + self.bias).to(x.dtype)


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, 3, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, mid=None):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(cin, mid or cout)
        self.ConvBNReLU_1 = ConvBNReLU(mid or cout, cout)

    def forward(self, x):
        return self.ConvBNReLU_1(self.ConvBNReLU_0(x))


class BasicConv(nn.Module):
    """conv -> BatchNorm [-> ReLU], no conv bias."""

    def __init__(self, cin, cout, k, padding=0, dilation=1, groups=1, relu=True):
        super().__init__()
        self.relu = relu
        self.Conv_0 = Conv(cin, cout, k, padding=padding, dilation=dilation,
                           groups=groups, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        y = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(y) if self.relu else y


class EdgeAware(nn.Module):
    """w = sigmoid(BN(conv1x1(x - avg3(x)))); out = w x + x."""

    def __init__(self, c):
        super().__init__()
        self.Conv_0 = Conv(c, c, 1)
        self.BatchNorm_0 = BatchNorm(c)

    def forward(self, x):
        w = torch.sigmoid(self.BatchNorm_0(self.Conv_0(x - avg3(x))))
        return w * x + x


class ChannelAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.fc_down = Conv(c, c // 4, 1, bias=False)
        self.fc_up = Conv(c // 4, c, 1, bias=False)

    def forward(self, x):
        mlp = lambda v: self.fc_up(F.relu(self.fc_down(v)))  # noqa: E731
        return torch.sigmoid(mlp(x.mean(dim=(1, 2), keepdim=True))
                             + mlp(x.amax(dim=(1, 2), keepdim=True)))


class SpatialAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(2, 1, 7, padding=3, bias=False)

    def forward(self, x):
        s = torch.cat([x.mean(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)], -1)
        return torch.sigmoid(self.Conv_0(s))


class FusionConv(nn.Module):
    """1x1 over cat([x, x]) down to features/4; the sum of a 3x3, a 5x5 and a
    7x7 conv gated by spatial attention; channel attention; 1x1 up."""

    def __init__(self, cin, features):
        super().__init__()
        dim = features // 4
        self.down_kernel = nn.Parameter(torch.zeros(1, 1, 2 * cin, dim))
        self.down_bias = nn.Parameter(torch.zeros(dim))
        for k in (3, 5, 7):
            setattr(self, f"conv{k}_kernel", nn.Parameter(torch.zeros(k, k, dim, dim)))
            setattr(self, f"conv{k}_bias", nn.Parameter(torch.zeros(dim)))
        self.spatial = SpatialAttention()
        self.channel = ChannelAttention(dim)
        self.up = Conv(dim, features, 1)

    def forward(self, x):
        x = conv_nhwc(torch.cat([x, x], dim=-1), self.down_kernel, self.down_bias)
        s = sum(conv_nhwc(x, getattr(self, f"conv{k}_kernel"),
                          getattr(self, f"conv{k}_bias"), padding=k // 2)
                for k in (3, 5, 7))
        s = s * self.spatial(s)
        return self.up(x + s * self.channel(x))


class EdgeEnhancedGRFB(nn.Module):
    def __init__(self, cin, features, v=12):
        super().__init__()
        i = max(cin // 8, 4)
        self.edge_enhancer = EdgeAware(cin)
        self.dir0 = BasicConv(cin, 2 * i, 1)
        self.dir1 = BasicConv(2 * i, 2 * i, 3, padding=v, dilation=v, relu=False)
        self.dir2 = BasicConv(2 * i, 2 * i, 1)
        self.edge0 = BasicConv(cin, i, 1)
        self.edge_eafe = EdgeAware(i)
        self.edge1 = BasicConv(i, 2 * i, 3, padding=1, groups=i)
        self.edge2 = BasicConv(2 * i, 2 * i, 3, padding=2 * v, dilation=2 * v, relu=False)
        self.edge3 = BasicConv(2 * i, 2 * i, 1)
        self.ctx0 = BasicConv(cin, i, 3, padding=1)
        self.ctx1 = BasicConv(i, 2 * i, 3, padding=1, groups=2)
        self.ctx2 = BasicConv(2 * i, 2 * i, 3, padding=3 * v, dilation=3 * v, relu=False)
        self.ctx3 = BasicConv(2 * i, 2 * i, 1)
        self.fusion = FusionConv(cin + 6 * i, features)
        self.shortcut = BasicConv(cin, features, 1, relu=False)
        self.target_enhancer = Conv(features, 3, 3, padding=1)

    def forward(self, x):
        xe = self.edge_enhancer(x)
        d = self.dir2(self.dir1(self.dir0(xe)))
        e = self.edge3(self.edge2(self.edge1(self.edge_eafe(self.edge0(xe)))))
        c = self.ctx3(self.ctx2(self.ctx1(self.ctx0(xe))))
        out = self.fusion(torch.cat([x, d, e, c], dim=-1))
        out = F.relu(out * 0.1 + self.shortcut(x))
        tw = torch.sigmoid(self.target_enhancer(out))
        return out * (1.0 + tw.mean(dim=-1, keepdim=True))


class GRFB(nn.Module):
    def __init__(self, cin, features, v=12):
        super().__init__()
        i = cin // 8
        specs = {
            "b0": [(cin, 2 * i, 1, {}), (2 * i, 2 * i, 3, dict(padding=v, dilation=v, relu=False)),
                   (2 * i, 2 * i, 1, {})],
            "b1": [(cin, i, 1, {}), (i, 2 * i, 3, dict(padding=1, groups=i)),
                   (2 * i, 2 * i, 1, {}),
                   (2 * i, 2 * i, 3, dict(padding=2 * v, dilation=2 * v, relu=False)),
                   (2 * i, 2 * i, 1, {})],
            "b2": [(cin, i, 1, {}), (i, 2 * i, 3, dict(padding=1, groups=i)),
                   (2 * i, 2 * i, 1, {}), (2 * i, 2 * i, 3, dict(padding=1, groups=2 * i)),
                   (2 * i, 2 * i, 1, {}),
                   (2 * i, 2 * i, 3, dict(padding=3 * v, dilation=3 * v, relu=False)),
                   (2 * i, 2 * i, 1, {})],
        }
        self.lengths = {b: len(s) for b, s in specs.items()}
        for b, s in specs.items():
            for j, (ci, co, k, kw) in enumerate(s):
                setattr(self, f"{b}_{j}", BasicConv(ci, co, k, **kw))
        self.conv_linear = BasicConv(cin + 6 * i, features, 1, relu=False)
        self.shortcut = BasicConv(cin, features, 1, relu=False)

    def forward(self, x):
        outs = [x]
        for b, n in self.lengths.items():
            y = x
            for j in range(n):
                y = getattr(self, f"{b}_{j}")(y)
            outs.append(y)
        out = self.conv_linear(torch.cat(outs, dim=-1))
        return F.relu(out * 0.1 + self.shortcut(x))


def mca_kernel_size(c: int) -> int:
    t = round(abs((math.log2(c) - 1) / 1.5))
    return max(t if t % 2 else t - 1, 1)


class MCAGate(nn.Module):
    def __init__(self, axis, k):
        super().__init__()
        self.axis = axis
        self.weight = nn.Parameter(torch.zeros(2))
        self.conv = nn.Parameter(torch.zeros(k))

    def forward(self, x):
        dims = tuple(a for a in (1, 2, 3) if a != self.axis)
        xf = x.float()
        avg = xf.mean(dim=dims)
        std = xf.std(dim=dims, correction=1)
        sw = torch.sigmoid(self.weight)
        b = 0.5 * (avg + std) + sw[0] * avg + sw[1] * std
        k = self.conv.shape[0]
        y = F.conv1d(b[:, None, :], self.conv.float()[None, None, :], padding=(k - 1) // 2)
        return torch.sigmoid(y[:, 0, :])


class MCALayer(nn.Module):
    """Three coordinate gates averaged onto x, then
    0.4 xo + 0.2 (max3 - min3) + 0.2 var3 + 0.1 * 1.1 xo + 0.1 shuffle(xo)."""

    def __init__(self, c):
        super().__init__()
        self.h_cw = MCAGate(1, 3)
        self.w_hc = MCAGate(2, 3)
        self.c_hw = MCAGate(3, mca_kernel_size(c))

    def forward(self, x):
        gh, gw, gc = self.h_cw(x), self.w_hc(x), self.c_hw(x)
        xo = x * ((gh[:, :, None, None] + gw[:, None, :, None] + gc[:, None, None, :])
                  / 3.0).to(x.dtype)
        rng = max3(xo) + max3(-xo)
        var = avg3((xo - avg3(xo)) ** 2)
        b, h, w, c = xo.shape
        shuf = xo.reshape(b, h, w, 4, c // 4).transpose(-1, -2).reshape(b, h, w, c)
        return 0.4 * xo + 0.2 * rng + 0.2 * var + 0.1 * (1.1 * xo) + 0.1 * shuf


class RecursiveGatedAttention(nn.Module):
    """Order-2 recursive gating at the bottleneck, depthwise 3x3, exact GELU."""

    def __init__(self, dim):
        super().__init__()
        split = [dim // 2, dim // 2]
        self.split = split
        total = sum(split)
        self.proj_in = Conv(dim, split[0] + total, 1)
        self.scale = nn.Parameter(torch.ones(()))
        self.dwconv = Conv(total, total, 3, padding=1, groups=total)
        for i, size in enumerate(split):
            setattr(self, f"gate{i}_down", Conv(size, max(size // 8, 8), 1))
            setattr(self, f"gate{i}_up", Conv(max(size // 8, 8), 1, 1))
            if i < len(split) - 1:
                setattr(self, f"transform{i}", Conv(size, split[i + 1], 1))
        self.proj_out = Conv(split[-1], dim, 1)

    def forward(self, x):
        f = self.proj_in(x)
        out, gates = f[..., :self.split[0]], f[..., self.split[0]:]
        gates = self.dwconv(gates) * self.scale
        off = 0
        for i, size in enumerate(self.split):
            g = gates[..., off:off + size]
            off += size
            gm = F.gelu(getattr(self, f"gate{i}_down")(g))
            out = out * torch.sigmoid(getattr(self, f"gate{i}_up")(gm))
            if i < len(self.split) - 1:
                out = getattr(self, f"transform{i}")(out)
        return self.proj_out(out)


class Down(nn.Module):
    """ConvBNReLU [-> MCALayer] -> ConvBNReLU -> EGRFB or GRFB."""

    def __init__(self, cin, c, block, use_mca):
        super().__init__()
        self.conv1 = ConvBNReLU(cin, c)
        self.mca = MCALayer(c) if use_mca else None
        self.conv2 = ConvBNReLU(c, c)
        self.egrfb = EdgeEnhancedGRFB(c, c) if block == "edge" else None
        self.grfb = GRFB(c, c) if block == "grfb" else None

    def forward(self, x):
        x = self.conv1(x)
        if self.mca is not None:
            x = self.mca(x)
        x = self.conv2(x)
        for blk in (self.egrfb, self.grfb):
            if blk is not None:
                x = blk(x)
        return x


class Up(nn.Module):
    def __init__(self, in1, in2, features):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(in1 + in2, features, (in1 + in2) // 2)

    def forward(self, x1, x2):
        x1 = upsample2x(x1)
        dy, dx = x2.shape[1] - x1.shape[1], x2.shape[2] - x1.shape[2]
        x1 = F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return self.DoubleConv_0(torch.cat([x2, x1], dim=-1))


VARIANTS = {"egm_unet": ("edge", True, True), "grfb_unet": ("grfb", False, False)}


class UNetReference(nn.Module):
    """``name``: ``"egm_unet"`` (A+B+C) or ``"grfb_unet"``.  Input NHWC;
    returns float logits NHWC."""

    def __init__(self, name: str = "egm_unet", base_c: int = 32, num_classes: int = 2):
        super().__init__()
        block, rga, mca = VARIANTS[name]
        c = base_c
        self.in_conv = DoubleConv(3, c)
        self.down1 = Down(c, 2 * c, block, mca)
        self.down2 = Down(2 * c, 4 * c, block, mca)
        self.down3 = Down(4 * c, 8 * c, block, mca)
        self.down4 = Down(8 * c, 8 * c, block, mca)
        self.attn1 = RecursiveGatedAttention(8 * c) if rga else None
        self.up1 = Up(8 * c, 8 * c, 4 * c)
        self.up2 = Up(4 * c, 4 * c, 2 * c)
        self.up3 = Up(2 * c, 2 * c, c)
        self.up4 = Up(c, c, c)
        self.out_conv = Conv(c, num_classes, 1)

    def forward(self, x):
        pool = lambda t: pool_nhwc(F.max_pool2d, t, 2)  # noqa: E731
        x1 = self.in_conv(x)
        x2 = self.down1(pool(x1))
        x3 = self.down2(pool(x2))
        x4 = self.down3(pool(x3))
        x5 = self.down4(pool(x4))
        if self.attn1 is not None:
            x5 = self.attn1(x5)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        return self.out_conv(self.up4(x, x1))


def build(name: str, base_c: int, num_classes: int, state: Optional[dict] = None,
          device=None) -> UNetReference:
    """The reference on ``device`` with ``state`` loaded strictly, in eval
    mode."""
    with torch.device(device or "cpu"):
        model = UNetReference(name, base_c, num_classes)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model.eval()
