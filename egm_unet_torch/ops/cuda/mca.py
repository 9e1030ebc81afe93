"""Fused MCALayer enhancement (kernel K1).

Replaces ``egm_unet_tpu/ops/pallas/mca.py::mca_fused``.  After the three
gate vectors, one pass computes

    x_out = x * (g_h + g_w + g_c) / 3           (rounded to x's dtype)
    out   = 0.4 x_out + 0.2 (max3 - min3) + 0.2 avg3((x_out - avg3 x_out)^2)
          + 0.1 (1.1 x_out) + 0.1 shuffle(x_out)

Device-memory bandwidth bounds it (about 40 flops per element).  The CUDA
kernel (``csrc/mca_fused.cu``) reads x once into a shared-memory halo tile,
gated on the way in, and writes the output once.

``mca_fused`` launches the kernel for CUDA tensors and runs ``mca_plain``
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, check_activation,
                                            check_same_device, stream_handle)
from egm_unet_torch.ops.shuffle import channel_shuffle

launches = 0  # kernel launches since the last reset

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check(x, g_h, g_w, g_c, groups):
    check_activation("x", x)
    b, h, w, c = x.shape
    for name, g, n in (("g_h", g_h, h), ("g_w", g_w, w), ("g_c", g_c, c)):
        if tuple(g.shape) != (b, n):
            raise ValueError(f"{name} must be ({b}, {n}), got {tuple(g.shape)}")
        if g.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {g.dtype}")
        if not g.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    check_same_device(("x", x), ("g_h", g_h), ("g_w", g_w), ("g_c", g_c))


def _sum9(p: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """3x3 stride-1 window sums of an NCHW tensor padded by 1, in (di, dj)
    order."""
    out = None
    for di in range(3):
        for dj in range(3):
            t = p[:, :, di:di + h, dj:dj + w]
            out = t if out is None else out + t
    return out


def mca_plain(x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor,
              g_c: torch.Tensor, groups: int = 4) -> torch.Tensor:
    """The kernel's function in plain PyTorch, float32 math."""
    _, h, w, _ = x.shape
    gsum = (g_h.float()[:, :, None, None] + g_w.float()[:, None, :, None]
            + g_c.float()[:, None, None, :]) / 3.0
    xo = (x.float() * gsum).to(x.dtype).float()  # NHWC
    xc = xo.permute(0, 3, 1, 2)
    mx = F.max_pool2d(F.pad(xc, (1, 1, 1, 1), value=float("-inf")), 3, 1)
    mn = -F.max_pool2d(F.pad(-xc, (1, 1, 1, 1), value=float("-inf")), 3, 1)
    mean = _sum9(F.pad(xc, (1, 1, 1, 1)), h, w) / 9.0
    d2 = (xc - mean) ** 2
    var = _sum9(F.pad(d2, (1, 1, 1, 1)), h, w) / 9.0
    shuf = channel_shuffle(xo, groups).permute(0, 3, 1, 2)
    out = (0.4 * xc + 0.2 * (mx - mn) + 0.2 * var + 0.1 * (1.1 * xc)
           + 0.1 * shuf)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def mca_fused(x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor,
              g_c: torch.Tensor, groups: int = 4) -> torch.Tensor:
    """x (B, H, W, C) contiguous, float32 or bfloat16; g_h/g_w/g_c float32
    post-sigmoid gates (B, H)/(B, W)/(B, C)."""
    global launches
    _check(x, g_h, g_w, g_c, groups)
    if x.device.type == "cpu":
        return mca_plain(x, g_h, g_w, g_c, groups)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    lib = build.load("mca_fused")
    fn = lib.egm_mca_fused
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    err = fn(x.data_ptr(), g_h.data_ptr(), g_w.data_ptr(), g_c.data_ptr(),
             out.data_ptr(), b, h, w, c, groups, DTYPE_CODES[x.dtype],
             stream_handle(x.device))
    build.check_launch(err, "mca_fused")
    launches += 1
    return out
