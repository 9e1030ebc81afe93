"""Fused decoder stage ``relu(conv3x3(concat([x2, up2x(x1)]), W) + b)``
(kernel K5).

Replaces ``egm_unet_tpu/ops/pallas/upconv.py::up_concat_conv``.  The CUDA
kernel (``csrc/up_concat_conv.cu``) is the implicit GEMM of the 3x3 conv
whose input loader reads channels ``[0, C2)`` from x2 and blends channels
``[C2, C2+C1)`` from the 2x2 align_corners taps of x1, so the concat and the
upsampled tensor are never stored.  The taps come from the same
interpolation matrix as ``upsample2x_bilinear_align_corners`` and are
rounded to the working dtype, and the blend rounds after the row pass and
after the column pass, as the plain two-matmul upsample does.  The
tensor-core rate bounds the work at the path's widths; this version runs on
the CUDA cores (see PERF.md).

``up_concat_conv`` launches the kernel for CUDA tensors and runs
``up_concat_conv_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, check_activation,
                                            check_same_device, stream_handle)
from egm_unet_torch.ops.cuda.conv3x3 import conv3x3_plain
from egm_unet_torch.ops.resize import (upsample2x_bilinear_align_corners,
                                       upsample2x_taps)

launches = 0  # kernel launches since the last reset

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check(x2, x1, kernel, bias):
    check_activation("x2", x2)
    check_activation("x1", x1)
    b, h, w, c1 = x1.shape
    b2, hh, ww, c2 = x2.shape
    if b2 != b or hh != 2 * h or ww != 2 * w:
        raise ValueError(f"x2 must be ({b}, {2 * h}, {2 * w}, C2) for x1 of "
                         f"shape {tuple(x1.shape)}, got {tuple(x2.shape)}")
    if x1.dtype != x2.dtype:
        raise TypeError(f"x1 and x2 dtypes differ: {x1.dtype} vs {x2.dtype}")
    if kernel.ndim != 4 or tuple(kernel.shape[:3]) != (3, 3, c2 + c1):
        raise ValueError(f"kernel must be (3, 3, {c2 + c1}, Co) HWIO, got "
                         f"{tuple(kernel.shape)}")
    if tuple(bias.shape) != (kernel.shape[-1],):
        raise ValueError(f"bias must be ({kernel.shape[-1]},), got "
                         f"{tuple(bias.shape)}")
    check_same_device(("x2", x2), ("x1", x1), ("kernel", kernel),
                      ("bias", bias))


def up_concat_conv_plain(x2: torch.Tensor, x1: torch.Tensor,
                         kernel: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: two-matmul upsample, concat,
    conv with float32 accumulation."""
    up = upsample2x_bilinear_align_corners(x1)
    cat = torch.cat([x2, up], dim=-1)
    return conv3x3_plain(cat, kernel, bias.to(x1.dtype), relu=True)


def up_concat_conv(x2: torch.Tensor, x1: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """x1 (B, h, w, C1), x2 (B, 2h, 2w, C2), contiguous, one dtype (float32
    or bfloat16); kernel (3, 3, C2+C1, Co) HWIO; bias (Co,), rounded to the
    working dtype and added in float32."""
    global launches
    _check(x2, x1, kernel, bias)
    if x1.device.type == "cpu":
        return up_concat_conv_plain(x2, x1, kernel, bias)
    b, h, w, c1 = x1.shape
    c2 = x2.shape[-1]
    co = kernel.shape[-1]
    kq = kernel.to(x1.dtype).contiguous()
    bq = bias.to(x1.dtype).float().contiguous()
    rows = upsample2x_taps(h, x1.dtype, x1.device)
    cols = upsample2x_taps(w, x1.dtype, x1.device)
    out = torch.empty((b, 2 * h, 2 * w, co), dtype=x1.dtype, device=x1.device)
    lib = build.load("up_concat_conv")
    fn = lib.egm_up_concat_conv
    fn.argtypes = [_P] * 13 + [_I] * 7 + [_P]
    fn.restype = _I
    err = fn(x2.data_ptr(), x1.data_ptr(), kq.data_ptr(), bq.data_ptr(),
             out.data_ptr(), *(t.data_ptr() for t in rows),
             *(t.data_ptr() for t in cols), b, h, w, c1, c2, co,
             DTYPE_CODES[x1.dtype], stream_handle(x1.device))
    build.check_launch(err, "up_concat_conv")
    launches += 1
    return out
