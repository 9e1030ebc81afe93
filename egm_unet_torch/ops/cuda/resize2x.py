"""2x bilinear ``align_corners=True`` upsample, NHWC (kernel K4): the UNet
decoder's ``nn.Upsample(scale_factor=2, align_corners=True)``.

Replaces ``egm_unet_tpu/ops/pallas/resize2x.py::upsample2x_fused``.  What that
kernel computes, and so what both functions here compute: the W axis first,
each output column a blend of its two source columns in float32 with the
float32 rows of the interpolation matrix, the result rounded to the working
dtype; then the H axis, each output row a blend of its two source rows with
the same matrix's rows rounded to the working dtype, summed in float32 and
rounded once.  A tap of weight zero is left out of the sum.  This is not the
rounding profile of ``ops.resize._apply_separable`` (rows first, both
matrices rounded), so in bfloat16 the two upsamples differ by a few rounding
steps, in float32 by summation order only.

Device-memory bandwidth bounds the work.  The CUDA kernel
(``csrc/upsample2x.cu``) makes 16 bytes of one output pixel per thread from
four 16-byte reads; any H, W and C.

``upsample2x_fused`` launches the kernel for CUDA tensors and runs
``upsample2x_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, check_activation,
                                            stream_handle)
from egm_unet_torch.ops.resize import upsample2x_taps

launches = 0  # kernel launches since the last reset

_P = ctypes.c_void_p
_I = ctypes.c_int


def _blend_axis(x: torch.Tensor, axis: int, taps) -> torch.Tensor:
    """Two-tap blend of the float32 tensor ``x`` along ``axis``; the second
    tap joins the sum only where its weight is not zero."""
    lo, hi, w_lo, w_hi = taps
    shape = [1] * x.ndim
    shape[axis] = -1
    w_lo, w_hi = w_lo.view(shape), w_hi.view(shape)
    second = x.index_select(axis, hi) * w_hi
    return x.index_select(axis, lo) * w_lo + torch.where(
        w_hi != 0, second, torch.zeros((), dtype=x.dtype, device=x.device))


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (gathers and elementwise
    products, the kernel's own order of roundings)."""
    dtype = x.dtype
    cols = upsample2x_taps(x.shape[2], torch.float32, x.device)
    rows = upsample2x_taps(x.shape[1], dtype, x.device)
    y = _blend_axis(x.float(), 2, cols).to(dtype).float()
    return _blend_axis(y, 1, rows).to(dtype)


def upsample2x_fused(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) contiguous, float32 or bfloat16 -> (B, 2H, 2W, C)."""
    global launches
    check_activation("x", x)
    if x.device.type == "cpu":
        return upsample2x_plain(x)
    b, h, w, c = x.shape
    out = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rows = upsample2x_taps(h, x.dtype, x.device)
    cols = upsample2x_taps(w, torch.float32, x.device)
    lib = build.load("upsample2x")
    fn = lib.egm_upsample2x
    fn.argtypes = [_P] * 10 + [_I] * 5 + [_P]
    fn.restype = _I
    err = fn(x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in rows),
             *(t.data_ptr() for t in cols), b, h, w, c, DTYPE_CODES[x.dtype],
             stream_handle(x.device))
    build.check_launch(err, "upsample2x_fused")
    launches += 1
    return out
