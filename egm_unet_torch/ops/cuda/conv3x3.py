"""3x3 / stride 1 / pad 1 convolution + bias + optional ReLU (kernel K2).

Replaces ``egm_unet_tpu/ops/pallas/conv3x3.py::conv3x3_gemm``.  The CUDA
kernel (``csrc/conv3x3.cu``) is an implicit GEMM over M = B*H*W pixels,
N = Co, K = 9*C with float32 accumulation; zero padding comes from bounds
checks, so no padded copy is written and any C works.  At the path's widths
the tensor-core rate bounds the work; this version multiplies on the CUDA
cores in float32, which leaves it far from that bound (see PERF.md).

``conv3x3_gemm`` launches the kernel for CUDA tensors and runs
``conv3x3_plain`` for CPU tensors; nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, check_activation,
                                            check_same_device, stream_handle)

launches = 0  # kernel launches since the last reset

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check(x, w, b):
    check_activation("x", x)
    c = x.shape[-1]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w must be (3, 3, {c}, Co) HWIO, got {tuple(w.shape)}")
    co = w.shape[-1]
    if b is not None and tuple(b.shape) != (co,):
        raise ValueError(f"b must be ({co},), got {tuple(b.shape)}")
    check_same_device(("x", x), ("w", w), ("b", b))


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *,
                  relu: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 products of the
    working-dtype operands, float32 bias and ReLU, one rounding at the end."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.to(x.dtype).float().permute(3, 2, 0, 1),
                 None if b is None else b.float(), padding=1)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3_gemm(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *,
                 relu: bool = False) -> torch.Tensor:
    """x (B, H, W, C) contiguous, float32 or bfloat16; w (3, 3, C, Co) HWIO,
    cast to x's dtype; b (Co,) or None, added in float32."""
    global launches
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu=relu)
    bsz, h, wd, c = x.shape
    co = w.shape[-1]
    wq = w.to(x.dtype).contiguous()
    bq = None if b is None else b.float().contiguous()
    out = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=x.device)
    lib = build.load("conv3x3")
    fn = lib.egm_conv3x3
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    err = fn(x.data_ptr(), wq.data_ptr(), None if bq is None else bq.data_ptr(),
             out.data_ptr(), bsz, h, wd, c, co, int(relu), DTYPE_CODES[x.dtype],
             stream_handle(x.device))
    build.check_launch(err, "conv3x3_gemm")
    launches += 1
    return out
