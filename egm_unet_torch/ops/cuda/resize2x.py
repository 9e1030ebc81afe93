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
(``csrc/upsample2x.cu``) gives each block a band of ``UP_BAND_ROWS`` output
rows by a strip of output columns of one image: it stages the input patch
they read in shared memory, blends each input row's two columns once, and
writes each output row with 16-byte stores.  ``upsample_variant`` names the
kernel a call launches: ``"band_cp_async"`` (16-byte vectors) where C fills
whole 16-byte vectors and x and out are 16-byte aligned, else
``"band_scalar"``; any H, W and C.  ``upsample_tile``, ``upsample_patch`` and
``upsample_smem_bytes`` repeat the kernel's tiling for the host-side tests.

``upsample2x_fused`` launches the kernel for CUDA tensors and runs
``upsample2x_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, check_activation,
                                            check_no_autograd,
                                            stream_handle)
from egm_unet_torch.ops.resize import linear_taps, upsample2x_taps

_UP = build.Entry("upsample2x_fused", "upsample2x", "egm_upsample2x", "p" * 10 + "i" * 7 + "p")

UP_BAND_ROWS = 16  # output rows of a block's band
UP_THREADS = 256



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


def upsample_variant(dtype: torch.dtype, c: int, aligned: bool = True) -> str:
    """The kernel ``upsample2x_fused`` launches for CUDA tensors of
    ``dtype`` with C channels: ``"band_cp_async"`` where C is a multiple of
    the 16-byte vector (8 bfloat16, 4 float32) and x and out lie on 16-byte
    boundaries (``aligned``), else ``"band_scalar"``."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return "band_cp_async" if c % vec == 0 and aligned else "band_scalar"


def upsample_tile(c: int, itemsize: int, aligned: bool = True) -> tuple:
    """``(BR, BQ, VEC)``: output rows of a band, output columns of a strip
    (as many as give every thread one vector of one column, at least one),
    and channels per vector."""
    vec = 16 // itemsize
    if c % vec or not aligned:
        vec = 1
    return UP_BAND_ROWS, max(1, UP_THREADS // (c // vec)), vec


def patch_max(n: int) -> int:
    """Input rows (or columns) that n consecutive outputs of a 2x
    align_corners upsample read, at most (``csrc/upsample2x.cu::patch_max``)."""
    return (n - 1) // 2 + 3


def upsample_patch(n_in: int, start: int, count: int) -> tuple:
    """``(first input index, count)`` of the input rows (or columns) that the
    outputs [start, start + count) read, from the taps the kernel is given."""
    lo, hi, _, _ = linear_taps(n_in, 2 * n_in, True)
    return int(lo[start]), int(hi[start + count - 1] - lo[start] + 1)


def upsample_smem_bytes(tile: tuple, c: int, itemsize: int) -> int:
    """Shared memory of one block: the band's and the strip's taps (16 bytes
    each), then the largest input patch, ``patch_max(BR) x patch_max(BQ)``
    pixels of C channels."""
    br, bq, _ = tile
    return 16 * (br + bq) + patch_max(br) * patch_max(bq) * c * itemsize


def upsample2x_fused(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) contiguous, float32 or bfloat16 -> (B, 2H, 2W, C)."""
    check_activation("x", x)
    check_no_autograd("upsample2x_fused", x)
    if x.device.type == "cpu":
        return upsample2x_plain(x)
    b, h, w, c = x.shape
    out = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if 4 * h * w * c >= 2 ** 31:
        raise ValueError(f"one output image holds {4 * h * w * c} elements; the "
                         "kernel indexes an image with 32-bit offsets")
    rows = upsample2x_taps(h, x.dtype, x.device)
    cols = upsample2x_taps(w, torch.float32, x.device)
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    _, bq, vec = upsample_tile(c, x.element_size(), aligned)
    _UP(x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in rows),
        *(t.data_ptr() for t in cols), b, h, w, c, bq, int(vec > 1),
        DTYPE_CODES[x.dtype], stream_handle(x.device))
    return out
