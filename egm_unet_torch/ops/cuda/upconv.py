"""Fused decoder stage ``relu(conv3x3(concat([x2, up2x(x1)]), W) + b)``
(kernel K5).

Replaces ``egm_unet_tpu/ops/pallas/upconv.py::up_concat_conv``
(``csrc/up_concat_conv.cu``): the implicit GEMM of the 3x3 conv with
K = 9*(C2 + C1), channels ``[0, C2)`` read from x2 and ``[C2, C2+C1)`` blended
from the 2x2 align_corners taps of x1, so the concat and the upsampled tensor
are never stored.  The taps come from the same interpolation matrix as
``upsample2x_bilinear_align_corners`` (``ops/resize.py::upsample2x_taps``) and
are rounded to the working dtype, and the blend rounds after the row pass and
after the column pass, as the plain two-matmul upsample does.
``upconv_variant`` names the kernel a dtype gets:

- ``"mma_bf16"`` (bfloat16): the tensor-core stage of ``csrc/igemm_mma.cuh``
  walking K in 16-channel steps, first x2's halo chunks, then chunks of x1's
  low-resolution patch that a producer step blends into the A tile in shared
  memory; ``upconv_tile`` picks the tile (resident weights and persistent
  blocks where they fit, the TMA unit's tiles for aligned tensors with channel
  counts that are multiples of 8, ``cp.async`` / scalar loads otherwise).
- ``"cuda_cores_f32"`` (float32): the CUDA-core implicit GEMM of
  ``csrc/common.cuh`` with a loader that blends the taps per use.

``up_concat_conv`` launches the kernel for CUDA tensors and runs
``up_concat_conv_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, check_activation,
                                            check_no_autograd,
                                            check_same_device, stream_handle)
from egm_unet_torch.ops.cuda.conv3x3 import (CONV_MODES, CONV_RESIDENT_CHUNKS,
                                             PAIR_CC, PAIR_RESIDENT_LIMIT, _up,
                                             conv3x3_plain, conv3x3_variant,
                                             cuda_core_tile, resident_weights,
                                             ring_slot)
from egm_unet_torch.ops.resize import (upsample2x_bilinear_align_corners,
                                       upsample2x_taps)

_UPCONV = build.Entry("up_concat_conv", "up_concat_conv", "egm_up_concat_conv",
                      "p" * 13 + "i" * 11 + "p")



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


def upconv_variant(dtype: torch.dtype) -> str:
    """The kernel ``up_concat_conv`` launches for CUDA tensors of ``dtype``:
    ``"mma_bf16"`` (tensor cores) or ``"cuda_cores_f32"``."""
    return conv3x3_variant(dtype)


def _chunks(c2: int, c1: int) -> int:
    """16-channel steps of K5: each half pads its own last chunk."""
    return -(-c2 // PAIR_CC) + -(-c1 // PAIR_CC)


def upconv_smem_bytes(tile: tuple, c2: int, c1: int, co: int, itemsize: int) -> int:
    """Shared memory of one block of K5 at ``tile`` = (TH, TW, BN, mode), as
    ``csrc/up_concat_conv.cu`` lays it out: the ring of K2's stage (its slots
    also hold the x1 patch, which is smaller than the halo), the blended A
    grid, and resident weights (float32: the CUDA-core kernel's staging)."""
    th, tw, bn, mode = tile
    if itemsize == 4:
        return 4 * 16 * (tw + 4 + bn)
    halo = (th + 2) * (tw + 2)
    xbuf, wtile, ring = ring_slot(th, tw, bn, mode)
    abuf = _up(halo * PAIR_CC, 512) if mode == "tma" else halo * (PAIR_CC + 8)
    n = ring * (xbuf + wtile) + abuf
    if mode == "resident":
        n += resident_weights(_chunks(c2, c1), co, bn)
    return 2 * n + (1024 if mode == "tma" else 0)


def upconv_tile(c2: int, c1: int, co: int, itemsize: int, aligned: bool = True) -> tuple:
    """``(TH, TW, BN, mode)`` of K5 for the widths C2 + C1 -> Co.  bfloat16:
    8x16 pixel tiles; all weights resident (``"resident"``) in the narrowest
    chunk of ``CONV_RESIDENT_CHUNKS`` covering Co where they fit
    ``PAIR_RESIDENT_LIMIT``; else 64-column chunks where Co <= 64 and 128
    above, filled by the TMA unit (``"tma"``) where C2, C1 and Co are
    multiples of 8 and x2, x1, the weights lie on 16-byte boundaries
    (``aligned``), by ``cp.async`` or scalar loads (``"async"``) otherwise.
    float32: ``conv3x3.cuda_core_tile``."""
    if itemsize == 4:
        return cuda_core_tile(co)
    for bn in CONV_RESIDENT_CHUNKS:
        if co <= bn:
            tile = (8, 16, bn, "resident")
            if upconv_smem_bytes(tile, c2, c1, co, itemsize) <= PAIR_RESIDENT_LIMIT:
                return tile
            break
    tma = aligned and c2 % 8 == 0 and c1 % 8 == 0 and co % 8 == 0
    return (8, 16, 64 if co <= 64 else 128, "tma" if tma else "async")


def upconv_patch(tile: int) -> int:
    """Pixels along one axis of the x1 patch that ``tile`` output pixels and
    their one-pixel halo read (``csrc/up_concat_conv.cu::patch_extent``):
    align_corners maps output i to i*(n-1)/(2n-1) < i/2, so ``tile + 2``
    outputs span less than half as many inputs, plus the first floor's
    neighbour and the last floor's."""
    return (tile + 2) // 2 + 2


def upconv_flops(x2_shape, c1: int, co: int, itemsize: int) -> tuple:
    """``(needed, executed)`` FLOPs of one K5 call with x2 of ``x2_shape`` =
    (B, H, W, C2): the conv's, and what the kernel runs with whole tiles, N
    padded to the column chunk and each half's channels to 16 (float32: M to
    BM, N to BN, K = 9*(C2 + C1) to 16)."""
    b, h, w, c2 = x2_shape
    needed = 2.0 * b * h * w * 9 * (c2 + c1) * co
    th, tw, bn, _ = upconv_tile(c2, c1, co, itemsize)
    if itemsize == 4:
        return needed, 2.0 * _up(b * h * w, tw) * _up(co, bn) * _up(9 * (c2 + c1), 16)
    tiles = b * -(-h // th) * -(-w // tw)
    return needed, 2.0 * tiles * th * tw * _up(co, bn) * 9 * PAIR_CC * _chunks(c2, c1)


def up_concat_conv(x2: torch.Tensor, x1: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """x1 (B, h, w, C1), x2 (B, 2h, 2w, C2), contiguous, one dtype (float32
    or bfloat16); kernel (3, 3, C2+C1, Co) HWIO; bias (Co,), rounded to the
    working dtype and added in float32."""
    _check(x2, x1, kernel, bias)
    check_no_autograd("up_concat_conv", x2, x1, kernel, bias)
    if x1.device.type == "cpu":
        return up_concat_conv_plain(x2, x1, kernel, bias)
    b, h, w, c1 = x1.shape
    c2 = x2.shape[-1]
    co = kernel.shape[-1]
    kq = kernel.to(x1.dtype).contiguous()
    bq = bias.to(x1.dtype).float().contiguous()
    out = torch.empty((b, 2 * h, 2 * w, co), dtype=x1.dtype, device=x1.device)
    if out.numel() == 0:
        return out
    th, tw, bn, mode = upconv_tile(
        c2, c1, co, x1.element_size(),
        aligned=all(t.data_ptr() % 16 == 0 for t in (x2, x1, kq)))
    rows = upsample2x_taps(h, x1.dtype, x1.device)
    cols = upsample2x_taps(w, x1.dtype, x1.device)
    _UPCONV(x2.data_ptr(), x1.data_ptr(), kq.data_ptr(), bq.data_ptr(),
            out.data_ptr(), *(t.data_ptr() for t in rows),
            *(t.data_ptr() for t in cols), b, h, w, c1, c2, co, th, tw, bn,
            CONV_MODES[mode], DTYPE_CODES[x1.dtype], stream_handle(x1.device))
    return out
