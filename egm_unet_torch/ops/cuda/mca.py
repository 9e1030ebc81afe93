"""Fused MCALayer enhancement (kernel K1).

Replaces ``egm_unet_tpu/ops/pallas/mca.py::mca_fused``.  After the three
gate vectors, one pass computes

    x_out = x * (g_h + g_w + g_c) / 3           (rounded to x's dtype)
    out   = 0.4 x_out + 0.2 (max3 - min3) + 0.2 avg3((x_out - avg3 x_out)^2)
          + 0.1 (1.1 x_out) + 0.1 shuffle(x_out)

Device-memory bandwidth bounds it (about 40 flops per element).  The CUDA
kernel (``csrc/mca_fused.cu``) runs persistent blocks over tiles of
``MCA_TILE`` = 16 x 14 pixels x 32 channels: each tile's 20 x 18 halo and
its shuffle sources arrive as boxes of the TMA unit, its gates by cp.async,
while the SM's other two blocks compute; each halo element is gated once in
shared memory, the window passes walk down columns with their 3x3 windows in
registers, and the output is written once.  ``mca_variant`` names the kernel
a call launches: ``"tile_tma"`` (the TMA boxes, the shuffle sources as
four runs of eight channels) where groups is 4, C % 32 == 0 and x and out
are 16-byte aligned, else ``"tile_scalar"`` (element loads, the shuffle
gathered from device memory).  ``mca_tile_origin``, ``mca_shuffle_runs``
and ``mca_smem_bytes`` repeat the kernel's tile walk, shuffle gather and
shared-memory layout for the host-side tests.

``mca_fused`` launches the kernel for CUDA tensors and runs ``mca_plain``
for CPU tensors.  ``mca_plain`` is also the training graph's enhancement,
and runs on a map split by rows over a spatial group (``parallel/halo.py``)
too: the row above and below of ``x_out`` and of its squared deviations
come from the neighbouring ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, check_activation,
                                            check_no_autograd,
                                            check_same_device, stream_handle)
from egm_unet_torch.ops.shuffle import channel_shuffle
from egm_unet_torch.parallel.halo import halo, image_rows
from egm_unet_torch.parallel.mesh import spatial

_MCA = build.Entry("mca_fused", "mca_fused", "egm_mca_fused", "p" * 5 + "i" * 7 + "p")

MCA_TILE = (16, 14, 32)  # rows, columns, channels of a tile



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
    sp = spatial()
    if sp is None:
        mx = F.max_pool2d(F.pad(xc, (1, 1, 1, 1), value=float("-inf")), 3, 1)
        mn = -F.max_pool2d(F.pad(-xc, (1, 1, 1, 1), value=float("-inf")), 3, 1)
        mean = _sum9(F.pad(xc, (1, 1, 1, 1)), h, w) / 9.0
        d2 = (xc - mean) ** 2
        var = _sum9(F.pad(d2, (1, 1, 1, 1)), h, w) / 9.0
    else:  # this rank's rows; the rows around them from its neighbours
        xe = halo(xc, 1, axis=2)  # zero outside the image
        lo, hi = sp.rows
        inside = image_rows(lo - 1, hi + 1, sp.height, x.device)[None, None, :, None]
        inf = torch.tensor(float("inf"), device=x.device)
        mx = F.max_pool2d(F.pad(torch.where(inside, xe, -inf), (1, 1, 0, 0),
                                value=float("-inf")), 3, 1)
        mn = -F.max_pool2d(F.pad(torch.where(inside, -xe, -inf), (1, 1, 0, 0),
                                 value=float("-inf")), 3, 1)
        mean = _sum9(F.pad(xe, (1, 1, 0, 0)), h, w) / 9.0
        d2 = (xc - mean) ** 2
        var = _sum9(F.pad(halo(d2, 1, axis=2), (1, 1, 0, 0)), h, w) / 9.0
    shuf = channel_shuffle(xo, groups).permute(0, 3, 1, 2)
    out = (0.4 * xc + 0.2 * (mx - mn) + 0.2 * var + 0.1 * (1.1 * xc)
           + 0.1 * shuf)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def mca_variant(dtype: torch.dtype, c: int, groups: int = 4,
                aligned: bool = True) -> str:
    """The kernel ``mca_fused`` launches for CUDA tensors of ``dtype`` with C
    channels: ``"tile_tma"`` where ``groups == 4``, ``c % 32 == 0`` and x
    and out lie on 16-byte boundaries (``aligned``), else ``"tile_scalar"``."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    vec = groups == 4 and c % MCA_TILE[2] == 0 and aligned
    return "tile_tma" if vec else "tile_scalar"


def mca_smem_bytes(itemsize: int) -> int:
    """Shared memory of one block (``csrc/mca_fused.cu::Layout``): the stage
    (the halo, gated in place, and the four shuffle runs in the working
    dtype, the float32 gates of 32 channels, 32 run channels, the halo rows
    and columns, and the tile's origin, four int32), padded to 128 bytes for
    the TMA unit, then the float32 squared deviations of the (TH+2) x (TW+2)
    positions; the mbarrier is static (8 bytes).  Three blocks an SM in
    bfloat16, two in float32."""
    th, tw, cc = MCA_TILE
    stage = ((th + 4) * (tw + 4) * cc * itemsize + th * tw * cc * itemsize
             + 4 * (2 * cc + (th + 4) + (tw + 4)) + 16)
    stage = -(-stage // 128) * 128
    return stage + (th + 2) * (tw + 2) * cc * 4


def mca_tile_count(shape) -> int:
    """Tiles of one call on x of ``shape`` = (B, H, W, C)."""
    b, h, w, c = shape
    th, tw, cc = MCA_TILE
    return b * -(-h // th) * -(-w // tw) * -(-c // cc)


def mca_tile_origin(t: int, shape) -> tuple:
    """``(b, y0, x0, c0)`` of tile ``t``, decoded as the kernel decodes it
    (channel chunk fastest, then columns, rows, images)."""
    _, h, w, c = shape
    th, tw, cc = MCA_TILE
    ncc, ntx, nty = -(-c // cc), -(-w // tw), -(-h // th)
    c0 = t % ncc * cc
    t //= ncc
    x0 = t % ntx * tw
    t //= ntx
    return t // nty, t % nty * th, x0, c0


def mca_shuffle_runs(c: int, c0: int, groups: int = 4):
    """The first source channel of each of the four runs of eight that the
    output channels [c0, c0 + 32) read in the ``tile_tma`` variant
    (output channel c0 + 4 i + k reads run k's element i); None where that
    variant does not apply."""
    if groups != 4 or c % MCA_TILE[2]:
        return None
    return [k * (c // 4) + c0 // 4 for k in range(4)]


def mca_fused(x: torch.Tensor, g_h: torch.Tensor, g_w: torch.Tensor,
              g_c: torch.Tensor, groups: int = 4) -> torch.Tensor:
    """x (B, H, W, C) contiguous, float32 or bfloat16; g_h/g_w/g_c float32
    post-sigmoid gates (B, H)/(B, W)/(B, C)."""
    _check(x, g_h, g_w, g_c, groups)
    check_no_autograd("mca_fused", x, g_h, g_w, g_c)
    if x.device.type == "cpu":
        return mca_plain(x, g_h, g_w, g_c, groups)
    b, h, w, c = x.shape
    if h * w * c >= 2 ** 31:
        raise ValueError(f"one image of x holds {h * w * c} elements; the kernel "
                         "indexes an image with 32-bit offsets")
    out = torch.empty_like(x)
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    vec = mca_variant(x.dtype, c, groups, aligned) == "tile_tma"
    _MCA(x.data_ptr(), g_h.data_ptr(), g_w.data_ptr(), g_c.data_ptr(),
         out.data_ptr(), b, h, w, c, groups, int(vec), DTYPE_CODES[x.dtype],
         stream_handle(x.device))
    return out
