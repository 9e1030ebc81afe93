"""The EdgeAwareFeatureEnhancer's edge map (kernel K8): ``x - avg3x3(x)``.

Replaces no TPU kernel: the JAX package computes the edge in plain jnp
(``egm_unet_tpu/nn/layers.py::EdgeAwareFeatureEnhancer``).  ``avg3x3`` is the
mean of a 3x3 window at stride 1 with zero padding 1 that counts in the mean
(``count_include_pad=True``, divisor 9).  Per element the window is summed
in float32, row by row and left to right from 0, divided by 9 and rounded to
the map's dtype (``avg_pool2d``'s output), and subtracted from x in float32
and rounded again: the composite's arithmetic, so the kernel gives
``eafe_edge_plain``'s bits.

One read of x and one write bound the function.  The CUDA kernel
(``csrc/eafe_edge.cu``) gives each block a band of R rows by a tile of TW
pixels of one image; it stages each input row of the tile and its two halo
columns in a ring of shared-memory rows, ``PF`` rows ahead, and each thread
sums the 9 units of its window there.  Rows and columns outside the image are
zero-filled.  ``eafe_edge_variant`` names the kernel a call launches:
``"vec16"`` (16-byte units: 8 bfloat16 or 4 float32 channels) where C % 8 ==
0 and x lies on the 16-byte grid, else ``"scalar"`` (one channel a unit).
``eafe_edge_tile``, ``eafe_edge_bands`` and ``eafe_edge_smem_bytes`` repeat
the kernel's split and its shared memory for the host-side tests.

``eafe_edge`` launches the kernel for CUDA tensors and runs
``eafe_edge_plain``, the composite ``x - avg_pool2d(x, 3, 1, 1)``, for CPU
tensors.  The plain version is also the route of the training graph and of a
map split by rows over a spatial group (its pool fetches the halo rows).
"""

from __future__ import annotations

import torch

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, SMEM_LIMIT, check_activation,
                                            check_no_autograd, sm_count, stream_handle)
from egm_unet_torch.ops.pooling import avg_pool2d
from egm_unet_torch.parallel.mesh import spatial

_EDGE = build.Entry("eafe_edge", "eafe_edge", "egm_eafe_edge", "pp" + "i" * 8 + "p")

TILE_UNITS = 512  # units of a tile's row, at most
PF = 2  # staged rows in flight past the computed window
SLOTS = PF + 3  # shared-memory rows of the ring
BAND_MIN, BAND_MAX = 8, 32  # rows of a band
BLOCKS_PER_SM = 8  # blocks the band choice aims for, an SM



def eafe_edge_plain(x: torch.Tensor) -> torch.Tensor:
    """``x - avg_pool2d(x, 3, 1, 1)`` in plain PyTorch (NHWC, the pool's
    zero padding counted in the mean)."""
    return x - avg_pool2d(x, 3, 1, 1)


def eafe_edge_variant(dtype: torch.dtype, c: int, aligned: bool = True) -> str:
    """The kernel ``eafe_edge`` runs for CUDA tensors of ``dtype`` with C
    channels: ``"vec16"`` where C % 8 == 0 and x lies on a 16-byte boundary
    (``aligned``), else ``"scalar"``."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    return "vec16" if c % 8 == 0 and aligned else "scalar"


def eafe_edge_unit(dtype: torch.dtype, variant: str) -> int:
    """Channels a unit: 16 bytes' worth in ``"vec16"``, else 1."""
    if variant == "scalar":
        return 1
    return 16 // torch.empty((), dtype=dtype).element_size()


def eafe_edge_tile(w: int, cv: int) -> tuple:
    """(TW, tiles): the fewest tiles whose rows hold at most ``TILE_UNITS``
    units (at least a pixel) at ``cv`` units a pixel, as even as they go."""
    tiles = -(-w // max(1, TILE_UNITS // cv))
    tw = -(-w // tiles)
    return tw, -(-w // tw)


def eafe_edge_bands(h: int, tiles: int, b: int, sms: int) -> tuple:
    """(R, bands): enough bands for ``BLOCKS_PER_SM`` blocks an SM over the
    grid (tiles, bands, b), of ``BAND_MIN`` to ``BAND_MAX`` rows where H
    allows, as even as they go."""
    want = -(-BLOCKS_PER_SM * sms // (tiles * b))
    bands = max(want, -(-h // BAND_MAX))
    bands = max(1, min(bands, -(-h // BAND_MIN), h))
    r = -(-h // bands)
    return r, -(-h // r)


def eafe_edge_smem_bytes(tw: int, c: int, itemsize: int) -> int:
    """Dynamic shared memory of a block: ``SLOTS`` staged rows of TW + 2
    pixels."""
    return SLOTS * (tw + 2) * c * itemsize


def eafe_edge(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) contiguous, float32 or bfloat16: ``x - avg3x3(x)`` in
    x's dtype."""
    check_activation("x", x)
    check_no_autograd("eafe_edge", x)
    if x.device.type == "cpu":
        return eafe_edge_plain(x)
    if spatial() is not None:
        raise ValueError("eafe_edge takes whole images; under a spatial group the edge "
                         "takes the plain route (eafe_edge_plain)")
    b, h, w, c = x.shape
    if h * w * c >= 2 ** 31:
        raise ValueError(f"x of shape {tuple(x.shape)}: the kernel indexes an image's "
                         "elements with 32-bit integers")
    if b > 65535:
        raise ValueError(f"the kernel takes at most 65535 images, got {b}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    variant = eafe_edge_variant(x.dtype, c, x.data_ptr() % 16 == 0)
    uc = eafe_edge_unit(x.dtype, variant)
    tw, tiles = eafe_edge_tile(w, c // uc)
    if eafe_edge_smem_bytes(tw, c, x.element_size()) > SMEM_LIMIT:
        raise ValueError(f"C = {c} needs more shared memory than a block has")
    r, _ = eafe_edge_bands(h, tiles, b, sm_count(x.device))
    _EDGE(x.data_ptr(), out.data_ptr(), b, h, w, c, 16 if variant == "vec16" else 1,
          tw, r, DTYPE_CODES[x.dtype], stream_handle(x.device))
    return out
