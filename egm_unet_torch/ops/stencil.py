"""Fixed 3x3 edge stencils (Laplacian, Sobel) as single-channel convolutions
with zero padding 1 (port of ``egm_unet_tpu/ops/stencil.py``); they back the
reference's edge-aware training losses (``losses.py``).

- ``LAPLACE4``: 4-neighbour Laplacian of ``laplace_loss``.
- ``LAPLACE8``: 8-neighbour Laplacian of ``lap_loss``.
- ``SOBEL_X`` / ``SOBEL_Y``: Sobel responses of ``sobel_loss``.

Under a spatial group (``parallel.use_spatial_group``) the input is this
rank's rows, and the row above and below come from the neighbouring ranks
(zero outside the image).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from egm_unet_torch.parallel.halo import halo
from egm_unet_torch.parallel.mesh import spatial

LAPLACE4 = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))
LAPLACE8 = ((-1.0, -1.0, -1.0), (-1.0, 8.0, -1.0), (-1.0, -1.0, -1.0))
SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


@functools.lru_cache(maxsize=None)
def _weight(kernel, device: torch.device) -> torch.Tensor:
    """The stencil as a (1, 1, 3, 3) float32 tensor on ``device``, made once:
    a train step then copies nothing to the device for it."""
    with torch.inference_mode(False):
        return torch.tensor(kernel, dtype=torch.float32, device=device)[None, None]


def stencil2d(x: torch.Tensor, kernel) -> torch.Tensor:
    """Apply a 3x3 stencil (nested tuples, rows first) in float32 with zero
    padding 1.  ``x``: (B, H, W), (H, W), or NHWC with one channel; returns
    the same shape."""
    shape = x.shape
    if x.ndim == 4:
        if shape[-1] != 1:
            raise ValueError(f"stencil2d expects one channel, got shape {tuple(shape)}")
        x = x[..., 0]
    elif x.ndim == 2:
        x = x[None]
    elif x.ndim != 3:
        raise ValueError(f"stencil2d expects 2-D to 4-D input, got {tuple(shape)}")
    x, pad = x.float(), (1, 1)
    if spatial() is not None:
        x, pad = halo(x, 1), (0, 1)
    y = F.conv2d(x[:, None], _weight(kernel, x.device), padding=pad)[:, 0]
    return y.reshape(shape)
