"""Pooling ops with PyTorch-module semantics, NHWC (port of
``egm_unet_tpu/ops/pooling.py``).

- ``max_pool2d``: floor mode, explicit -inf padding.
- ``min_pool2d``: ``-max_pool2d(-x)``.
- ``avg_pool2d``: ``count_include_pad=True``, zero padding counts in the mean.
- ``global_avg_pool``, ``global_max_pool``, ``global_std_pool`` over H and W
  (or ``axes``); the std is torch's unbiased one (divisor N - 1).

Under a spatial group (``parallel.use_spatial_group``) the window pools take
this rank's rows: a stride-1 pool fetches its padding rows from the
neighbouring ranks, filled outside the image with the pool's own padding
(``-inf`` for max, 0 for the average, which counts it); a pool whose stride
is its window (2x2 / 2) gives this rank the rows ``row_range`` assigns it at
the pooled height and fetches the input rows they read, where a pair
straddles two ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from egm_unet_torch.parallel.halo import fetch_rows, halo
from egm_unet_torch.parallel.mesh import row_range, spatial


def _pair(v):
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _rows_for(x: torch.Tensor, kh: int, sh: int, ph: int, fill: float):
    """(the input rows a row-split pool reads, the H padding left): a
    stride-1 pool's halo, or the rows under this rank's share of a pool
    whose stride is its window."""
    sp = spatial()
    if sp is None:
        return x, ph
    if sh == 1 and 2 * ph == kh - 1:
        return halo(x, ph, fill=fill), 0
    if sh == kh and ph == 0:
        out = [row_range(sp.height // kh, r, sp.group.world)
               for r in range(sp.group.world)]
        return fetch_rows(x, [kh * a for a, _ in out], [kh * b for _, b in out], fill), 0
    raise ValueError(f"a row-split pool takes stride 1 with 'same' padding or stride "
                     f"== window; got window {kh}, stride {sh}, padding {ph}")


def max_pool2d(x: torch.Tensor, kernel=2, stride=None, padding=0) -> torch.Tensor:
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride if stride is not None else kernel)
    ph, pw = _pair(padding)
    x, ph = _rows_for(x, kh, sh, ph, float("-inf"))
    xc = x.permute(0, 3, 1, 2)
    if ph or pw:
        xc = F.pad(xc, (pw, pw, ph, ph), value=float("-inf"))
    y = F.max_pool2d(xc, (kh, kw), (sh, sw))
    return y.permute(0, 2, 3, 1).contiguous()


def min_pool2d(x: torch.Tensor, kernel=3, stride=1, padding=1) -> torch.Tensor:
    return -max_pool2d(-x, kernel, stride, padding)


def avg_pool2d(x: torch.Tensor, kernel=3, stride=1, padding=1) -> torch.Tensor:
    (kh, _), (sh, _), (ph, pw) = _pair(kernel), _pair(stride), _pair(padding)
    x, ph = _rows_for(x, kh, sh, ph, 0.0)
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), _pair(kernel), _pair(stride),
                     (ph, pw), count_include_pad=True)
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor, axes=(1, 2), keepdims: bool = False) -> torch.Tensor:
    return x.mean(dim=tuple(axes), keepdim=keepdims)


def global_max_pool(x: torch.Tensor, axes=(1, 2), keepdims: bool = False) -> torch.Tensor:
    return x.amax(dim=tuple(axes), keepdim=keepdims)


def global_std_pool(x: torch.Tensor, axes=(1, 2), keepdims: bool = False) -> torch.Tensor:
    """Unbiased std over ``axes`` (``Tensor.std``'s default, ddof 1)."""
    return x.std(dim=tuple(axes), correction=1, keepdim=keepdims)
