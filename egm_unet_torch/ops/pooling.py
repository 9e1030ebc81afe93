"""Pooling ops with PyTorch-module semantics, NHWC (port of
``egm_unet_tpu/ops/pooling.py``).

- ``max_pool2d``: floor mode, explicit -inf padding.
- ``min_pool2d``: ``-max_pool2d(-x)``.
- ``avg_pool2d``: ``count_include_pad=True``, zero padding counts in the mean.
- ``global_avg_pool``, ``global_max_pool``, ``global_std_pool`` over H and W
  (or ``axes``); the std is torch's unbiased one (divisor N - 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v):
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def max_pool2d(x: torch.Tensor, kernel=2, stride=None, padding=0) -> torch.Tensor:
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride if stride is not None else kernel)
    ph, pw = _pair(padding)
    xc = x.permute(0, 3, 1, 2)
    if ph or pw:
        xc = F.pad(xc, (pw, pw, ph, ph), value=float("-inf"))
    y = F.max_pool2d(xc, (kh, kw), (sh, sw))
    return y.permute(0, 2, 3, 1).contiguous()


def min_pool2d(x: torch.Tensor, kernel=3, stride=1, padding=1) -> torch.Tensor:
    return -max_pool2d(-x, kernel, stride, padding)


def avg_pool2d(x: torch.Tensor, kernel=3, stride=1, padding=1) -> torch.Tensor:
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), _pair(kernel), _pair(stride),
                     _pair(padding), count_include_pad=True)
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor, axes=(1, 2), keepdims: bool = False) -> torch.Tensor:
    return x.mean(dim=tuple(axes), keepdim=keepdims)


def global_max_pool(x: torch.Tensor, axes=(1, 2), keepdims: bool = False) -> torch.Tensor:
    return x.amax(dim=tuple(axes), keepdim=keepdims)


def global_std_pool(x: torch.Tensor, axes=(1, 2), keepdims: bool = False) -> torch.Tensor:
    """Unbiased std over ``axes`` (``Tensor.std``'s default, ddof 1)."""
    return x.std(dim=tuple(axes), correction=1, keepdim=keepdims)
