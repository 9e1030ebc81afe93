"""NHWC x HWIO convolution through ``F.conv2d``.

``x.permute(0, 3, 1, 2)`` is a channels_last view of an NHWC tensor, so no
copy is made; the result is permuted back to NHWC.  Integer padding ``p``
is symmetric zero padding, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """``w`` is (kh, kw, in_ch // groups, out_ch); output in ``x.dtype``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding, dilation=dilation,
                 groups=groups)
    return y.permute(0, 2, 3, 1)
