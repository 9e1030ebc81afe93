"""NHWC x HWIO convolution through ``F.conv2d`` (and its depthwise form),
and the stride == kernel transposed convolution as a per-token matmul.

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
    wt = w.to(x.dtype).permute(3, 2, 0, 1)
    if wt.dtype == torch.float64:
        # the CPU's float64 convolution (no oneDNN path) computes the
        # weight's gradient only into a contiguous tensor
        wt = wt.contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2), wt,
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding, dilation=dilation,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=1, padding=0,
                     dilation=1) -> torch.Tensor:
    """Depthwise conv: ``w`` is (kh, kw, 1, C), groups == C."""
    return conv2d(x, w, stride=stride, padding=padding, dilation=dilation,
                  groups=x.shape[-1])


def conv_transpose2d_nonoverlap(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Transposed conv with stride == kernel size (non-overlapping patches):
    a per-pixel matmul and a pixel shuffle,

        out[b, i*kh+di, j*kw+dj, o] = sum_c x[b, i, j, c] * w[c, di, dj, o]

    ``w`` is (C_in, kh, kw, C_out), cast to ``x.dtype``; sums in float32,
    output in ``x.dtype``."""
    b, h, wd, c = x.shape
    cin, kh, kw, cout = w.shape
    if c != cin:
        raise ValueError(f"channel mismatch {c} != {cin}")
    y = torch.matmul(x.reshape(b, h * wd, c),
                     w.to(x.dtype).reshape(cin, kh * kw * cout))
    y = y.reshape(b, h, wd, kh, kw, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h * kh, wd * kw, cout)
