"""NHWC x HWIO convolution through ``F.conv2d`` (and its depthwise form),
and the stride == kernel transposed convolution as a per-token matmul.

``x.permute(0, 3, 1, 2)`` is a channels_last view of an NHWC tensor, so no
copy is made; the result is permuted back to NHWC.  Integer padding ``p``
is symmetric zero padding, as in the JAX package.

Under a spatial group (``parallel.use_spatial_group``) the input is this
rank's rows of the map: a stride-1 convolution whose H padding keeps the
height (``2 * padding == dilation * (kh - 1)``) takes its ``padding`` rows
above and below from the ranks that hold them (``parallel.halo``, zero
outside the image) and pads W only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from egm_unet_torch.parallel.halo import halo
from egm_unet_torch.parallel.mesh import spatial


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           *, stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """``w`` is (kh, kw, in_ch // groups, out_ch); output in ``x.dtype``."""
    if spatial() is not None:
        x, padding = _row_halo(x, w.shape[0], stride, padding, dilation)
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


def _pair(v) -> tuple:
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _row_halo(x: torch.Tensor, kh: int, stride, padding, dilation) -> tuple:
    """(x with its H halo, the padding left for W) of a row-split input."""
    (sh, _), (ph, pw), (dh, _) = _pair(stride), _pair(padding), _pair(dilation)
    if kh == 1 and ph == 0 and sh == 1:
        return x, (0, pw)
    if sh != 1 or 2 * ph != dh * (kh - 1):
        raise ValueError(f"a row-split conv must keep the height: kernel {kh}, stride "
                         f"{sh}, padding {ph}, dilation {dh}")
    return halo(x, ph), (0, pw)


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
