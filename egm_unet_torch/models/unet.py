"""The decoder stage ``Up`` (port of ``egm_unet_tpu/models/unet.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from egm_unet_torch.nn.layers import DoubleConv, pad_to_match
from egm_unet_torch.ops.resize import upsample2x_bilinear_align_corners


class Up(nn.Module):
    """Bilinear (align_corners) 2x upsample of x1 + pad + concat([x2, x1])
    + DoubleConv.  When x2 is exactly twice x1's size (every bucketed serving
    shape) the upsample, concat and first conv are one ``up_concat_conv``
    launch; otherwise the upsampled x1 is padded to x2 first."""

    def __init__(self, in1: int, in2: int, features: int):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(in1 + in2, features,
                                       mid_features=(in1 + in2) // 2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if x2.shape[1] == 2 * x1.shape[1] and x2.shape[2] == 2 * x1.shape[2]:
            return self.DoubleConv_0(up_pair=(x2, x1))
        x1 = pad_to_match(upsample2x_bilinear_align_corners(x1), x2)
        return self.DoubleConv_0(torch.cat([x2, x1], dim=-1))
