"""Channel shuffle on the trailing (channel) axis, NHWC."""

from __future__ import annotations

import torch


def channel_shuffle(x: torch.Tensor, groups: int = 4) -> torch.Tensor:
    """``out[..., j] = x[..., (j % groups) * (C // groups) + j // groups]``."""
    *lead, c = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    x = x.reshape(*lead, groups, c // groups)
    return x.transpose(-1, -2).reshape(*lead, c)
