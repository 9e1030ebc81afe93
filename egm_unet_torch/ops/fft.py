"""Frequency-domain "enhancement" of the enhanced MCALayer.

``ifft2(|F| * factor * exp(i*angle(F)))`` with ``F = fft2(x)`` scales the
complex spectrum by ``factor``, so its inverse is ``factor * x`` exactly.
The model uses that product; ``exact=True`` keeps the literal FFT path for
audit.
"""

from __future__ import annotations

import torch


def fft_magnitude_enhance(x: torch.Tensor, factor: float = 1.1, *,
                          exact: bool = False) -> torch.Tensor:
    if not exact:
        return x * factor
    xf = x.float()
    dims = (1, 2) if x.ndim >= 3 else (0, 1)  # NHWC spatial axes, or HW
    f = torch.fft.fft2(xf, dim=dims, norm="ortho")
    enhanced = torch.polar(f.abs() * factor, f.angle())
    return torch.fft.ifft2(enhanced, dim=dims, norm="ortho").real.to(x.dtype)
