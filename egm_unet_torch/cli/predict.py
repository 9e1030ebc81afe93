"""Helpers of the single-model inference CLI (port of the shape bucketing of
``egm_unet_tpu/cli/predict.py``; the CLI itself is not ported yet, see
ROADMAP.md)."""

from __future__ import annotations

import numpy as np


def bucket_pad(img: np.ndarray, multiple: int = 64) -> np.ndarray:
    """Zero-pad an HWC image at the bottom and right to the next multiple of
    ``multiple`` pixels, so that a handful of shapes cover every image."""
    h, w = img.shape[:2]
    bh = ((h + multiple - 1) // multiple) * multiple
    bw = ((w + multiple - 1) // multiple) * multiple
    out = np.zeros((bh, bw, img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out
