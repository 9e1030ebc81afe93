"""Color maps and palette-PNG mask rendering (port of
``egm_unet_tpu/utils/colormap.py``), host code on numpy and PIL.

The reference ships a Pascal-VOC palette as palette.json and a binary
{0: 0, 1: 255} map in the fusion scripts.  The VOC palette is procedural
(bit-reversal code), so it is generated here.
"""

from __future__ import annotations

import numpy as np
import torch

BINARY_COLOR_MAP = {0: 0, 1: 255}  # background black, tactile paving white


def pascal_voc_palette(n: int = 256) -> np.ndarray:
    """[n, 3] uint8 Pascal-VOC label palette (standard bit-reversal)."""
    palette = np.zeros((n, 3), np.uint8)
    for label in range(n):
        lab = label
        for shift in range(8):
            palette[label, 0] |= ((lab >> 0) & 1) << (7 - shift)
            palette[label, 1] |= ((lab >> 1) & 1) << (7 - shift)
            palette[label, 2] |= ((lab >> 2) & 1) << (7 - shift)
            lab >>= 3
    return palette


def save_mask_png(mask, path: str, binary: bool = True) -> None:
    """Save an integer label mask, a numpy array or a tensor on any device:
    binary mode writes {0, 255} grayscale (label 1 -> 255), else a
    VOC-palettized PNG."""
    from PIL import Image

    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    mask = np.asarray(mask)
    if binary:
        out = np.zeros_like(mask, np.uint8)
        out[mask == 1] = 255
        Image.fromarray(out).convert("L").save(path)
    else:
        img = Image.fromarray(mask.astype(np.uint8), mode="P")
        img.putpalette(pascal_voc_palette().flatten().tolist())
        img.save(path)
