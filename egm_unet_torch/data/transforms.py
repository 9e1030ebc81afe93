"""Eval-time image transforms, host-side numpy and PIL (port of the parts of
``egm_unet_tpu/data/transforms.py`` that serving uses)."""

from __future__ import annotations

import numpy as np

# TP-Dataset normalization statistics
TP_MEAN = np.array([0.709, 0.381, 0.224], np.float32)
TP_STD = np.array([0.127, 0.079, 0.043], np.float32)


def _pil_resize(arr: np.ndarray, size_hw, nearest: bool) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray(arr)
    res = img.resize((size_hw[1], size_hw[0]),
                     Image.NEAREST if nearest else Image.BILINEAR)
    return np.asarray(res)


def resize_short_side(image: np.ndarray, target: np.ndarray | None, size: int):
    """torchvision ``F.resize(size)``: short side -> size, keep aspect."""
    h, w = image.shape[:2]
    if h < w:
        nh, nw = size, max(1, int(round(size * w / h)))
    else:
        nh, nw = max(1, int(round(size * h / w))), size
    image = _pil_resize(image, (nh, nw), nearest=False)
    if target is not None:
        target = _pil_resize(target, (nh, nw), nearest=True)
    return image, target


def normalize(image_u8: np.ndarray, mean=TP_MEAN, std=TP_STD) -> np.ndarray:
    x = image_u8.astype(np.float32) / 255.0
    return (x - mean) / std
