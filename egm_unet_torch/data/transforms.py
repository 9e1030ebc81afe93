"""Eval-time image transforms, host-side numpy and PIL (port of the parts of
``egm_unet_tpu/data/transforms.py`` that serving uses)."""

from __future__ import annotations

import numpy as np

# TP-Dataset normalization statistics
TP_MEAN = np.array([0.709, 0.381, 0.224], np.float32)
TP_STD = np.array([0.127, 0.079, 0.043], np.float32)
# ImageNet statistics, the CLIPSeg branch's normalization
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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


class EvalTransform:
    """The reference's eval preset: resize the short side to ``base_size``,
    normalize; the target (if any) is resized with NEAREST to int32."""

    def __init__(self, base_size: int = 565, mean=TP_MEAN, std=TP_STD):
        self.base_size = base_size
        self.mean, self.std = mean, std

    def __call__(self, image: np.ndarray, target: np.ndarray | None):
        image, target = resize_short_side(image, target, self.base_size)
        image = normalize(image, self.mean, self.std)
        return image, None if target is None else target.astype(np.int32)
