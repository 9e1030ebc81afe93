"""Paired image/mask transforms, host-side numpy and PIL (port of
``egm_unet_tpu/data/transforms.py``), and ``device_normalize``, the
normalisation of raw uint8 images on their device.

- train: RandomResize (short side in [0.5, 1.2] x 565) -> flips p=0.5 ->
  RandomCrop(480, pad 0) -> normalize; every draw from one numpy generator
  seeded as the JAX package seeds it, so the same seed gives the same crops.
- eval: Resize (short side 565) -> normalize.
- normalization statistics: the TP-Dataset's mean and std.
"""

from __future__ import annotations

import numpy as np
import torch

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


def hflip(image, target):
    return image[:, ::-1], target[:, ::-1]


def vflip(image, target):
    return image[::-1], target[::-1]


def pad_if_smaller(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    """Pad bottom and right to at least ``size``."""
    h, w = arr.shape[:2]
    ph, pw = max(size - h, 0), max(size - w, 0)
    if ph == 0 and pw == 0:
        return arr
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pad, constant_values=fill)


def random_crop(image, target, size: int, rng: np.random.Generator):
    image = pad_if_smaller(image, size, fill=0)
    target = pad_if_smaller(target, size, fill=0)
    h, w = image.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return (image[top:top + size, left:left + size],
            target[top:top + size, left:left + size])


def center_crop(image, target, size: int):
    """Paired center crop with torchvision's ``F.center_crop`` semantics:
    pad with 0 symmetrically if smaller, then crop the centred window (its
    top ``int(round((h - size) / 2))``, round half to even)."""
    def _one(arr):
        h, w = arr.shape[:2]
        ph, pw = max(size - h, 0), max(size - w, 0)
        if ph or pw:
            pad = [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)]
            pad += [(0, 0)] * (arr.ndim - 2)
            arr = np.pad(arr, pad, constant_values=0)
            h, w = arr.shape[:2]
        top, left = int(round((h - size) / 2.0)), int(round((w - size) / 2.0))
        return arr[top:top + size, left:left + size]

    return _one(image), _one(target)


def normalize(image_u8: np.ndarray, mean=TP_MEAN, std=TP_STD) -> np.ndarray:
    x = image_u8.astype(np.float32) / 255.0
    return (x - mean) / std


def device_normalize(images_u8: torch.Tensor, mean=TP_MEAN, std=TP_STD,
                     dtype=None) -> torch.Tensor:
    """``normalize`` on the images' device: raw uint8 ``[..., 3]`` images ->
    ``(x / 255 - mean) / std`` in float32, bit for bit the host's, then
    ``dtype`` if given.  Every divisor is a float32 tensor on that device:
    CUDA divides by a Python number, or by a 0-dim CPU tensor, as a product
    by its float32 reciprocal, one ulp off the host on 126 of the 256 byte
    values."""
    dev = images_u8.device
    stats = torch.tensor(np.stack([mean, std]), dtype=torch.float32, device=dev)
    x = images_u8.to(torch.float32, copy=True)
    x.div_(torch.full((), 255.0, dtype=torch.float32, device=dev))
    x.sub_(stats[0]).div_(stats[1])
    return x if dtype is None else x.to(dtype)


class TrainTransform:
    """The reference's train preset.  ``wire_uint8``: return the raw uint8
    crop and let the train step normalise on the device
    (``device_normalize``), a quarter of the bytes to copy."""

    def __init__(self, base_size=565, crop_size=480, hflip_prob=0.5,
                 vflip_prob=0.5, mean=TP_MEAN, std=TP_STD, seed=0,
                 wire_uint8=False):
        self.min_size = int(0.5 * base_size)
        self.max_size = int(1.2 * base_size)
        self.crop_size = crop_size
        self.hflip_prob = hflip_prob
        self.vflip_prob = vflip_prob
        self.mean, self.std = mean, std
        self.rng = np.random.default_rng(seed)
        self.wire_uint8 = wire_uint8

    def __call__(self, image: np.ndarray, target: np.ndarray):
        size = int(self.rng.integers(self.min_size, self.max_size + 1))
        image, target = resize_short_side(image, target, size)
        if self.rng.random() < self.hflip_prob:
            image, target = hflip(image, target)
        if self.rng.random() < self.vflip_prob:
            image, target = vflip(image, target)
        image, target = random_crop(image, target, self.crop_size, self.rng)
        if self.wire_uint8:
            return image, target.astype(np.int32)
        return normalize(image, self.mean, self.std), target.astype(np.int32)


class EvalTransform:
    """The reference's eval preset: resize the short side to ``base_size``,
    normalize (unless ``wire_uint8``, see ``TrainTransform``); the target
    (if any) is resized with NEAREST to int32."""

    def __init__(self, base_size: int = 565, mean=TP_MEAN, std=TP_STD,
                 wire_uint8: bool = False):
        self.base_size = base_size
        self.mean, self.std = mean, std
        self.wire_uint8 = wire_uint8

    def __call__(self, image: np.ndarray, target: np.ndarray | None):
        image, target = resize_short_side(image, target, self.base_size)
        if not self.wire_uint8:
            image = normalize(image, self.mean, self.std)
        return image, None if target is None else target.astype(np.int32)
