"""Synthetic tactile-paving-like images for smoke tests (port of
``synthetic_tp_sample`` and ``SyntheticTPDataset`` of
``egm_unet_tpu/data/synthetic.py``): RGB street-like noise with a slanted band
of bright-yellow stripes as foreground."""

from __future__ import annotations

import numpy as np


def synthetic_tp_sample(index: int, h: int = 565, w: int = 752,
                        seed0: int = 1000):
    rng = np.random.default_rng(seed0 + index)
    img = (rng.normal(0.45, 0.15, (h, w, 3)).clip(0, 1) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    cx = rng.integers(w // 4, 3 * w // 4)
    width = rng.integers(w // 10, w // 5)
    slope = rng.uniform(-0.3, 0.3)
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    center = cx + slope * ys
    band = np.abs(xs - center) < width / 2
    stripes = ((xs - center + 1000 * 8) % 8) < 5
    fg = band & stripes
    img[fg] = (np.array([220, 190, 60]) + rng.normal(0, 12, (int(fg.sum()), 3))).clip(
        0, 255).astype(np.uint8)
    mask[band] = 1
    return img, mask


class SyntheticTPDataset:
    """Duck-typed like ``DriveDataset``: ``ds[i]`` is ``(uint8 HWC image,
    uint8 HW mask)``, or what ``transforms`` makes of them."""

    def __init__(self, n: int = 32, transforms=None, h: int = 565, w: int = 752,
                 seed0: int = 1000):
        self.n, self.transforms, self.h, self.w = n, transforms, h, w
        self.names = [f"synth{i:04d}" for i in range(n)]
        self.seed0 = seed0

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        img, mask = synthetic_tp_sample(idx, self.h, self.w, seed0=self.seed0)
        if self.transforms is not None:
            return self.transforms(img, mask)
        return img, mask
