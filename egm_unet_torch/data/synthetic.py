"""Synthetic tactile-paving-like images for smoke tests and training runs
without the TP-Dataset (port of ``egm_unet_tpu/data/synthetic.py``): RGB
street-like noise with a slanted band of bright-yellow stripes as
foreground, and a harder, distractor-laden variant.  Every array equals the
JAX package's for the same index and seed."""

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


def _box_blur3(img: np.ndarray) -> np.ndarray:
    """Separable 3x3 box blur with edge replication (float [H, W, C])."""
    p = np.pad(img, ((1, 1), (0, 0), (0, 0)), mode="edge")
    img = (p[:-2] + p[1:-1] + p[2:]) / 3.0
    p = np.pad(img, ((0, 0), (1, 1), (0, 0)), mode="edge")
    return (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) / 3.0


def synthetic_tp_sample_hard(index: int, h: int = 565, w: int = 752,
                             seed0: int = 1000):
    """Discriminative variant of the generator: the easy task is solved in
    the first epoch, so its training curves cannot tell the reference recipe
    from a broken one.  This version breaks every single-cue shortcut:

    - ~45% of bands are LOW-CONTRAST (sidewalk-gray paving): only the stripe
      texture + geometry identify them, not color;
    - yellow DISTRACTORS off the band (painted lane lines, crosswalk bars —
      periodic yellow stripes like real street furniture) punish pure color
      thresholding with false positives;
    - gray striped GRATING patches punish pure texture detection;
    - soft SHADOW bands multiply brightness by 0.55-0.8 across everything,
      including the paving, so absolute intensity is unreliable;
    - slab grout lines, an illumination gradient, sensor noise and a 3x3
      blur remove pixel-level separability.

    The label is still the full band (mask semantics identical to the easy
    generator / ref GT masks).
    """
    rng = np.random.default_rng(seed0 + index)
    ys = np.arange(h)[:, None].astype(np.float32)
    xs = np.arange(w)[None, :].astype(np.float32)

    # --- sidewalk: per-sample albedo, slab grout lines, illumination ramp
    base = 0.48 + rng.uniform(-0.08, 0.08)
    img = np.full((h, w, 3), base, np.float32)
    period = int(rng.integers(60, 110))
    grout = ((xs.astype(np.int64) % period) < 2) | \
            ((ys.astype(np.int64) % period) < 2)
    img[np.broadcast_to(grout, (h, w))] *= 0.85
    gx, gy = rng.uniform(-0.08, 0.08, 2)
    img += (gx * (xs / w - 0.5) + gy * (ys / h - 0.5))[..., None]

    # --- the tactile band (the label)
    cx = rng.integers(w // 4, 3 * w // 4)
    width = int(rng.integers(w // 10, w // 5))
    slope = rng.uniform(-0.35, 0.35)
    center = cx + slope * ys
    dist = xs - center  # signed perpendicular-ish coordinate
    band = np.abs(dist) < width / 2

    yellow_band = rng.random() < 0.55
    if yellow_band:
        color = np.array([0.80, 0.70, 0.26], np.float32) \
            + rng.uniform(-0.05, 0.05, 3).astype(np.float32)
    else:  # low-contrast paving: gray tactile strip, texture-only cue
        color = np.full(3, base + rng.uniform(0.02, 0.07), np.float32)
    sp = int(rng.integers(7, 13))  # fine bar period of the tactile surface
    bars = (dist % sp) < sp * 0.55
    tex = np.where(bars, 0.10, -0.07).astype(np.float32)
    band_img = color[None, None, :] + tex[..., None] * \
        np.array([1.0, 1.0, 0.85], np.float32)
    img = np.where(band[..., None], band_img, img)

    # --- distractor 1: painted yellow lane line (thin, off-band)
    if rng.random() < 0.8:
        lc = rng.integers(0, w) + rng.uniform(-0.6, 0.6) * ys
        line = (np.abs(xs - lc) < rng.integers(5, 13)) & ~band
        img[line] = np.array([0.83, 0.72, 0.27], np.float32) \
            + rng.uniform(-0.04, 0.04, 3).astype(np.float32)

    # --- distractor 2: crosswalk bars (periodic yellow stripes, horizontal)
    if rng.random() < 0.6:
        y0 = int(rng.integers(0, max(h - h // 4, 1)))
        bh = int(rng.integers(10, 22))
        x0 = int(rng.integers(0, w // 2))
        x1 = x0 + int(rng.integers(w // 4, w // 2))
        strip = (ys >= y0) & (ys < y0 + h // 5) & (xs >= x0) & (xs < x1)
        cw = strip & (((ys - y0).astype(np.int64) % (2 * bh)) < bh) & ~band
        img[cw] = np.array([0.81, 0.71, 0.28], np.float32) \
            + rng.uniform(-0.04, 0.04, 3).astype(np.float32)

    # --- distractor 3: gray grating patch (striped texture, not paving)
    if rng.random() < 0.7:
        py0 = int(rng.integers(0, max(h - h // 4, 1)))
        px0 = int(rng.integers(0, max(w - w // 4, 1)))
        ph, pw = int(rng.integers(h // 8, h // 4)), int(rng.integers(w // 8, w // 4))
        patch = (ys >= py0) & (ys < py0 + ph) & (xs >= px0) & (xs < px0 + pw)
        gsp = int(rng.integers(6, 14))
        ang = rng.uniform(-0.7, 0.7)
        gbars = ((xs + ang * ys) % gsp) < gsp * 0.5
        sel = patch & ~band
        img[np.broadcast_to(sel & gbars, (h, w))] += 0.09
        img[np.broadcast_to(sel & ~gbars, (h, w))] -= 0.06

    # --- shadows: soft multiplicative bands crossing everything
    for _ in range(int(rng.integers(1, 3))):
        sc = rng.integers(0, w) + rng.uniform(-1.5, 1.5) * ys
        swid = int(rng.integers(w // 6, w // 2))
        d = np.abs(xs - sc) / max(swid / 2, 1)
        depth = rng.uniform(0.55, 0.8)
        shade = depth + (1 - depth) * np.clip(d - 1.0, 0.0, 1.0)  # soft edge
        img *= np.minimum(shade, 1.0)[..., None]

    # --- sensor noise + blur (kills single-pixel separability)
    img += rng.normal(0.0, 0.04, (h, w, 3)).astype(np.float32)
    img = _box_blur3(img)
    return ((img.clip(0, 1) * 255).astype(np.uint8),
            band.astype(np.uint8))


class SyntheticTPDataset:
    """Duck-typed like ``DriveDataset``: ``ds[i]`` is ``(uint8 HWC image,
    uint8 HW mask)``, or what ``transforms`` makes of them.

    ``cache=True`` keeps the raw samples in memory after their first
    generation (about 20 ms an image), so that a multi-epoch run generates
    each once; the transforms still run on every access.  ``hard``: the
    distractor-laden generator.  ``seed0``: the sample-seed offset; a
    validation split needs another offset than its training split, or it is
    a subset of it."""

    def __init__(self, n: int = 32, transforms=None, h: int = 565, w: int = 752,
                 cache: bool = False, hard: bool = False, seed0: int = 1000):
        self.n, self.transforms, self.h, self.w = n, transforms, h, w
        self.names = [f"synth{i:04d}" for i in range(n)]
        self._cache = {} if cache else None
        self.hard, self.seed0 = hard, seed0

    def __len__(self):
        return self.n

    def raw(self, idx: int):
        """The uint8 image and {0, 1} mask of sample ``idx``, before
        ``transforms``."""
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        gen = synthetic_tp_sample_hard if self.hard else synthetic_tp_sample
        img, mask = gen(idx, self.h, self.w, seed0=self.seed0)
        if self._cache is not None:
            self._cache[idx] = (img, mask)
        return img, mask

    def __getitem__(self, idx: int):
        img, mask = self.raw(idx)
        if self.transforms is not None:
            return self.transforms(img, mask)
        return img, mask


def synthetic_tp_batch(batch: int, size: int = 480, seed: int = 0,
                       mean=None, std=None):
    """A normalised, static-shape training batch straight from the easy
    generator: float32 images [B, size, size, 3], int32 masks."""
    from egm_unet_torch.data.transforms import TP_MEAN, TP_STD, normalize

    mean = TP_MEAN if mean is None else mean
    std = TP_STD if std is None else std
    imgs = np.zeros((batch, size, size, 3), np.float32)
    tgts = np.zeros((batch, size, size), np.int32)
    for i in range(batch):
        img, mask = synthetic_tp_sample(seed * 1009 + i, size, size)
        imgs[i] = normalize(img, mean, std)
        tgts[i] = mask
    return imgs, tgts
