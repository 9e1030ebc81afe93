"""The training set resident on the device (port of
``egm_unet_tpu/data/device_cache.py``).

The raw sources are uploaded once as uint8 canvases; each step then moves
only a ``[batch]`` index vector to the device, where the batch is gathered,
rescaled to float, augmented (``data/device_aug.py``) and cast.  TP-928's
876 training images as 960 x 960 canvases hold about 3.2 GB.

Departure from the JAX package, on purpose: ``epoch_iter`` yields
floor(n / batch) full batches and drops the partial one, as the host
loader (``drop_last=True``) does and as the learning-rate schedule counts
steps.  The JAX cache yields ceil(n / batch) batches and pads the last with
sentinel rows (image 0, mask 255), which adds steps the schedule did not
count and lets zero images into the BatchNorm statistics and the dice term.
And ``build_cache_arrays`` reads the datasets' raw samples (``raw``) instead
of switching their ``transforms`` off and back on.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from egm_unet_torch.data.device_aug import augment_with_params, draw_params, to_unit
from egm_unet_torch.data.transforms import resize_short_side


def source_size(crop: int) -> int:
    """Side of the square source canvas for ``crop``-pixel training crops."""
    return max(2 * crop, crop + 32)


def scale_range(src: int) -> Tuple[int, int]:
    """(min_size, max_size) of the drawn short side: [0.5, 1.2] x the
    source, as the reference's RandomResize is relative to its base size."""
    return int(0.5 * src), int(1.2 * src)


def source_canvas(image: np.ndarray, target: np.ndarray, src_size: int):
    """The sample's short side resized to ``src_size`` (PIL bilinear for the
    image, nearest for the mask) and its top-left ``src_size`` square, on a
    zero canvas where the image is smaller: uint8 [S, S, 3] and [S, S]."""
    image, target = resize_short_side(image, target, src_size)
    img = np.zeros((src_size, src_size, 3), np.uint8)
    tgt = np.zeros((src_size, src_size), np.uint8)
    h, w = min(image.shape[0], src_size), min(image.shape[1], src_size)
    img[:h, :w] = image[:h, :w]
    tgt[:h, :w] = target[:h, :w]
    return img, tgt


class RawSource:
    """Train transform of ``--device-aug``: the source canvas the device
    augments (uint8, a quarter of float32's bytes to copy)."""

    def __init__(self, src_size: int):
        self.src_size = src_size

    def __call__(self, image, target):
        return source_canvas(np.asarray(image), np.asarray(target), self.src_size)


def build_cache_arrays(dataset, src_size: int, workers: int = 8
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Every sample of ``dataset`` (through its ``raw`` accessor, whatever its
    ``transforms``) as one uint8 canvas: ([n, S, S, 3], [n, S, S])."""
    n = len(dataset)
    imgs = np.zeros((n, src_size, src_size, 3), np.uint8)
    masks = np.zeros((n, src_size, src_size), np.uint8)

    def fill(i):
        image, target = dataset.raw(i)
        imgs[i], masks[i] = source_canvas(np.asarray(image), np.asarray(target),
                                          src_size)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(fill, range(n)))
    return imgs, masks


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The augmentation draws of ``epoch``: a pure function of (seed,
    epoch), so a run resumed at an epoch replays the draws an uninterrupted
    run makes there."""
    return torch.Generator(device=torch.device(device)).manual_seed(
        (seed + 1) * 1_000_003 + epoch)


class DeviceDatasetCache:
    """``dataset``'s canvases on ``device``, and per-epoch iteration that
    gathers, augments and casts there.  ``hbm_bytes``: the bytes resident."""

    def __init__(self, dataset, src_size: int, mean, std, crop_size: int,
                 min_size: int, max_size: int, out_dtype=torch.float32,
                 device="cuda"):
        self.device = torch.device(device)
        imgs, masks = build_cache_arrays(dataset, src_size)
        self.n = len(dataset)
        self.src_size, self.crop_size = src_size, crop_size
        self.min_size, self.max_size = min_size, max_size
        self.out_dtype = out_dtype
        self.hbm_bytes = imgs.nbytes + masks.nbytes
        self.imgs = torch.from_numpy(imgs).to(self.device)
        self.masks = torch.from_numpy(masks).to(self.device)
        self.mean = torch.as_tensor(mean, dtype=torch.float32).to(self.device)
        self.std = torch.as_tensor(std, dtype=torch.float32).to(self.device)
        self.h2d_bytes = 0  # index bytes epoch_iter has copied to the device

    def batch(self, idx: torch.Tensor, generator: torch.Generator):
        """The augmented batch of the samples ``idx`` (on the device)."""
        im = to_unit(self.imgs[idx])
        params = draw_params(generator, idx.shape[0], self.src_size,
                             self.crop_size, self.min_size, self.max_size)
        im, tg = augment_with_params(im, self.masks[idx], params, self.mean,
                                     self.std, self.crop_size)
        return im.to(self.out_dtype), tg

    def epoch_iter(self, generator: torch.Generator, batch_size: int,
                   rng: Optional[np.random.Generator] = None
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """floor(n / batch_size) batches (images in ``out_dtype``, uint8
        masks) in ``rng``'s permutation (0..n-1 without one); the partial
        last batch is dropped, so every row is a real sample."""
        order = rng.permutation(self.n) if rng is not None else np.arange(self.n)
        for b in range(self.n // batch_size):
            idx = torch.from_numpy(order[b * batch_size:(b + 1) * batch_size]
                                   .astype(np.int64))
            self.h2d_bytes += idx.nbytes
            yield self.batch(idx.to(self.device), generator)
