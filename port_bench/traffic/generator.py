"""The one generator of the benchmark's traffic.  A mix is a data file,
``traffic/<mix>.json``, of parameters this module reads:

- ``frames``: ``[[h, w, share], ...]``, the frame sizes and the share of
  the pool each takes; ``pool``: how many distinct frames are made;
- ``batch`` (a device batch of frames) and ``pool_batches`` (how many
  distinct batches are drawn from the pool), or ``folder`` and
  ``pool_folders`` for a closed loop over folders of frames.

Frames are tactile-paving-like street images (a frozen copy of the port's
``data/synthetic.py`` easy generator): noisy pavement with a slanted band
of bright-yellow stripes.  Everything is drawn from ``seed``.
"""

from __future__ import annotations

from typing import List

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """Independent streams of one seed."""
    return np.random.default_rng([int(seed) % (2 ** 64), *stream])


def tp_frame(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A uint8 HWC frame (``synthetic_tp_sample``'s drawing)."""
    img = (rng.normal(0.45, 0.15, (h, w, 3)).clip(0, 1) * 255).astype(np.uint8)
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
    return img


def frame_sizes(mix: dict) -> List[tuple]:
    """The (h, w) of each pool frame, in the mix's shares."""
    n = int(mix["pool"])
    sizes, left = [], n
    for i, (h, w, share) in enumerate(mix["frames"]):
        k = left if i == len(mix["frames"]) - 1 else int(round(share * n))
        sizes += [(int(h), int(w))] * k
        left -= k
    return sizes


def frames(mix: dict, seed: int) -> List[np.ndarray]:
    """The pool of frames, frame i from its own stream of ``seed``."""
    return [tp_frame(rng_for(seed, 1, i), h, w) for i, (h, w) in enumerate(frame_sizes(mix))]


def groups(mix: dict, seed: int, size_key: str, count_key: str) -> List[List[int]]:
    """``mix[count_key]`` lists of ``mix[size_key]`` pool indices, each a
    draw without replacement from the seed."""
    rng = rng_for(seed, 2)
    n = int(mix["pool"])
    return [list(rng.permutation(n)[:int(mix[size_key])]) for _ in range(int(mix[count_key]))]

