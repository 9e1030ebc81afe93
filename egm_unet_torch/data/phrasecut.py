"""PhraseCut (VGPhraseCut_v0) data pipeline (port of
``egm_unet_tpu/data/phrasecut.py``; the same ``np.random.Generator`` draws in
the same order, so one seed gives the same samples).

Behaviors of the reference's ``datasets/phrasecut.py`` reproduced:
- polygons -> mask union per phrase (ref: :268-275; we ship our own scanline
  rasterizer matching skimage.draw.polygon2mask's center-inclusion rule);
- ``find_crop``: random square crop search with min foreground fraction,
  best-of-k (ref: :76-111);
- sample pipeline: crop -> NEAREST seg / align-corners bilinear image resize
  to 352 -> /255 -> normalize (ref: :286-306);
- negative-prompt sampling with probability ``negative_prob``: swap in a
  different phrase and zero the target (ref: :319-327).

File layout expected (standard VGPhraseCut_v0):
    {root}/refer_{split}.json   — list of tasks: {task_id, image_id, phrase,
                                  Polygons: [[ [x,y], ... ], ...]}
    {root}/images/{image_id}.jpg
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

import torch

from egm_unet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from egm_unet_torch.ops.resize import resize_bilinear, resize_nearest


def polygon2mask(shape: Tuple[int, int], polygon_yx: Sequence[Sequence[float]]) -> np.ndarray:
    """Rasterize one polygon given (y, x) vertices; pixel centers inside the
    polygon (even-odd rule) are set, matching skimage.polygon2mask."""
    h, w = shape
    poly = np.asarray(polygon_yx, np.float64)
    if len(poly) < 3:
        return np.zeros(shape, bool)
    ys, xs = poly[:, 0], poly[:, 1]
    mask = np.zeros(shape, bool)
    y0 = max(int(np.floor(ys.min())), 0)
    y1 = min(int(np.ceil(ys.max())) + 1, h)
    n = len(poly)
    for row in range(y0, y1):
        yc = row  # pixel center convention used by skimage (vertex coords)
        nodes = []
        j = n - 1
        for i in range(n):
            yi, yj = ys[i], ys[j]
            if (yi <= yc < yj) or (yj <= yc < yi):
                t = (yc - yi) / (yj - yi)
                nodes.append(xs[i] + t * (xs[j] - xs[i]))
            j = i
        nodes.sort()
        for k in range(0, len(nodes) - 1, 2):
            a = max(int(np.ceil(nodes[k])), 0)
            b = min(int(np.floor(nodes[k + 1])) + 1, w)
            if b > a:
                mask[row, a:b] = True
    return mask


def random_crop_slices(origin_size, target_size, rng: np.random.Generator):
    oy = int(rng.integers(0, origin_size[0] - target_size[0] + 1))
    ox = int(rng.integers(0, origin_size[1] - target_size[1] + 1))
    return (slice(oy, oy + target_size[0]), slice(ox, ox + target_size[1]))


def find_crop(seg: np.ndarray, image_size, rng: np.random.Generator,
              iterations: int = 1000, min_frac: Optional[float] = None,
              best_of: Optional[int] = None):
    """Random square-crop search (ref: datasets/phrasecut.py:76-111):
    accept the first (or best-of-k) crop whose foreground exceeds
    ``min_frac`` of the crop area; otherwise return the best failing crop
    with exceed=True."""
    seg = seg.astype(bool)
    min_sum = 0.0
    if min_frac is not None:
        min_sum = image_size[0] * image_size[1] * min_frac

    best_crops: List = []
    best_not_ok = (float("-inf"), None, None)
    for _ in range(iterations):
        sly, slx = random_crop_slices(seg.shape, image_size, rng)
        s = int(seg[sly, slx].sum())
        if s > min_sum:
            if best_of is None:
                return sly, slx, False
            best_crops.append((s, sly, slx))
            if len(best_crops) >= best_of:
                best_crops.sort(key=lambda x: x[0], reverse=True)
                return best_crops[0][1], best_crops[0][2], False
        elif s > best_not_ok[0]:
            best_not_ok = (s, sly, slx)
    return best_not_ok[1], best_not_ok[2], best_not_ok[0] <= min_sum


class PhraseCutDataset:
    """RefVG loader + sample pipeline.  Yields (image[352,352,3] normalized,
    seg[352,352] float {0,1}, phrase str)."""

    def __init__(self, root: str, split: str = "train", image_size: int = 352,
                 aug_crop: bool = True, negative_prob: float = 0.0,
                 phrase_form: str = "{}", min_size: int = 0, seed: int = 0,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.root = root
        self.image_size = image_size
        self.aug_crop = aug_crop
        self.negative_prob = negative_prob
        self.phrase_form = phrase_form
        self.rng = np.random.default_rng(seed)
        self.mean, self.std = mean, std

        refer = os.path.join(root, f"refer_{split}.json")
        with open(refer) as f:
            tasks = json.load(f)
        self.tasks = [t for t in tasks if self._task_size(t) >= min_size]
        self.all_phrases = sorted({t["phrase"] for t in self.tasks})

    @staticmethod
    def _task_size(task) -> float:
        # rough foreground size proxy: total polygon bbox area
        total = 0.0
        for poly in task.get("Polygons", []):
            p = np.asarray(poly, np.float64)
            if len(p) >= 3:
                total += float(np.ptp(p[:, 0]) * np.ptp(p[:, 1]))
        return total

    def __len__(self):
        return len(self.tasks)

    def _image(self, image_id) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.root, "images", f"{image_id}.jpg")
        img = np.asarray(Image.open(path))
        if img.ndim == 2:
            img = np.dstack([img] * 3)
        return img[..., :3]

    def load_sample(self, task):
        img = self._image(task["image_id"])
        h, w = img.shape[:2]
        masks = [polygon2mask((h, w), [(p[1], p[0]) for p in poly])  # xy -> yx
                 for poly in task["Polygons"] if len(poly) >= 3]
        seg = np.stack(masks).max(0) if masks else np.zeros((h, w), bool)
        phrase = self.phrase_form.format(task["phrase"])

        min_shape = min(h, w)
        if self.aug_crop:
            sly, slx, _ = find_crop(seg, (min_shape, min_shape), self.rng,
                                    iterations=50, min_frac=0.05)
        else:
            sly, slx = slice(0, None), slice(0, None)
        seg = seg[sly, slx].astype(np.float32)
        img = img[sly, slx]

        s = self.image_size
        seg = resize_nearest(torch.from_numpy(np.ascontiguousarray(seg)), (s, s),
                             mode="torch").numpy()
        img = resize_bilinear(torch.from_numpy(img.astype(np.float32)), (s, s),
                              align_corners=True).numpy()
        img = (img / 255.0 - self.mean) / self.std
        return img.astype(np.float32), seg, phrase

    def __getitem__(self, i: int):
        img, seg, phrase = self.load_sample(self.tasks[i])
        if self.negative_prob > 0 and self.rng.random() < self.negative_prob:
            new_phrase = phrase
            while new_phrase == phrase:
                new_phrase = self.all_phrases[
                    int(self.rng.integers(0, len(self.all_phrases)))]
            phrase = new_phrase
            seg = np.zeros_like(seg)
        return img, seg, phrase


def make_synthetic_phrasecut(root: str, n: int = 8, hw=(96, 128), seed: int = 0):
    """Write a tiny synthetic VGPhraseCut_v0-format dataset for tests."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    phrases = ["red square", "blue triangle", "green stripe", "yellow box"]
    tasks = []
    h, w = hw
    for i in range(n):
        img = (rng.uniform(0, 0.3, (h, w, 3)) * 255).astype(np.uint8)
        cx, cy = int(rng.integers(20, w - 20)), int(rng.integers(20, h - 20))
        sz = int(rng.integers(10, 18))
        poly_xy = [[cx - sz, cy - sz], [cx + sz, cy - sz],
                   [cx + sz, cy + sz], [cx - sz, cy + sz]]
        img[max(cy - sz, 0):cy + sz, max(cx - sz, 0):cx + sz] = [200, 40, 40]
        Image.fromarray(img).save(os.path.join(root, "images", f"{i}.jpg"))
        tasks.append({"task_id": f"t{i}", "image_id": i,
                      "phrase": phrases[i % len(phrases)],
                      "Polygons": [poly_xy]})
    with open(os.path.join(root, "refer_train.json"), "w") as f:
        json.dump(tasks, f)
    with open(os.path.join(root, "refer_val.json"), "w") as f:
        json.dump(tasks[: max(n // 2, 1)], f)
    return root
