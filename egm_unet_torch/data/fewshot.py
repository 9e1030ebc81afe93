"""Few-shot segmentation datasets, COCO-20i / Pascal-5i style (port of
``egm_unet_tpu/data/fewshot.py``).

The reference's ``datasets/coco_wrapper.py:21`` and ``pfe_dataset.py:11``
wrap third-party loaders (hsnet / PFENet) that are absent from its repo —
they define a *contract*: given a fold, yield (query image, support
image+mask, query mask, class) samples, with ``negative_prob`` support
replacement and the ``mask`` composition modes of
``datasets/utils.blend_image_segmentation``.

``FewShotSegDataset`` implements that contract natively from standard
COCO-format annotations (``instances_*.json`` with polygon segmentations —
rasterized by the same scanline fill as data/phrasecut.py), so it works for
both COCO-20i (fold via fewshot_splits.coco_20i_fold) and Pascal-5i-style
data exported to COCO json.  Images are resized square + ImageNet-normalized
(ref: coco_wrapper.py:44-51).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from egm_unet_torch.data.blend import blend_image_segmentation
from egm_unet_torch.data.phrasecut import polygon2mask

# ref: datasets/coco_wrapper.py:19
COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _resize_square(arr: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    from PIL import Image

    mode = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(Image.fromarray(arr).resize((size, size), mode))


class FewShotSegDataset:
    """(query, support) episodes over a COCO-format annotation file.

    Parameters mirror COCOWrapper (ref: datasets/coco_wrapper.py:23-30):
    ``mask`` in {'separate', 'text_label', 'text_and_separate'} or any
    blend_image_segmentation mode; ``negative_prob`` replaces the support
    with a different-class image and an all-zero mask.
    """

    def __init__(self, ann_file: str, image_dir: str, *,
                 class_ids: Optional[Sequence[int]] = None,
                 image_size: int = 400, mask: str = "separate",
                 negative_prob: float = 0.0, seed: int = 0,
                 class_names: Sequence[str] = COCO_CLASSES):
        self.image_dir = image_dir
        self.image_size = image_size
        self.mask = mask
        self.negative_prob = negative_prob
        self.rng = np.random.default_rng(seed)
        self.class_names = tuple(class_names)

        with open(ann_file) as f:
            coco = json.load(f)
        self.images: Dict[int, dict] = {im["id"]: im for im in coco["images"]}
        # contiguous class index per COCO category id (sorted order), like
        # hsnet's class_ids convention
        cat_ids = sorted({c["id"] for c in coco.get("categories", [])} or
                         {a["category_id"] for a in coco["annotations"]})
        self.cat_to_idx = {cid: i for i, cid in enumerate(cat_ids)}

        keep = None if class_ids is None else set(class_ids)
        by_class: Dict[int, List[dict]] = {}
        for ann in coco["annotations"]:
            idx = self.cat_to_idx[ann["category_id"]]
            if keep is not None and idx not in keep:
                continue
            if not ann.get("segmentation"):
                continue
            by_class.setdefault(idx, []).append(ann)
        # episodes: every annotation is a query; supports sampled per epoch
        self.by_class = by_class
        self.samples = [(idx, k) for idx, anns in sorted(by_class.items())
                        for k in range(len(anns))]

    def __len__(self):
        return len(self.samples)

    def _load(self, ann: dict):
        from PIL import Image

        info = self.images[ann["image_id"]]
        path = os.path.join(self.image_dir, info["file_name"])
        img = np.asarray(Image.open(path).convert("RGB"))
        h, w = info["height"], info["width"]
        seg = np.zeros((h, w), bool)
        for poly in ann["segmentation"]:  # flat [x0,y0,x1,y1,...]
            yx = [(poly[i + 1], poly[i]) for i in range(0, len(poly), 2)]
            seg |= polygon2mask((h, w), yx)
        img = _resize_square(img, self.image_size, nearest=False)
        seg = _resize_square(seg.astype(np.uint8), self.image_size,
                             nearest=True).astype(np.float32)
        img = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return img, seg

    def __getitem__(self, i):
        class_idx, k = self.samples[i]
        anns = self.by_class[class_idx]
        q_img, q_seg = self._load(anns[k])

        # support: a different annotation of the same class when available
        cand = [j for j in range(len(anns)) if j != k] or [k]
        s_img, s_seg = self._load(anns[int(self.rng.choice(cand))])

        label = self.class_names[class_idx] if class_idx < len(self.class_names) \
            else str(class_idx)
        if self.negative_prob > 0 and self.rng.random() < self.negative_prob:
            # ref: coco_wrapper.py:74-80 — different-class support image,
            # zero support mask
            others = [c for c in self.by_class if c != class_idx]
            if others:
                oc = int(self.rng.choice(others))
                o_anns = self.by_class[oc]
                s_img, _ = self._load(o_anns[int(self.rng.integers(len(o_anns)))])
                s_seg = np.zeros_like(s_seg)

        if self.mask == "separate":
            support = (s_img, s_seg)
        elif self.mask == "text_label":
            support = (label,)
        elif self.mask == "text_and_separate":
            support = (label, s_img, s_seg)
        else:  # blend composition modes
            support = tuple(blend_image_segmentation(s_img, s_seg, self.mask))
        return (q_img,) + support, (q_seg, class_idx)


def make_synthetic_coco(root: str, n_images: int = 6, n_classes: int = 3,
                        hw=(64, 80), seed: int = 0) -> str:
    """Tiny COCO-format dataset on disk (tests / demos).  Returns ann path."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    h, w = hw
    images, annotations = [], []
    for i in range(n_images):
        arr = rng.integers(0, 255, (h, w, 3), np.uint8)
        name = f"img{i:04d}.jpg"
        Image.fromarray(arr).save(os.path.join(root, "images", name))
        images.append({"id": i, "file_name": name, "height": h, "width": w})
        # one rectangle annotation per image, class round-robin
        x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
        x1, y1 = x0 + int(rng.integers(8, w // 2)), y0 + int(rng.integers(8, h // 2))
        annotations.append({
            "id": i, "image_id": i, "category_id": (i % n_classes) + 1,
            "segmentation": [[x0, y0, x1, y0, x1, y1, x0, y1]],
        })
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": c + 1, "name": COCO_CLASSES[c]}
                          for c in range(n_classes)]}
    path = os.path.join(root, "instances.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path
