"""TP-Dataset loader with the reference's file layout (port of
``egm_unet_tpu/data/dataset.py::DriveDataset``):

    {root}/TP-Dataset/Index/{train,val,predict}.txt  names, one per line
    {root}/TP-Dataset/JPEGImages/{name}.jpg
    {root}/TP-Dataset/GroundTruth/{name}.png         mask, 255 = foreground

Masks are binarized to {0, 1} by / 255 and a clip.  ``collate_pad`` pads a
batch of differently sized images for evaluation.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


class DriveDataset:
    def __init__(self, root: str, transforms: Optional[Callable] = None,
                 txt_name: str = "train.txt"):
        data_root = os.path.join(root, "TP-Dataset")
        if not os.path.exists(data_root):
            raise FileNotFoundError(f"path '{data_root}' does not exist.")
        txt_path = os.path.join(data_root, "Index", txt_name)
        if not os.path.exists(txt_path):
            raise FileNotFoundError(f"file '{txt_path}' does not exist.")
        with open(txt_path) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        self.img_list = [os.path.join(data_root, "JPEGImages", f"{n}.jpg") for n in names]
        self.mask_list = [os.path.join(data_root, "GroundTruth", f"{n}.png") for n in names]
        self.names = names
        self.transforms = transforms

    def __len__(self):
        return len(self.img_list)

    def raw(self, idx: int):
        """The uint8 image and {0, 1} mask of sample ``idx``, before
        ``transforms``."""
        from PIL import Image

        image = np.asarray(Image.open(self.img_list[idx]).convert("RGB"))
        mask = np.asarray(Image.open(self.mask_list[idx]).convert("L"))
        return image, np.clip(mask.astype(np.float32) / 255.0, 0, 1).astype(np.uint8)

    def __getitem__(self, idx: int):
        image, target = self.raw(idx)
        if self.transforms is not None:
            return self.transforms(image, target)
        return image, target


def collate_pad(images, targets, pad_multiple: int = 32,
                img_fill: float = 0.0, target_fill: int = 255):
    """Pad lists of HWC images and HW targets to the batch's largest size,
    rounded up to ``pad_multiple``: image fill 0, target fill 255, the
    ignore index of every loss and metric, as the reference's ``cat_list``
    pads.  uint8 images (``wire_uint8``) stay uint8, others become
    float32; targets int32."""
    def rup(v):
        return ((v + pad_multiple - 1) // pad_multiple) * pad_multiple

    mh = rup(max(im.shape[0] for im in images))
    mw = rup(max(im.shape[1] for im in images))
    img_dtype = np.uint8 if images[0].dtype == np.uint8 else np.float32
    batch_img = np.full((len(images), mh, mw, images[0].shape[2]), img_fill,
                        img_dtype)
    batch_tgt = np.full((len(images), mh, mw), target_fill, np.int32)
    for i, (im, tg) in enumerate(zip(images, targets)):
        batch_img[i, : im.shape[0], : im.shape[1]] = im
        if tg is not None:
            batch_tgt[i, : tg.shape[0], : tg.shape[1]] = tg
    return batch_img, batch_tgt
