"""TP-Dataset loader with the reference's file layout (port of
``egm_unet_tpu/data/dataset.py::DriveDataset``):

    {root}/TP-Dataset/Index/{train,val,predict}.txt  names, one per line
    {root}/TP-Dataset/JPEGImages/{name}.jpg
    {root}/TP-Dataset/GroundTruth/{name}.png         mask, 255 = foreground

Masks are binarized to {0, 1} by / 255 and a clip.
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

    def __getitem__(self, idx: int):
        from PIL import Image

        image = np.asarray(Image.open(self.img_list[idx]).convert("RGB"))
        mask = np.asarray(Image.open(self.mask_list[idx]).convert("L"))
        target = np.clip(mask.astype(np.float32) / 255.0, 0, 1).astype(np.uint8)
        if self.transforms is not None:
            return self.transforms(image, target)
        return image, target
