"""Per-channel mean and std over a dataset's region of interest (port of
``egm_unet_tpu/cli/compute_mean_std.py``, the same output; the reference
produced the TP statistics (0.709, 0.381, 0.224) / (0.127, 0.079, 0.043)
this way).  The ROI is the pixels where the mask is nonzero when masks
exist, else the whole image.  The sums accumulate in float64 with torch on
``--device`` (default: the CUDA device).

    python -m egm_unet_torch.cli.compute_mean_std --img-dir JPEGImages \\
        --mask-dir GroundTruth
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def compute_mean_std(img_dir: str, mask_dir: str | None = None, names=None,
                     device=None):
    """(mean, std) float64 numpy arrays of 3 channels in [0, 1] units."""
    from PIL import Image

    from egm_unet_torch.device import resolve_device

    device = resolve_device(device)
    if names is None:
        names = sorted(os.path.splitext(f)[0] for f in os.listdir(img_dir)
                       if f.lower().endswith((".jpg", ".png", ".jpeg")))
    total = torch.zeros(3, dtype=torch.float64, device=device)
    total_sq = torch.zeros(3, dtype=torch.float64, device=device)
    count = 0
    for name in names:
        for ext in (".jpg", ".png", ".jpeg"):
            path = os.path.join(img_dir, name + ext)
            if os.path.exists(path):
                break
        else:
            continue
        img = np.asarray(Image.open(path).convert("RGB"))
        pix = torch.from_numpy(img.copy()).to(device).double() / 255.0
        mpath = os.path.join(mask_dir, name + ".png") if mask_dir else None
        if mpath and os.path.exists(mpath):
            roi = np.asarray(Image.open(mpath).convert("L")) > 0
            pix = pix[torch.from_numpy(roi).to(device)]
        else:
            pix = pix.reshape(-1, 3)
        total += pix.sum(0)
        total_sq += (pix ** 2).sum(0)
        count += pix.shape[0]
    mean = total / max(count, 1)
    std = torch.sqrt(total_sq / max(count, 1) - mean ** 2)
    return mean.cpu().numpy(), std.cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--img-dir", default="dataset/TP-Dataset/JPEGImages")
    p.add_argument("--mask-dir", default=None)
    p.add_argument("--device", default=None,
                   help="default: the current CUDA device; 'cpu' sums on the host")
    args = p.parse_args(argv)
    try:
        mean, std = compute_mean_std(args.img_dir, args.mask_dir, device=args.device)
    except RuntimeError as e:
        raise SystemExit(f"compute_mean_std: {e}")
    print(f"mean: {tuple(round(float(m), 3) for m in mean)}")
    print(f"std:  {tuple(round(float(s), 3) for s in std)}")


if __name__ == "__main__":
    main()
