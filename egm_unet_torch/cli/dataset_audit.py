"""Dataset audit tool (port of ``egm_unet_tpu/cli/dataset_audit.py``, the
same output): walk a folder of masks, histogram the grayscale pixel values,
list the files that hold 255, report unreadable files.  Each file's values
are counted with ``torch.bincount`` on ``--device`` (default: the CUDA
device), the histogram summed there.

    python -m egm_unet_torch.cli.dataset_audit dataset/TP-Dataset/GroundTruth
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def analyze_pixel_values(folder: str, device=None):
    """``{"n_files", "histogram" (value -> count, ascending, values present
    only), "files_with_255", "unreadable" [(path, error)]}``."""
    from PIL import Image

    from egm_unet_torch.device import resolve_device

    device = resolve_device(device)
    files_with_255 = []
    unreadable = []
    hist = torch.zeros(256, dtype=torch.int64, device=device)
    n_files = 0
    for root, _, files in os.walk(folder):
        for fname in sorted(files):
            if not fname.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
                continue
            path = os.path.join(root, fname)
            try:
                arr = np.asarray(Image.open(path).convert("L"))
            except Exception as e:  # noqa: BLE001 -- report, as the reference does
                unreadable.append((path, str(e)))
                continue
            n_files += 1
            counts = torch.bincount(torch.from_numpy(arr.copy()).to(device).flatten().long(),
                                    minlength=256)
            hist += counts
            if int(counts[255]):
                files_with_255.append(path)
    hist = hist.cpu().numpy()
    return {"n_files": n_files,
            "histogram": {int(v): int(hist[v]) for v in np.flatnonzero(hist)},
            "files_with_255": files_with_255, "unreadable": unreadable}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("folder")
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--device", default=None,
                   help="default: the current CUDA device; 'cpu' counts on the host")
    args = p.parse_args(argv)
    try:
        rep = analyze_pixel_values(args.folder, args.device)
    except RuntimeError as e:
        raise SystemExit(f"dataset_audit: {e}")
    print(f"files analyzed: {rep['n_files']}")
    print(f"files containing 255: {len(rep['files_with_255'])}")
    for path in rep["files_with_255"][:10]:
        print(f"  {path}")
    print("pixel-value histogram (top values):")
    for v, c in list(rep["histogram"].items())[: args.top]:
        print(f"  {v}: {c}")
    if rep["unreadable"]:
        print(f"unreadable files: {len(rep['unreadable'])}")
        for path, err in rep["unreadable"]:
            print(f"  {path}: {err}")


if __name__ == "__main__":
    main()
