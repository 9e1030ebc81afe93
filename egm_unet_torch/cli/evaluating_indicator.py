"""Offline PNG-vs-PNG evaluator (port of
``egm_unet_tpu/cli/evaluating_indicator.py``, the same flags and output):
``fast_hist`` confusion over a name list with /255 binarization, per-class
IoU / recall / precision / accuracy, F-beta and dice, shape-mismatch skip,
progress prints, a tee of stdout into ``--log-path``, the confusion CSV and
optional matplotlib bars (skipped when matplotlib is absent).

The masks are decoded on the host (PIL) and binarized and counted with
``torch.bincount`` on ``--device`` (default: the CUDA device; ``cpu`` on a
machine without one): the same integer counts as the numpy version.

    python -m egm_unet_torch.cli.evaluating_indicator --gt-dir GT \\
        --txt-dir val.txt --pred-dir predict/test
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch


class Logger:
    """Tee stdout to a log file."""

    def __init__(self, filename: str):
        self.terminal = sys.stdout
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        self.log = open(filename, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()


def fast_hist(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """[n, n] int64 confusion of integer labels ``a`` (rows) and ``b``
    (columns) by ``torch.bincount`` on their device; labels of ``a`` outside
    [0, n) are dropped."""
    k = (a >= 0) & (a < n)
    return torch.bincount(n * a[k].long() + b[k].long(), minlength=n ** 2).reshape(n, n)


def per_class_iu(hist):
    hist = np.asarray(hist)
    return np.diag(hist) / np.maximum(hist.sum(1) + hist.sum(0) - np.diag(hist), 1)


def per_class_pa_recall(hist):
    hist = np.asarray(hist)
    return np.diag(hist) / np.maximum(hist.sum(1), 1)


def per_class_precision(hist):
    hist = np.asarray(hist)
    return np.diag(hist) / np.maximum(hist.sum(0), 1)


def per_accuracy(hist):
    hist = np.asarray(hist)
    return np.sum(np.diag(hist)) / np.maximum(np.sum(hist), 1)


def f_score(precision, recall, beta: float = 1.0):
    """F-beta of precision and recall."""
    return ((1 + beta ** 2) * precision * recall /
            np.maximum(beta ** 2 * precision + recall, 1e-12))


def dice_equation(inter, a_sum, b_sum, eps=1e-6):
    return (2 * inter + eps) / (a_sum + b_sum + eps)


def binarize(mask: np.ndarray, device) -> torch.Tensor:
    """A 0..255 grayscale mask -> flat int64 labels round(clip(v / 255,
    0, 1)) on ``device``."""
    t = torch.from_numpy(np.array(mask)).to(device).double() / 255.0
    return torch.round(torch.clamp(t, 0, 1)).long().flatten()


def compute_miou(gt_dir: str, pred_dir: str, name_list, num_classes: int = 2,
                 print_every: int = 10, device=None):
    """(int64 [C, C] numpy confusion, skipped count) over ``name_list``:
    ``<name>.png`` in both folders, /255 binarization, a pair of another
    shape skipped, the running mIoU printed every ``print_every`` names.
    ``device``: default the CUDA device."""
    from PIL import Image

    from egm_unet_torch.device import resolve_device

    device = resolve_device(device)
    hist = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    skipped = 0
    for i, name in enumerate(name_list):
        gt_path = os.path.join(gt_dir, f"{name}.png")
        pred_path = os.path.join(pred_dir, f"{name}.png")
        if not (os.path.exists(gt_path) and os.path.exists(pred_path)):
            skipped += 1
            continue
        gt = np.asarray(Image.open(gt_path).convert("L"))
        pred = np.asarray(Image.open(pred_path).convert("L"))
        if gt.shape != pred.shape:
            print(f"skip {name}: shape {gt.shape} vs {pred.shape}")
            skipped += 1
            continue
        hist += fast_hist(binarize(gt, device), binarize(pred, device), num_classes)
        if (i + 1) % print_every == 0:
            print(f"[{i + 1}/{len(name_list)}] mIoU "
                  f"{100 * np.nanmean(per_class_iu(hist.cpu().numpy())):.2f}")
    return hist.cpu().numpy(), skipped


def write_confusion_csv(hist, classes, path):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + list(classes))
        for cls, row in zip(classes, hist):
            w.writerow([cls] + list(map(int, row)))


def maybe_plot_bars(values, labels, title, path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(6, 4))
        plt.bar(labels, values)
        plt.title(title)
        plt.savefig(path, bbox_inches="tight")
        plt.close()
    except ImportError:
        pass  # plots are optional


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt-dir", default="dataset/TP-Dataset/GroundTruth")
    p.add_argument("--txt-dir", default="dataset/TP-Dataset/Index/val.txt")
    p.add_argument("--pred-dir", default="predict/test")
    p.add_argument("--log-path", default="logs/eval.log")
    p.add_argument("--out-dir", default="logs")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA device; 'cpu' counts on the host")
    args = p.parse_args(argv)

    from egm_unet_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"evaluating_indicator: {e}")
    classes = ["_background_", "Tactile_paving"]

    with open(args.txt_dir) as f:
        names = [ln.strip() for ln in f if ln.strip()]

    tee = Logger(args.log_path)
    sys.stdout = tee
    try:
        hist, skipped = compute_miou(args.gt_dir, args.pred_dir, names, len(classes),
                                     device=device)
        iu = per_class_iu(hist)
        recall = per_class_pa_recall(hist)
        precision = per_class_precision(hist)
        print(f"mIoU: {100 * np.nanmean(iu):.2f}")
        print(f"mPA (recall): {100 * np.nanmean(recall):.2f}")
        print(f"precision: {100 * np.nanmean(precision):.2f}")
        print(f"accuracy: {100 * per_accuracy(hist):.2f}")
        print(f"F1: {100 * np.nanmean(f_score(precision, recall)):.2f}")
        print(f"skipped: {skipped}")

        os.makedirs(args.out_dir, exist_ok=True)
        write_confusion_csv(hist, classes,
                            os.path.join(args.out_dir, "confusion_matrix.csv"))
        maybe_plot_bars(iu * 100, classes, "IoU", os.path.join(args.out_dir, "mIoU.png"))
        maybe_plot_bars(recall * 100, classes, "Recall",
                        os.path.join(args.out_dir, "recall.png"))
    finally:
        sys.stdout = tee.terminal
        tee.log.close()
    return hist


if __name__ == "__main__":
    main()
