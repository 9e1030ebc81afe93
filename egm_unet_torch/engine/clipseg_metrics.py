"""Fixed-interval evaluation metrics for CLIPSeg on PhraseCut (port of
``egm_unet_tpu/engine/clipseg_metrics.py``): binary confusion counts over a
fixed grid of sigmoid thresholds, accumulated over batches, from which
fgIoU at a threshold, binary mIoU and average precision follow (the
columns pc_miou_0.3 / pc_fgiou_0.3 / pc_fgiou_0.5 / pc_ap of the reference's
PhraseCut configuration)."""

from __future__ import annotations

from typing import Dict

import torch

# i * float32(0.05): the JAX package's ``jnp.linspace(0, 1, 21)`` bit for
# bit (``torch.linspace`` rounds two of the 21 points the other way)
DEFAULT_GRID = torch.arange(21, dtype=torch.float32) * torch.tensor(0.05)


def threshold_counts(probs: torch.Tensor, segs: torch.Tensor,
                     grid: torch.Tensor = DEFAULT_GRID) -> Dict[str, torch.Tensor]:
    """``{"tp", "fp", "fn", "tn"}``, each [T] over the threshold grid, for
    one batch.  ``probs``: sigmoid outputs in [0, 1]; ``segs``: {0, 1}
    targets."""
    gt = (segs > 0.5).reshape(1, -1)
    pred = probs.reshape(1, -1) >= grid.to(probs.device, probs.dtype)[:, None]
    return {"tp": (pred & gt).sum(dim=1), "fp": (pred & ~gt).sum(dim=1),
            "fn": (~pred & gt).sum(dim=1), "tn": (~pred & ~gt).sum(dim=1)}


def accumulate(total, batch):
    if total is None:
        return batch
    return {k: total[k] + batch[k] for k in total}


def fixed_interval_metrics(total: Dict[str, torch.Tensor],
                           grid: torch.Tensor = DEFAULT_GRID) -> Dict[str, float]:
    tp, fp, fn, tn = (total[k].double().cpu() for k in ("tp", "fp", "fn", "tn"))
    grid = grid.double().cpu()
    fg_iou = tp / torch.clamp(tp + fp + fn, min=1)
    bg_iou = tn / torch.clamp(tn + fp + fn, min=1)
    miou = 0.5 * (fg_iou + bg_iou)
    precision = tp / torch.clamp(tp + fp, min=1)
    recall = tp / torch.clamp(tp + fn, min=1)

    # AP over the sweep's precision-recall curve: the precision envelope
    # (the largest precision at recall >= r) and a recall-0 anchor
    order = torch.argsort(recall, stable=True)
    r, p = recall[order], precision[order]
    p_env = torch.flip(torch.cummax(torch.flip(p, [0]), dim=0).values, [0])
    r_prev = torch.cat([torch.zeros(1, dtype=r.dtype), r[:-1]])
    ap = torch.sum((r - r_prev) * p_env)

    def at(metric, t):
        return float(metric[int(torch.argmin(torch.abs(grid - t)))])

    return {
        "fgiou_0.3": at(fg_iou, 0.3),
        "fgiou_0.5": at(fg_iou, 0.5),
        "miou_0.3": at(miou, 0.3),
        "ap": float(ap),
        "best_fgiou": float(fg_iou.max()),
        "best_threshold": float(grid[int(torch.argmax(fg_iou))]),
    }
