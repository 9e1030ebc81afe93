"""Logit-fusion ensemble: ``fused = clip_logits + alpha * unet_logits`` with
an alpha searched on the validation set (port of
``egm_unet_tpu/engine/fusion.py``; ``best_alpha.txt`` contract).

Per batch, one confusion matrix per alpha; the sweep over the 100 alphas is a
loop over chunks of alphas (a [chunk, B, H, W, C] tensor at a time: all 100
at once would be gigabytes at 565x752).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from egm_unet_torch import metrics as M

ALPHA_CHUNK = 4  # alphas fused at once


def fuse_logits(clip_logits: torch.Tensor, unet_logits: torch.Tensor,
                alpha) -> torch.Tensor:
    alpha = torch.as_tensor(alpha, dtype=clip_logits.dtype, device=clip_logits.device)
    return clip_logits + alpha * unet_logits


def fused_confmats(clip_logits: torch.Tensor, unet_logits: torch.Tensor,
                   labels: torch.Tensor, alphas: torch.Tensor,
                   num_classes: int = 2) -> torch.Tensor:
    """[A, C, C] confusion matrices for every alpha over one batch.

    ``clip_logits`` / ``unet_logits``: [B, H, W, C], already at the label
    size; ``labels``: [B, H, W] integers (255 = ignore); ``alphas``: [A]."""
    n = num_classes
    t = labels.reshape(-1).long()
    keep = (t >= 0) & (t < n)
    t = t[keep]
    out = torch.zeros((alphas.shape[0], n, n), dtype=torch.int64,
                      device=clip_logits.device)
    for s in range(0, alphas.shape[0], ALPHA_CHUNK):
        a = alphas[s:s + ALPHA_CHUNK].to(clip_logits.dtype)
        fused = clip_logits[None] + a[:, None, None, None, None] * unet_logits[None]
        pred = fused.argmax(dim=-1).reshape(a.shape[0], -1)[:, keep]
        # one bincount for the chunk: alpha index * n^2 + n * target + pred
        offs = torch.arange(a.shape[0], device=pred.device)[:, None] * (n * n)
        counts = torch.bincount((offs + n * t[None] + pred).reshape(-1),
                                minlength=a.shape[0] * n * n)
        out[s:s + a.shape[0]] = counts.reshape(a.shape[0], n, n)
    return out


def search_best_alpha(pairs, num_classes: int = 2,
                      alpha_range: Tuple[float, float] = (0.1, 10.0),
                      num_alphas: int = 100):
    """Global mIoU over the whole validation set for each alpha of the
    reference's grid (linspace 0.1..10, 100 points).  ``pairs``: an iterable
    of ``(clip_logits, unet_logits, labels)`` batches.  Returns
    ``(best_alpha, best_miou, per_alpha_miou)``."""
    alphas = None
    total = None
    for clip_logits, unet_logits, labels in pairs:
        if alphas is None:
            alphas = torch.linspace(alpha_range[0], alpha_range[1], num_alphas,
                                    dtype=torch.float32, device=clip_logits.device)
            total = torch.zeros((num_alphas, num_classes, num_classes),
                                dtype=torch.int64, device=clip_logits.device)
        total += fused_confmats(clip_logits, unet_logits, labels, alphas, num_classes)
    if alphas is None:
        raise ValueError("search_best_alpha needs at least one batch")
    mious = torch.stack([torch.nanmean(M.confmat_compute(m)[2]) for m in total])
    best = int(mious.argmax())
    return float(alphas[best]), float(mious[best]), mious


def save_alpha(alpha: float, path: str = "best_alpha.txt") -> None:
    with open(path, "w") as f:
        f.write(f"{alpha}\n")


def load_alpha(path: str = "best_alpha.txt", default: float = 0.5) -> float:
    """The stored alpha, or ``default`` when the file is absent."""
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return float(f.read().strip())
