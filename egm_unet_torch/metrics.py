"""Evaluation metrics: the confusion matrix and the dice coefficient (port of
``egm_unet_tpu/metrics.py``).  State is a plain int64 tensor, or a
``DiceState``, that the caller threads through the updates; both stay on the
device they were made on until the caller reads them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from egm_unet_torch.losses import build_target, multiclass_dice_coeff


def confmat_init(num_classes: int, device=None) -> torch.Tensor:
    return torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)


def confmat_update(mat: torch.Tensor, target: torch.Tensor,
                   pred: torch.Tensor) -> torch.Tensor:
    """Bincount update ``n * target + pred``.  ``target`` and ``pred`` are
    integer tensors of one shape; targets outside ``[0, n)`` (the 255 ignore
    fill) are dropped."""
    n = mat.shape[0]
    t = target.reshape(-1).long()
    p = pred.reshape(-1).long()
    keep = (t >= 0) & (t < n)
    counts = torch.bincount(n * t[keep] + p[keep], minlength=n * n)
    return mat + counts.reshape(n, n).to(mat.device)


def confmat_compute(mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(global accuracy, per-class accuracy, per-class IoU), float64."""
    h = mat.double()
    diag = torch.diag(h)
    acc_global = diag.sum() / h.sum().clamp_min(1e-12)
    acc = diag / h.sum(dim=1).clamp_min(1e-12)
    iu = diag / (h.sum(dim=1) + h.sum(dim=0) - diag).clamp_min(1e-12)
    return acc_global, acc, iu


def confmat_str(mat) -> str:
    """The block the reference prints into its record files."""
    acc_global, acc, iu = confmat_compute(torch.as_tensor(mat))
    return (
        "global correct: {:.1f}\n"
        "average row correct: {}\n"
        "IoU: {}\n"
        "mean IoU: {:.1f}"
    ).format(
        acc_global.item() * 100,
        [f"{i:.1f}" for i in (acc * 100).tolist()],
        [f"{i:.1f}" for i in (iu * 100).tolist()],
        iu.mean().item() * 100,
    )


@dataclass(frozen=True)
class DiceState:
    cumulative: torch.Tensor  # float32 scalar
    count: torch.Tensor  # int32 scalar

    @property
    def value(self) -> torch.Tensor:
        return torch.where(self.count == 0, torch.zeros_like(self.cumulative),
                           self.cumulative / self.count.clamp_min(1))


def dice_init(device=None) -> DiceState:
    return DiceState(torch.zeros((), dtype=torch.float32, device=device),
                     torch.zeros((), dtype=torch.int32, device=device))


def dice_update(state: DiceState, logits: torch.Tensor, target: torch.Tensor,
                ignore_index: int = 255) -> DiceState:
    """Mean foreground dice of the argmax prediction over the channels after
    the background one (the reference's ``pred[:, 1:]``), one count per
    batch."""
    num_classes = logits.shape[-1]
    pred = F.one_hot(logits.argmax(dim=-1), num_classes).float()
    tgt = build_target(target, num_classes, ignore_index)
    d = multiclass_dice_coeff(pred[..., 1:], tgt[..., 1:], ignore_index=ignore_index)
    return DiceState(state.cumulative + d, state.count + 1)
