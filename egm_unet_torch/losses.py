"""Training losses (port of ``egm_unet_tpu/losses.py``).

The total criterion is, per output head,

    CE(x, t, weight, ignore=255) + dice_loss + 1.0 * laplace_loss(x)
    + lap_loss(x, t) + sobel_loss(x, t)

with the reference's quirks kept on purpose:

- ``sobel_loss`` is called with its arguments swapped relative to the
  reference's signature (the logits land in ``y_true``); the call semantics
  are kept, not the names;
- ``lap_loss`` and ``sobel_loss`` narrow the *target* to the first batch
  element and broadcast it against every prediction of the batch;
- ``dice_coeff`` replaces a zero denominator with ``2 * inter``;
- class weights [1, 2] iff there are 2 classes;
- the weighted cross-entropy mean divides by the sum of the pixel weights.

Every mean is a sum over the batch divided by the batch's count.  Under a
data group (``parallel.data_group()``, set by the train step) each rank holds
its rows of the global batch and ``criterion`` gives this rank's part: its
rows' sums over the global batch's counts (B, B·H·W, the sum of the pixel
weights), against the global batch's first target, so that the parts sum
over the ranks to the loss of the global batch.  One all-reduce per call
brings the sum of the pixel weights and the first target (rank 0's) to every
rank.

Under a spatial group as well (``parallel.spatial()``) each rank holds its
rows of its data rank's images, and the data group spans every rank: the
cross-entropy's sums and the stencil losses' means add up over the ranks as
before (the counts are the global batch's: the data ranks' rows times the
global H x W); each sample's dice sums are summed over the spatial group
(``spatial_sum``) and each of its S ranks takes 1 / S of the dice term; the
stencils take their halos; the first target is data rank 0's, reassembled
from its spatial ranks' rows, and the batch counts the data ranks only.

Layout: logits NHWC ``[B, H, W, C]``, any float dtype (cast to float32);
targets ``[B, H, W]`` integers.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from egm_unet_torch.ops.stencil import LAPLACE4, LAPLACE8, SOBEL_X, SOBEL_Y, stencil2d
from egm_unet_torch.parallel.halo import spatial_sum
from egm_unet_torch.parallel.mesh import data_group, spatial

IGNORE_INDEX = 255


def pixel_weights(target: torch.Tensor, num_classes: int,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = IGNORE_INDEX):
    """(one-hot targets, each pixel's class weight: 0 where ignored)."""
    valid = target != ignore_index
    t_safe = torch.where(valid, target, torch.zeros_like(target)).long()
    onehot = F.one_hot(t_safe, num_classes).float()
    w = (torch.ones(num_classes, device=target.device) if weight is None
         else weight.float().to(target.device))
    pix_w = (w * onehot).sum(dim=-1)
    return onehot, torch.where(valid, pix_w, torch.zeros_like(pix_w))


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = IGNORE_INDEX,
                  weight_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted cross-entropy with ``ignore_index``, ``F.cross_entropy``'s
    mean: the sum over valid pixels divided by the sum of their class
    weights (``weight_sum``: that of the global batch; default this
    batch's)."""
    onehot, pix_w = pixel_weights(target, logits.shape[-1], weight, ignore_index)
    nll = -(F.log_softmax(logits.float(), dim=-1) * onehot).sum(dim=-1)
    if weight_sum is None:
        weight_sum = pix_w.sum()
    return (nll * pix_w).sum() / weight_sum.clamp_min(1e-12)


def build_target(target: torch.Tensor, num_classes: int = 2,
                 ignore_index: int = -100) -> torch.Tensor:
    """One-hot NHWC target, ignored positions stamped to ``ignore_index`` in
    every channel."""
    if ignore_index >= 0:
        ignore = target == ignore_index
        cleaned = torch.where(ignore, torch.zeros_like(target), target)
        onehot = F.one_hot(cleaned.long(), num_classes).float()
        return torch.where(ignore[..., None], torch.full_like(onehot, float(ignore_index)),
                           onehot)
    return F.one_hot(target.long(), num_classes).float()


def dice_coeff(x: torch.Tensor, target: torch.Tensor, ignore_index: int = -100,
               epsilon: float = 1e-6, batch: Optional[int] = None) -> torch.Tensor:
    """Per-sample dice inside the region of interest, averaged over the
    batch (summed over these rows, divided by ``batch``, the global batch's
    size; default these rows' count); ``x`` and ``target`` are ``[B, ...]``
    (one channel's probabilities and one-hot targets).  Row-split, each
    sample's sums are summed over the spatial group first."""
    b = x.shape[0]
    xf = x.float().reshape(b, -1)
    tf = target.float().reshape(b, -1)
    roi = ((tf != float(ignore_index)).float() if ignore_index >= 0
           else torch.ones_like(tf))
    sums = torch.stack([(xf * tf * roi).sum(dim=1), (xf * roi).sum(dim=1),
                        (tf * roi).sum(dim=1)])
    if spatial() is not None:
        sums = spatial_sum(sums)
    inter = sums[0]
    sets_sum = sums[1] + sums[2]
    sets_sum = torch.where(sets_sum == 0.0, 2.0 * inter, sets_sum)
    return ((2.0 * inter + epsilon) / (sets_sum + epsilon)).sum() / (batch or b)


def multiclass_dice_coeff(x: torch.Tensor, target: torch.Tensor,
                          ignore_index: int = -100, epsilon: float = 1e-6,
                          batch: Optional[int] = None) -> torch.Tensor:
    """Channel mean of ``dice_coeff``, channels last."""
    num_ch = x.shape[-1]
    total = 0.0
    for c in range(num_ch):
        total = total + dice_coeff(x[..., c], target[..., c], ignore_index, epsilon,
                                   batch)
    return total / num_ch


def dice_loss(logits: torch.Tensor, target_onehot: torch.Tensor,
              multiclass: bool = False, ignore_index: int = -100,
              batch: Optional[int] = None) -> torch.Tensor:
    """``1 - dice``; with ``batch`` (the global batch's size) these rows'
    part of it, ``1 * rows / batch - dice``."""
    probs = F.softmax(logits.float(), dim=-1)
    fn = multiclass_dice_coeff if multiclass else dice_coeff
    share = 1.0 if batch is None else logits.shape[0] / batch
    loss = share - fn(probs, target_onehot, ignore_index=ignore_index, batch=batch)
    sp = spatial()
    # each of a sample's spatial ranks holds the same dice: 1 / S of it each
    return loss if sp is None else loss / sp.group.world


def _mean(t: torch.Tensor, batch: Optional[int]) -> torch.Tensor:
    """The sum of ``t`` ``[B, H, W]`` over the element count of a batch of
    ``batch`` (default B) rows (row-split: of the global height)."""
    sp = spatial()
    per = t.numel() // t.shape[0]
    if sp is not None:
        per = per // t.shape[1] * sp.height
    return t.sum() / (per * (batch or t.shape[0]))


def laplace_loss(logits: torch.Tensor, batch: Optional[int] = None) -> torch.Tensor:
    """mean |Laplacian4(channel-0 logits)|, a smoothness prior."""
    return _mean(stencil2d(logits[..., 0].float(), LAPLACE4).abs(), batch)


def lap_loss(logits: torch.Tensor, target: torch.Tensor,
             batch: Optional[int] = None, first: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """mean |Lap8(pred ch0) - Lap8(target[0])|: the first target of the
    batch (``first``, float ``[1, H, W]``: the global batch's), broadcast
    against every prediction."""
    pred_d2 = stencil2d(logits[..., 0].float(), LAPLACE8)
    truth_d2 = stencil2d(target[:1].float() if first is None else first, LAPLACE8)
    return _mean((pred_d2 - truth_d2).abs(), batch)


def sobel_loss(logits: torch.Tensor, target: torch.Tensor,
               batch: Optional[int] = None, first: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Sobel-response L1 between logits ch0 and the first target, taking
    (logits, target) in the order of the reference's call site."""
    pred = logits[..., 0].float()
    truth = target[:1].float() if first is None else first
    dxp, dyp = stencil2d(pred, SOBEL_X), stencil2d(pred, SOBEL_Y)
    dxt, dyt = stencil2d(truth, SOBEL_X), stencil2d(truth, SOBEL_Y)
    return _mean((dxt - dxp).abs() + (dyt - dyp).abs(), batch)


def _global_batch(target: torch.Tensor, loss_weight, num_classes: int,
                  ignore_index: int):
    """(global batch size, sum of its pixel weights, its first target as
    float ``[1, H, W]``): this batch's own without a data group, else one
    all-reduce of ``[first target (rank 0's; zeros elsewhere), weight
    sum]``.  Row-split, the first target is data rank 0's whole map, each of
    its spatial ranks placing its rows, and this rank keeps its own rows;
    the batch counts the data ranks, ``group.world / S``."""
    _, pix_w = pixel_weights(target, num_classes, loss_weight, ignore_index)
    first = target[:1].float()
    group = data_group()
    if group is None:
        return target.shape[0], pix_w.sum(), first
    sp = spatial()
    n_inner = 1 if sp is None else sp.group.world
    if sp is not None:  # data rank 0's first map, in global rows
        lo, hi = sp.rows
        whole = first.new_zeros((1, sp.height, first.shape[2]))
        whole[:, lo:hi] = first
        first = whole
    if group.rank >= n_inner:  # data rank 0 holds ranks [0, n_inner)
        first = torch.zeros_like(first)
    buf = group.all_reduce(torch.cat([first.reshape(-1), pix_w.sum().reshape(1)]))
    first = buf[:-1].view_as(first)
    if sp is not None:
        first = first[:, lo:hi]
    return target.shape[0] * (group.world // n_inner), buf[-1], first


def criterion(outputs: dict, target: torch.Tensor,
              loss_weight: Optional[torch.Tensor] = None, num_classes: int = 2,
              dice: bool = True, ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Total training loss over the model's output heads (``out`` and, where
    there is one, ``aux`` at weight 0.5).  Under a data group: this rank's
    part of the global batch's loss (the module docstring)."""
    batch, weight_sum, first = _global_batch(target, loss_weight, num_classes,
                                             ignore_index)
    losses = {}
    for name, x in outputs.items():
        loss = cross_entropy(x, target, loss_weight, ignore_index, weight_sum)
        if dice:
            dice_target = build_target(target, num_classes, ignore_index)
            loss = (loss
                    + dice_loss(x, dice_target, multiclass=True,
                                ignore_index=ignore_index, batch=batch)
                    + 1.0 * laplace_loss(x, batch)
                    + lap_loss(x, target, batch, first)
                    + sobel_loss(x, target, batch, first))
        losses[name] = loss
    if len(losses) == 1:
        return losses["out"]
    return losses["out"] + 0.5 * losses["aux"]


@functools.lru_cache(maxsize=None)
def default_loss_weight(num_classes: int, device=None) -> Optional[torch.Tensor]:
    """Class weights [1, 2] iff binary; one tensor per device, made once (a
    train step copies nothing to the device for it).  Do not modify it."""
    if num_classes == 2:
        with torch.inference_mode(False):
            return torch.tensor([1.0, 2.0], dtype=torch.float32, device=device)
    return None
