"""Train and eval steps (port of ``egm_unet_tpu/engine/train.py``), on one
device or data-parallel over a group of ranks.

A step takes the ``TrainState`` of ``engine/state.py`` and a batch on the
model's device: NHWC images (float, or raw uint8 with ``normalize``) and
``[B, H, W]`` integer targets (255 = ignore).  It puts the model in train
mode, runs forward and backward under ``torch.enable_grad()``, updates the
BatchNorm running statistics as the forward goes, and makes one SGD update.
``aux["loss"]`` stays a device tensor, so a step never waits for the device;
``aux["lr"]`` is ``schedule(step)`` after the step, as the JAX step reports it.

The training graph (``create_model(..., fold_bn=False)``) launches no
hand-written kernel, as the JAX package's BatchNorm graph reaches no Pallas
kernel; ``--amp`` is ``input_dtype=torch.bfloat16``: every conv then
computes in bfloat16 on float32 parameters, BatchNorm and the losses in
float32.

Data parallel (``group``, a ``parallel.DataGroup``; the JAX package's
``jit_sharded`` step over a mesh): each rank gets its rows of the global
batch (``parallel.shard_batch``) and computes, under ``use_data_group``, the
BatchNorms over the global batch (sync-BN) and its part of the global
batch's loss (``losses.criterion``); one flat all-reduce after the backward
pass sums the gradients and the parts of the loss, and every rank makes the
same update.  The step then equals the one-device step on the global batch:
``aux["loss"]`` is the global batch's loss on every rank.

Spatial parallel (``spatial``, a grid's row of spatial ranks; the JAX
package's step under ``get_mesh_sp``): each rank gets its data rank's rows
of the batch and of those its image rows (``parallel.shard_batch_spatial``),
``group`` spans every rank of the grid, and the step runs under
``use_spatial_group`` at the input's global height (gathered from the
ranks' row counts on the host, checked against ``row_range``'s split): the
ops exchange their halos (``parallel/halo.py``), the BatchNorms and the
loss reduce over every rank, and the gradients are summed over every rank,
each of which holds a whole replica of the parameters.  A checkpointed
(remat) block fetches its halos again in the backward pass, in the same
order on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from egm_unet_torch import losses as L
from egm_unet_torch import metrics as M
from egm_unet_torch.data.transforms import device_normalize
from egm_unet_torch.parallel.mesh import (DataGroup, all_reduce_grads, global_height,
                                          use_data_group, use_spatial_group)


def _inputs(images, normalize, input_dtype):
    if normalize is not None:
        return device_normalize(images, *normalize, dtype=input_dtype)
    return images.to(input_dtype) if input_dtype is not None else images


def _loss(model, images, targets, num_classes, dice, ignore_index):
    weight = L.default_loss_weight(num_classes, images.device)
    return L.criterion(model(images), targets, weight, num_classes, dice=dice,
                       ignore_index=ignore_index)


def _reduce(state, group: Optional[DataGroup], loss: torch.Tensor) -> torch.Tensor:
    """Under a data group: the gradients of the optimiser's parameters and
    this rank's part of the loss summed over the group (one all-reduce);
    returns the global loss."""
    if group is None:
        return loss
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    return all_reduce_grads(params, group, loss)[0]


def _groups(group: Optional[DataGroup], spatial: Optional[DataGroup], images):
    """The context of a step: the data group, and the spatial group at the
    input's global height."""
    if spatial is None:
        return use_data_group(group)
    if group is None:
        raise ValueError("a spatial step needs the grid's whole group as its data group")
    stack = contextlib.ExitStack()
    stack.enter_context(use_data_group(group))
    stack.enter_context(use_spatial_group(spatial, global_height(spatial, images.shape[-3])))
    return stack


def make_train_step(num_classes: int = 2, dice: bool = True,
                    ignore_index: int = 255, normalize=None, input_dtype=None,
                    group: Optional[DataGroup] = None,
                    spatial: Optional[DataGroup] = None):
    """Returns ``step(state, images, targets) -> (state, aux)``.
    ``normalize=(mean, std)``: images arrive as raw uint8 and are normalised
    on the device; ``input_dtype``: the compute dtype the images are cast
    to; ``group``: data parallel, the images and targets this rank's rows of
    the global batch; ``spatial``: also row-split over this group of a grid
    whose every rank ``group`` spans (the module docstring)."""

    def train_step(state, images, targets):
        model = state.model
        model.train()
        # the groups stay set through backward(): the recomputed forwards
        # of checkpointed blocks all-reduce their BatchNorms' sums again
        with torch.enable_grad(), _groups(group, spatial, images):
            x = _inputs(images, normalize, input_dtype)
            loss = _loss(model, x, targets.long(), num_classes, dice, ignore_index)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        loss = _reduce(state, group, loss.detach())
        state.apply_gradients()
        return state, {"loss": loss, "lr": state.lr_fn(state.step)}

    return train_step


def make_train_step_accum(accum: int, num_classes: int = 2, dice: bool = True,
                          ignore_index: int = 255, normalize=None,
                          input_dtype=None, group: Optional[DataGroup] = None,
                          spatial: Optional[DataGroup] = None):
    """Gradient accumulation: the batch of B splits into ``accum``
    microbatches of B / accum, run one after another.  Each forward
    normalises with its microbatch's BatchNorm statistics and updates the
    running ones in order; the gradients are summed, divided by ``accum``
    and applied in one update; ``aux["loss"]`` is the mean of the
    microbatches' losses (the first-sample quirk of ``lap_loss`` takes the
    first sample of each microbatch).  B % accum != 0 raises ValueError.
    With ``group``, this rank's rows are laid out by microbatch
    (``parallel.shard_batch(..., accum=accum)``): its i-th slice of B /
    accum rows is its share of the global microbatch i."""

    def train_step(state, images, targets):
        batch = images.shape[0]
        if batch % accum:
            raise ValueError(f"batch {batch} not divisible by accum {accum}")
        mb = batch // accum
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        lsum = torch.zeros((), dtype=torch.float32, device=images.device)
        with torch.enable_grad(), _groups(group, spatial, images):
            x = _inputs(images, normalize, input_dtype)
            t = targets.long()
            for i in range(accum):
                sl = slice(i * mb, (i + 1) * mb)
                loss = _loss(model, x[sl], t[sl], num_classes, dice, ignore_index)
                loss.backward()
                lsum = lsum + loss.detach()
        lsum = _reduce(state, group, lsum)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(accum)
        state.apply_gradients()
        return state, {"loss": lsum / accum, "lr": state.lr_fn(state.step)}

    return train_step


def make_train_multistep(num_classes: int = 2, dice: bool = True,
                         ignore_index: int = 255, normalize=None,
                         input_dtype=None, accum: int = 1,
                         group: Optional[DataGroup] = None,
                         spatial: Optional[DataGroup] = None):
    """K train steps per call: ``(state, images[K, B, ...], targets[K, B,
    ...]) -> (state, aux)`` with ``aux["loss"]`` a [K] tensor and
    ``aux["lr"]`` a list of K rates, equal to K calls of the single step
    (``accum > 1``: of the accumulation step; ``group``: K data-parallel
    steps on this rank's rows, ``parallel.shard_superbatch``; ``spatial``:
    row-split, ``parallel.shard_superbatch_spatial``)."""
    if accum > 1:
        step = make_train_step_accum(accum, num_classes, dice, ignore_index,
                                     normalize, input_dtype, group, spatial)
    else:
        step = make_train_step(num_classes, dice, ignore_index, normalize,
                               input_dtype, group, spatial)

    def multi_step(state, images, targets):
        losses, lrs = [], []
        for k in range(images.shape[0]):
            state, aux = step(state, images[k], targets[k])
            losses.append(aux["loss"])
            lrs.append(aux["lr"])
        return state, {"loss": torch.stack(losses), "lr": lrs}

    return multi_step


def make_eval_step(num_classes: int = 2, ignore_index: int = 255,
                   normalize=None, input_dtype=None):
    """Returns ``step(state, images, targets, confmat, dice) -> (confmat,
    dice)``: the model in eval mode (running statistics), argmax, the
    confusion matrix and the dice state updated on the device."""

    @torch.no_grad()
    def eval_step(state, images, targets, confmat, dice_state):
        model = state.model
        model.eval()
        logits = model(_inputs(images, normalize, input_dtype))["out"]
        targets = targets.long()
        confmat = M.confmat_update(confmat, targets, logits.argmax(dim=-1))
        dice_state = M.dice_update(dice_state, logits, targets, ignore_index)
        return confmat, dice_state

    return eval_step


def eval_step(state, images, targets, confmat, dice_state, num_classes: int = 2,
              ignore_index: int = 255):
    """One eval batch: ``make_eval_step(num_classes, ignore_index)``'s step
    called once (the JAX package's jitted ``eval_step``)."""
    return make_eval_step(num_classes, ignore_index)(state, images, targets, confmat,
                                                     dice_state)


def reduce_eval(confmat: torch.Tensor, dice_state: M.DiceState,
                group: Optional[DataGroup]):
    """The confusion matrix and dice state of every rank's eval batches
    summed over ``group``: the one-process matrix exactly, its dice to
    float32 roundoff (a sum in another order).  As they are without a
    group."""
    if group is None:
        return confmat, dice_state
    confmat = group.all_reduce(confmat.clone())
    total = group.all_reduce(torch.stack([dice_state.cumulative.double(),
                                          dice_state.count.double()]))
    return confmat, M.DiceState(total[0].float(), total[1].to(torch.int32))
