"""Rank functions of the data-, spatial- and tensor-parallel tests
(``tests/test_torch_dp*.py``, ``tests/test_torch_sp_*.py``,
``tests/test_torch_tp.py``).

Each runs on one rank of a 2-rank gloo group (or a 1 x 2 grid) started by
``egm_unet_torch.parallel.launch`` and returns numpy arrays for the test
process to compare.  This module imports no JAX: the ranks are spawned
processes that import it afresh, and the JAX references are computed in
the test process."""

from __future__ import annotations

import numpy as np
import torch

from egm_unet_torch import losses as L
from egm_unet_torch import metrics as M
from egm_unet_torch.engine import (create_train_state, make_train_multistep,
                                   make_train_step, make_train_step_accum,
                                   reduce_eval, warmup_poly_schedule)
from egm_unet_torch.engine.longclip_train import make_longclip_loss_fn
from egm_unet_torch.models import create_model
from egm_unet_torch.models.clip.model import CLIP, CLIPConfig
from egm_unet_torch.nn.layers import BatchNorm
from egm_unet_torch.ops.conv import conv2d
from egm_unet_torch.ops.pooling import avg_pool2d, max_pool2d, min_pool2d
from egm_unet_torch.parallel import (all_reduce_grads, fetch_rows, gather_clip_state,
                                     row_range, shard_batch, shard_batch_spatial,
                                     shard_clip, shard_superbatch, use_data_group,
                                     use_spatial_group)

# egm_unet at base_c 8 (tests/torch_train_util.py), no warm-up, base rate 5e-4
BASE_C = 8
SCHED = dict(base_lr=5e-4, num_step=5, epochs=3, warmup=False)


def _setup():
    torch.set_num_threads(1)
    torch.set_grad_enabled(True)


def _numpy(d: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def bn_loss_eval(group, bn_case, loss_case, eval_case) -> dict:
    """Sync-BN, the criterion and the eval reduction on this rank's rows.

    ``bn_case``: (x [B, H, W, C], scale, bias, w) float64: this rank's
    output, running statistics and the gradients of x, scale and bias of
    ``sum(y * w)``.  ``loss_case``: (out, aux, targets): this rank's part of
    the criterion and its gradient with respect to both heads' logits.
    ``eval_case``: a list of (logits, targets) eval batches, taken by the
    ranks in turn: the confusion matrix and dice after ``reduce_eval``."""
    _setup()
    out = {}
    x, scale, bias, w = (torch.from_numpy(a) for a in bn_case)
    bn = BatchNorm(x.shape[-1]).double()
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
    xl, wl = shard_batch(group, x, w)
    xl = xl.clone().requires_grad_(True)
    with use_data_group(group):
        y = bn(xl)
        (y * wl).sum().backward()
    out["bn"] = {"y": y.detach().numpy(), "gx": xl.grad.numpy(),
                 "gscale": bn.scale.grad.numpy(), "gbias": bn.bias.grad.numpy(),
                 "mean": bn.mean.numpy(), "var": bn.var.numpy(),
                 "collectives": group.collectives}

    logits_out, logits_aux, targets = (torch.from_numpy(a) for a in loss_case)
    lo, la, t = shard_batch(group, logits_out, logits_aux, targets)
    lo, la = lo.clone().requires_grad_(True), la.clone().requires_grad_(True)
    weight = L.default_loss_weight(2)
    with use_data_group(group):
        part = L.criterion({"out": lo, "aux": la}, t.long(), weight, 2)
    part.backward()
    out["loss"] = {"part": float(part), "gout": lo.grad.numpy(), "gaux": la.grad.numpy()}

    confmat, dice = M.confmat_init(2), M.dice_init()
    for i in range(group.rank, len(eval_case), group.world):
        logits, tg = (torch.from_numpy(a) for a in eval_case[i])
        confmat = M.confmat_update(confmat, tg.long(), logits.argmax(dim=-1))
        dice = M.dice_update(dice, logits, tg.long())
    confmat, dice = reduce_eval(confmat, dice, group)
    out["eval"] = {"confmat": confmat.numpy(), "dice": float(dice.value),
                   "count": int(dice.count)}
    return out


def train_state(name: str, state_dict: dict, remat=False, sched=None):
    model = create_model(name, base_c=BASE_C, fold_bn=False, remat=remat)
    model.load_state_dict(state_dict)
    return create_train_state(model, warmup_poly_schedule(**(sched or SCHED)))


def run_steps(state, step, data, group, accum: int = 1) -> dict:
    """``step`` over ``data`` (global batches, numpy) on this rank's rows:
    every step's loss, the parameters and statistics after the last."""
    losses = []
    for images, targets in data:
        images, targets = shard_batch(group, torch.from_numpy(images),
                                      torch.from_numpy(targets), accum=accum)
        state, aux = step(state, images, targets)
        losses.append(float(aux["loss"]))
    return {"losses": losses, "state": _numpy(state.model.state_dict())}


def run_multistep(state, step, data, group) -> dict:
    """One call of the K-step ``step`` on ``data`` stacked and sharded."""
    images, targets = shard_superbatch(
        group, *(torch.from_numpy(np.stack(a)) for a in zip(*data)))
    state, aux = step(state, images, targets)
    return {"losses": aux["loss"].tolist(), "state": _numpy(state.model.state_dict())}


def train_cases(group, cases: list) -> list:
    """Each case a dict (``name``, ``state_dict``, ``data``, ``accum``,
    ``dtype``, ``remat``, ``multistep``): the data-parallel steps from that
    state, and the collectives they issued."""
    _setup()
    results = []
    for c in cases:
        state = train_state(c["name"], c["state_dict"], c["remat"])
        kw = dict(input_dtype=c["dtype"], group=group)
        before = group.collectives
        if c["multistep"]:
            out = run_multistep(state, make_train_multistep(**kw), c["data"], group)
        else:
            accum = c["accum"]
            step = (make_train_step_accum(accum, **kw) if accum > 1
                    else make_train_step(**kw))
            out = run_steps(state, step, c["data"], group, accum)
        results.append({**out, "collectives": group.collectives - before})
    return results


def longclip_grads(group, cfg_kw: dict, state_dict: dict, batch: tuple) -> dict:
    """The data-parallel Long-CLIP loss of this rank's rows of ``batch``
    (image, long tokens, short tokens) and the gradients as the train step
    reduces them: summed over the ranks and divided by the world size."""
    _setup()
    model = CLIP(CLIPConfig(**cfg_kw))
    model.load_state_dict(state_dict)
    image, tl, ts = shard_batch(group, *(torch.from_numpy(a) for a in batch))
    loss = make_longclip_loss_fn(group=group)(model, image, tl.long(), ts.long())
    loss.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    total = all_reduce_grads(params, group, loss.detach())[0] / group.world
    return {"loss": float(total),
            "grads": {k: (p.grad / group.world).numpy()
                      for k, p in model.named_parameters() if p.requires_grad}}


# ------------------------------------------------------------------ spatial

def sp_cases(grid, fwd_cases: list, step_cases: list, fetch_cases: list,
             pools: np.ndarray, conv_cases: list) -> dict:
    """The spatial tests' work on one rank of a 1 x 2 grid (data x
    spatial): each ``fwd_cases`` entry (name, state_dict, images) the eval
    forward of this rank's rows; each ``step_cases`` entry (name,
    state_dict, images, targets, accum, remat, sched) one train step (its
    loss and state); each ``fetch_cases`` entry (x, a, b, fill, w) ``fetch_rows``'s
    output on this rank and the gradient of ``sum(out * w[rank])`` with
    respect to its rows; ``pools`` the MCA pools of this rank's rows; each
    ``conv_cases`` entry (x, w, padding, dilation, g) the row-split
    ``conv2d``'s rows and the gradients of ``sum(out * g rows)`` with
    respect to this rank's rows of x and to w."""
    _setup()
    sp, world = grid.inner, grid.world
    out = {"fwd": [], "step": [], "fetch": []}
    for name, state_dict, images in fwd_cases:
        model = create_model(name, base_c=BASE_C, fold_bn=False)
        model.load_state_dict(state_dict)
        x = shard_batch_spatial(grid, torch.from_numpy(images))
        before = sp.collectives
        with torch.no_grad(), use_data_group(world), use_spatial_group(sp, images.shape[1]):
            y = model.eval()(x)["out"]
        out["fwd"].append({"logits": y.numpy(), "collectives": sp.collectives - before})
    for name, state_dict, images, targets, accum, remat, sched in step_cases:
        state = train_state(name, state_dict, remat, sched)
        kw = dict(group=world, spatial=sp)
        step = make_train_step_accum(accum, **kw) if accum > 1 else make_train_step(**kw)
        x, t = shard_batch_spatial(grid, torch.from_numpy(images),
                                   torch.from_numpy(targets), accum=accum)
        before = sp.collectives, world.collectives
        state, aux = step(state, x, t)
        out["step"].append({"loss": float(aux["loss"]),
                            "state": _numpy(state.model.state_dict()),
                            "halo_collectives": sp.collectives - before[0],
                            "reduce_collectives": world.collectives - before[1]})
    for x, a, b, fill, w in fetch_cases:
        lo, hi = row_range(x.shape[1], sp.rank, sp.world)
        xl = torch.from_numpy(x[:, lo:hi]).requires_grad_(True)
        with use_spatial_group(sp, x.shape[1]):
            y = fetch_rows(xl, a, b, fill)
        (y * torch.from_numpy(w[sp.rank])).sum().backward()
        out["fetch"].append({"out": y.detach().numpy(), "grad": xl.grad.numpy()})
    out["conv"] = []
    for x, w, padding, dilation, g in conv_cases:
        lo, hi = row_range(x.shape[1], sp.rank, sp.world)
        xl = torch.from_numpy(x[:, lo:hi]).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        with use_spatial_group(sp, x.shape[1]):
            y = conv2d(xl, wt, padding=padding, dilation=dilation)
        (y * torch.from_numpy(g[:, lo:hi])).sum().backward()
        out["conv"].append({"out": y.detach().numpy(), "gx": xl.grad.numpy(),
                            "gw": wt.grad.numpy()})
    xp = shard_batch_spatial(grid, torch.from_numpy(pools))
    with torch.no_grad(), use_spatial_group(sp, pools.shape[1]):
        out["pools"] = [(max_pool2d(xp, 3, 1, 1) - min_pool2d(xp, 3, 1, 1)).numpy(),
                        avg_pool2d(xp, 3, 1, 1).numpy()]
    return out


# ------------------------------------------------------------------ tensor

def tp_cases(grid, enc: tuple, longclip: tuple) -> dict:
    """The tensor-parallel tests' work on one rank of a 1 x 2 grid (data x
    model): ``enc`` (config kwargs, full state_dict, image, text) the
    sharded towers' ``encode_image`` / ``encode_text``; ``longclip``
    (config kwargs, state_dict, (image, long, short)) the Long-CLIP loss
    over the data group and the full gradients ``gather_clip_state``
    reassembles."""
    _setup()
    kw, state_dict, image, text = enc
    model = CLIP(CLIPConfig(**kw))
    model.load_state_dict(state_dict)
    shard_clip(model, grid.inner)
    with torch.no_grad():
        out = {"image": model.encode_image(torch.from_numpy(image)).numpy(),
               "text": model.encode_text(torch.from_numpy(text).long()).numpy(),
               "heads": [m.heads for m in model.modules() if hasattr(m, "heads")]}
    kw, state_dict, batch = longclip
    model = CLIP(CLIPConfig(**kw))
    model.load_state_dict(state_dict)
    shard_clip(model, grid.inner)
    out["long_heads"] = [m.heads for m in model.modules() if hasattr(m, "heads")]
    image, tl, ts = shard_batch(grid.data, *(torch.from_numpy(a) for a in batch))
    loss = make_longclip_loss_fn(group=grid.data)(model, image, tl.long(), ts.long())
    loss.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    total = all_reduce_grads(params, grid.data, loss.detach())[0] / grid.data.world
    for p in params:
        p.grad.div_(grid.data.world)
    grads = gather_clip_state(model, grid.inner, grads=True)
    out["loss"] = float(total)
    out["grads"] = {k: v.numpy() for k, v in grads.items() if v is not None}
    out["state"] = {k: v.numpy() for k, v in gather_clip_state(model, grid.inner).items()}
    out["model_collectives"] = grid.inner.collectives
    return out
