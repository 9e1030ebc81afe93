"""Long-CLIP contrastive fine-tune (port of
``egm_unet_tpu/engine/longclip_train.py``), on one process or data-parallel.

The loss (ref: clip/model.py:572-614): image features (CSA in the last
vision block, so kernel K6 runs forward and its closed-form backward),
long- and short-text features, all L2-normalized; a PCA-32 reconstruction
of the batch's image features as the "short" image proxy; two symmetric
InfoNCE losses with label smoothing 0.1, weighted ``long + 0.1 * short``.

The optimizer: AdamW (weight decay 1e-2 on every trainable parameter, as
``optax.adamw`` applies it) on optax's ``warmup_cosine_decay_schedule``
(0 -> ``lr`` linearly, then cosine to ``lr * 1e-2``) written as a
``LambdaLR``.  ``positional_embedding`` is frozen (the JAX package's
``set_to_zero`` leaf; ``positional_embedding_res`` trains); so are the
ModifiedResNet's BatchNorm statistics (every module's ``frozen_leaves``:
the running ``mean`` and ``var``, which the JAX package's fine-tune moves
like any leaf; eval-mode statistics are no weights, and a per-chip batch of
48 estimates none); after each step ``logit_scale`` is clamped at ln 100.

Data parallel (``group``; the JAX package's ``shard_map`` over the mesh's
``data`` axis): each rank encodes its rows of the global batch and takes the
PCA proxy of its own rows; a differentiable all-gather
(``parallel.all_gather``) brings every rank's image and text features to
each; each rank's images are scored against every text and its texts
against every image, with targets offset by ``rank * b``; the loss is the
mean of the ranks' losses, so the summed gradients are divided by the world
size.

Spans and counters (``utils/profiling``; recorded only under a profiler or
``recording()``): ``longclip.step`` around a whole step, in it
``longclip.encode_image``, ``longclip.encode_text`` (twice a step: long and
short captions), ``longclip.loss`` (the PCA proxy and the cross-entropies),
``longclip.backward`` and ``longclip.update`` (AdamW and the logit-scale
clamp); the counters ``longclip.steps`` (one a step) and ``longclip.images``
(this rank's rows a step).

Data x tensor parallel (the JAX package's ``make_longclip_loss_fn(clip,
mesh=get_mesh(n, m))``): the model is ``parallel.shard_clip``'s shard over a
grid's model ranks, and ``group`` is the grid's data group (``Grid.data``,
the data ranks of this rank's model index).  The ranks of one data rank
hold the same rows; the PCA is per data rank, the features are all-gathered
over the data group only, and the gradients are all-reduced over it only:
the model ranks hold different shards, and the Megatron collectives inside
the towers have already made each shard's gradient whole.
"""

from __future__ import annotations

import math

from typing import Optional

import numpy as np
import torch

from egm_unet_torch.engine.state import TrainState
from egm_unet_torch.parallel.mesh import DataGroup, all_gather, all_reduce_grads
from egm_unet_torch.utils.profiling import count, span

MAX_LOGIT_SCALE = math.log(100.0)  # upstream CLIP's post-step clamp
FROZEN = ("positional_embedding",)


def pca_reconstruct(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Project the centered rows onto their top ``dim`` principal directions
    (SVD) and back (ref: clip/model.py:519-536).  Fewer than 2 rows: the
    identity, the same forward value as the SVD path (the centered matrix is
    zero) without the SVD of a zero matrix, whose gradient is NaN."""
    if x.shape[0] < 2:
        return x
    mean = x.mean(dim=0)
    xc = (x - mean[None]).to(torch.promote_types(x.dtype, torch.float32))
    _, _, vh = torch.linalg.svd(xc, full_matrices=False)
    pc = vh.transpose(0, 1)[:, :dim]
    return (xc @ pc) @ pc.transpose(0, 1) + mean[None]


def cross_entropy_smoothed(logits: torch.Tensor, targets: torch.Tensor,
                           label_smoothing: float = 0.1) -> torch.Tensor:
    """``F.cross_entropy(label_smoothing=...)`` in the JAX package's form."""
    logp = torch.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)),
                             dim=-1)
    nll = -logp.gather(1, targets[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return torch.mean((1.0 - label_smoothing) * nll + label_smoothing * smooth)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def longclip_contrastive_loss(image_features: torch.Tensor,
                              text_features_long: torch.Tensor,
                              text_features_short: torch.Tensor,
                              logit_scale: torch.Tensor, pca_dim: int = 32,
                              label_smoothing: float = 0.1,
                              group: Optional[DataGroup] = None):
    """``(loss_itcl, loss_itcs)`` of this rank's rows: its images against
    every rank's texts and its texts against every rank's images (without a
    group the gathered features are the local ones and the targets
    0..b-1)."""
    acc = torch.promote_types(image_features.dtype, torch.float32)
    img_long = _normalize(image_features.to(acc))
    txt_long = _normalize(text_features_long.to(acc))
    txt_short = _normalize(text_features_short.to(acc))
    img_short = pca_reconstruct(img_long, pca_dim)  # over this rank's rows

    if group is None:
        gather, rank = (lambda t: t), 0
    else:
        gather, rank = (lambda t: all_gather(t, group)), group.rank
    img_all_long, img_all_short = gather(img_long), gather(img_short)
    txt_all_long, txt_all_short = gather(txt_long), gather(txt_short)

    scale = torch.exp(logit_scale)
    sim_i2tl = scale * img_long @ txt_all_long.T
    sim_tl2i = (scale * (img_all_long @ txt_long.T)).T
    sim_i2ts = scale * img_short @ txt_all_short.T
    sim_ts2i = (scale * (img_all_short @ txt_short.T)).T
    b = image_features.shape[0]
    targets = rank * b + torch.arange(b, device=image_features.device)

    ce = lambda s: cross_entropy_smoothed(s, targets, label_smoothing)
    loss_itcl = (ce(sim_i2tl) + ce(sim_tl2i)) / 2
    loss_itcs = (ce(sim_i2ts) + ce(sim_ts2i)) / 2
    return loss_itcl, loss_itcs


def make_longclip_loss_fn(ratio_short: float = 0.1, group: Optional[DataGroup] = None):
    """``loss(model, image, text_long, text_short) -> scalar``:
    ``loss_itcl + ratio_short * loss_itcs`` (with ``group``: this rank's, on
    its rows of the global batch)."""

    def loss_fn(model, image, text_long, text_short):
        with span("longclip.encode_image"):
            img = model.encode_image(image)
        with span("longclip.encode_text"):
            tl = model.encode_text(text_long)
        with span("longclip.encode_text"):
            ts = model.encode_text(text_short)
        with span("longclip.loss"):
            l_long, l_short = longclip_contrastive_loss(img, tl, ts, model.logit_scale,
                                                        group=group)
            return l_long + ratio_short * l_short

    return loss_fn


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax's ``warmup_cosine_decay_schedule`` (exponent 1) as
    ``schedule(step) -> float``, in its float32 arithmetic: a linear ramp
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then a
    cosine from ``peak_value`` to ``end_value`` over the remaining
    ``decay_steps - warmup_steps``, held there."""
    f32 = np.float32
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"positive decay steps needed, got {decay_steps - warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = f32(decay_steps - warmup_steps)

    def schedule(step) -> float:
        if step < warmup_steps:  # warmup_steps > 0 here
            frac = f32(1) - f32(step) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        count = np.minimum(f32(step - warmup_steps), cos_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count / cos_steps, dtype=f32))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def longclip_schedule(lr: float, warmup_steps: int, total_steps: int):
    """The fine-tune's schedule: 0 -> ``lr`` -> ``lr * 1e-2``; a warm-up as
    long as the run is clamped to ``total_steps - 1`` steps, as the JAX
    package clamps it."""
    warmup_steps = min(warmup_steps, max(0, total_steps - 1))
    return warmup_cosine_decay_schedule(0.0, lr, warmup_steps,
                                        max(total_steps, warmup_steps + 1), lr * 1e-2)


def frozen_names(model: torch.nn.Module) -> set:
    """The parameters the fine-tune leaves as they are: ``FROZEN``, and each
    module's ``frozen_leaves`` (the RN tower's BatchNorm statistics)."""
    names = set(FROZEN)
    for prefix, mod in model.named_modules():
        names.update(f"{prefix}.{leaf}" if prefix else leaf
                     for leaf in getattr(mod, "frozen_leaves", ()))
    return names


def create_longclip_state(model: torch.nn.Module, lr: float = 1e-6,
                          weight_decay: float = 1e-2, warmup_steps: int = 200,
                          total_steps: int = 10000) -> TrainState:
    """AdamW over every parameter but ``frozen_names`` (frozen:
    ``requires_grad=False``, not the optimizer's) on ``longclip_schedule``."""
    frozen = frozen_names(model)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(name not in frozen)
        if name not in frozen:
            trainable.append(p)
    sched = longclip_schedule(lr, warmup_steps, total_steps)
    opt = torch.optim.AdamW(trainable, lr=1.0, weight_decay=weight_decay)
    return TrainState(model=model, optimizer=opt,
                      scheduler=torch.optim.lr_scheduler.LambdaLR(opt, sched),
                      lr_fn=sched)


def make_longclip_train_step(ratio_short: float = 0.1,
                             group: Optional[DataGroup] = None):
    """Returns ``step(state, image, text_long, text_short) -> (state, aux)``:
    the contrastive loss, one AdamW update, then ``logit_scale`` clamped at
    ln 100.  ``aux["loss"]`` stays a device tensor; ``aux["lr"]`` is the
    schedule at the step count after the update.  ``group``: data parallel
    on this rank's rows; the gradients and the loss are the means over the
    ranks (one all-reduce)."""
    loss_fn = make_longclip_loss_fn(ratio_short, group)

    def step(state, image, text_long, text_short):
        model = state.model
        with span("longclip.step"):
            count("longclip.steps", 1)
            count("longclip.images", image.shape[0])
            state.optimizer.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss = loss_fn(model, image, text_long, text_short)
                with span("longclip.backward"):
                    loss.backward()
            loss = loss.detach()
            if group is not None:
                params = [p for g in state.optimizer.param_groups for p in g["params"]]
                loss = all_reduce_grads(params, group, loss)[0] / group.world
                for p in params:
                    p.grad.div_(group.world)
            with span("longclip.update"):
                state.apply_gradients()
                with torch.no_grad():
                    model.logit_scale.clamp_(max=MAX_LOGIT_SCALE)
        return state, {"loss": loss, "lr": state.lr_fn(state.step)}

    return step

