"""CLIPSeg decoder training on PhraseCut (port of
``egm_unet_tpu/engine/clipseg_train.py``): AdamW at 1e-3 with weight decay
1e-2, a cosine schedule from 1e-3 to 1e-4 over 20000 steps that holds at its
end, batch 64 at 352 px, binary cross-entropy with logits; the CLIP tower is
frozen and only the decoder trains.

The JAX package masks the tower out of its optimizer (``optax.masked``) and
stops its gradients inside the model.  Here the tower's parameters have
``requires_grad=False`` and are not given to the optimizer; the model runs
the tower under ``torch.no_grad()`` (``models/clipseg.py``), so kernel K6
``csa_attention`` runs forward only, once per dense block.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from egm_unet_torch.engine.state import TrainState


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in float32, in the JAX
    package's form ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    x = logits.float()
    t = target.float()
    return torch.mean(torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs())))


def cosine_schedule(lr: float = 1e-3, t_max: int = 20000, eta_min: float = 1e-4):
    """``schedule(step) -> lr``: torch's ``CosineAnnealingLR`` formula, held
    at ``eta_min`` past ``t_max`` (``CosineAnnealingLR`` itself rises again
    there).  float32 arithmetic, as the JAX schedule's."""
    f32 = np.float32

    def schedule(step) -> float:
        s = np.minimum(f32(step), f32(t_max))
        cos = np.cos(f32(math.pi) * s / f32(t_max), dtype=f32)
        return float(f32(eta_min) + f32(lr - eta_min) * f32(0.5) * (f32(1) + cos))

    return schedule


def create_clipseg_state(model: torch.nn.Module, lr: float = 1e-3, t_max: int = 20000,
                         eta_min: float = 1e-4, weight_decay: float = 1e-2) -> TrainState:
    """AdamW over the decoder's parameters on the cosine schedule (a
    ``LambdaLR`` over a base rate of 1); the tower is frozen."""
    for p in model.clip.parameters():
        p.requires_grad_(False)
    decoder = [p for name, p in model.named_parameters() if not name.startswith("clip.")]
    sched = cosine_schedule(lr, t_max, eta_min)
    opt = torch.optim.AdamW(decoder, lr=1.0, weight_decay=weight_decay)
    return TrainState(model=model, optimizer=opt,
                      scheduler=torch.optim.lr_scheduler.LambdaLR(opt, sched),
                      lr_fn=sched)


def make_clipseg_train_step():
    """Returns ``step(state, images, segs, tokens) -> (state, aux)``: NHWC
    CLIP-normalized images, [B, H, W] {0, 1} targets and [B, ctx] token ids
    on the model's device.  ``aux["loss"]`` stays a device tensor;
    ``aux["lr"]`` is the schedule at the step count after the update."""

    def step(state, images, segs, tokens):
        model = state.model
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            (logits,) = model(images, tokens)
            loss = bce_with_logits(logits[..., 0], segs)
            loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach(), "lr": state.lr_fn(state.step)}

    return step


def clipseg_foreground_iou(logits: torch.Tensor, segs: torch.Tensor,
                           threshold: float = 0.5) -> torch.Tensor:
    """Foreground IoU of ``sigmoid(logits) > threshold`` against
    ``segs > 0.5``; 1 where both are empty."""
    pred = torch.sigmoid(logits.float()) > threshold
    gt = segs > 0.5
    inter = (pred & gt).sum().float()
    union = (pred | gt).sum().float()
    return torch.where(union == 0, torch.ones_like(union), inter / union.clamp(min=1))

