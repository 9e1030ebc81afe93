"""The Long-CLIP fine-tune of a ModifiedResNet CLIP, as a ``train_longclip
--clip-config rn50x64`` (or ``--clip-weights RN50x64.pt --stretch``) user
runs it: ``longclip_step``'s driver (the same step, batches, window, and
``loss_err``, ``grad_err_vision``, ``grad_err_text``, ``update_err``) with
the program's ``RN50X64`` preset at the cell's sizes and the plain
reference ``reference/clip_resnet.py``.

What differs:
- ``RN50X64`` is imported with this module, so a program without it fails
  the cell at once (ImportError), before any kernel is built;
- the draw: ``weights.py``'s, with the last BatchNorm of each residual
  branch (``bn3``) scaled by ``branch_gain``, then every BatchNorm's
  running statistics set to its input's channel mean and biased variance
  over the pool's first ``calibration_frames`` frames, in the tower's
  order, on the reference in float32 without TF32 (``calibrate``).  A
  pretrained network's statistics describe its activations; the draw's own
  (mean 0.1 N, var e^(0.25 N)), through 64 residual blocks, leave the
  attention pool's inputs at 1e9 and its softmax one-hot.  Calibrated but
  at full branch gain, each block adds a branch as large as its input and
  the 64 blocks amplify rounding chaotically: float32 image features 1.6e-3
  off float64 ones, the sound program's gradients 3% off the reference's
  (width 16, 64 px, CPU; the card read the same at full width).  A gain of
  0.1, as trained deep ResNets' small last-branch scales (and the zero-gamma
  initialisation) have it, gives 2.2e-6.  What the gradients keep, ~5e-3
  in the worst BatchNorm leaf, is ReLU masks that flip where a
  pre-activation lies within rounding of 0 (the workload file's reasons);
- one more number, ``stats_moved``: the largest change of any BatchNorm
  ``mean`` or ``var`` after the window's second step (an optimizer
  post-hook copies them then), which a fine-tune that leaves them as loaded
  reads as exactly 0.  The check compares the other numbers over the
  reference's trainable leaves, which do not include the statistics (its
  BatchNorms keep them as buffers), so a program that trains them fails
  ``stats_moved`` alone;
- the attention pool's ``k_proj.bias`` is left out of the gradients' and
  the update's numbers: a bias added to every key shifts each query's
  logits by one constant, which the softmax removes, so its gradient is 0
  and both sides compute rounding noise there (with the leaf, the sound
  program read 1.49 on the CPU), and AdamW turns that noise into moves of
  the rate's size.  The leaf changes nothing the model computes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from egm_unet_torch.models.clip.model import RN50X64
from port_bench.core import Check
from port_bench.drivers import longclip_step as base
from port_bench.drivers.common import exact, forget_peak
from port_bench.reference import clip_resnet as ref_rn
from port_bench.reference import longclip as ref_longclip
from port_bench.weights import make_weights, shapes_of

NULL_GRAD = ("visual.attnpool.k_proj.bias",)  # gradient 0 in exact arithmetic


def clip_config(c: dict):
    """The program's config: ``RN50X64`` (its recomputation included) with
    the cell's sizes."""
    return dataclasses.replace(
        RN50X64, embed_dim=c["embed_dim"], image_resolution=c["resolution"],
        vision_layers=tuple(c["vision_layers"]), vision_width=c["vision_width"],
        context_length=c["context"], vocab_size=c["vocab"], transformer_width=c["text_width"],
        transformer_heads=c["text_heads"], transformer_layers=c["text_layers"])


@torch.no_grad()
def calibrate(weights: dict, images: np.ndarray, kw: dict, device) -> None:
    """Set, in place, every BatchNorm's ``mean`` and ``var`` in ``weights``
    to the channel mean and biased variance of its input when the reference
    encodes ``images`` (NHWC float32), each from the statistics set before
    it in the tower."""
    ref = ref_rn.build(weights, device, **kw)

    def take(bn, args):
        x = args[0]
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(take) for m in ref.modules() if isinstance(m, ref_rn.BN)]
    with exact():
        ref.encode_image(torch.from_numpy(images).to(device))
    for h in hooks:
        h.remove()
    for name, buf in ref.named_buffers():
        weights[name].copy_(buf)


class Driver(base.Driver):
    def setup(self) -> None:
        from egm_unet_torch.engine.longclip_train import (create_longclip_state,
                                                          make_longclip_train_step)
        from egm_unet_torch.models.clip.model import CLIP

        cfg, dev = self.cfg, self.device
        c, rec = cfg["clip"], cfg["recipe"]
        base.set_tf32(bool(cfg["tf32"]))
        self.ref_kw = dict(c)
        meta = ref_rn.build(device="meta", **self.ref_kw)
        self.stat_names = [n for n, _ in meta.named_buffers()]
        self.host_batches = base.make_batches(self.mix, c, self.seed)
        weights = make_weights(shapes_of(meta), self.seed, dev)
        for name, w in weights.items():
            if name.endswith(".bn3.scale"):
                w.mul_(float(self.wl["branch_gain"]))
        calibrate(weights, self.host_batches[0][0][:int(self.wl["calibration_frames"])],
                  self.ref_kw, dev)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        self.batches = [tuple(torch.from_numpy(a).to(dev) for a in b) for b in self.host_batches]
        with torch.device(dev):
            self.model = CLIP(clip_config(c))
        self.model.load_state_dict(weights)
        del weights
        forget_peak(dev)

        def fresh_state():
            return create_longclip_state(self.model, lr=rec["lr"],
                                         weight_decay=rec["weight_decay"],
                                         warmup_steps=rec["warmup_steps"],
                                         total_steps=rec["total_steps"])

        self.step = make_longclip_train_step(ratio_short=rec["ratio_short"])
        self.state = fresh_state()
        for k in range(2):  # builds the libraries' plans
            self.state, _ = self.step(self.state, *self.batches[k % len(self.batches)])
        self.model.load_state_dict(self.weights)  # the window starts from the seed
        self.state = fresh_state()
        # what the check keeps of the window, held from here: no allocation in it
        self.params = {n: p for n, p in self.model.named_parameters() if p.requires_grad}
        self.kept = {n: torch.empty_like(p) for n, p in self.params.items()}
        self.after = {n: torch.empty_like(p) for n, p in self.params.items()}
        leaves = dict(self.model.named_parameters())
        self.stats = {n: leaves[n] for n in self.stat_names}
        self.stats_after = {n: torch.empty_like(p) for n, p in self.stats.items()}

    def window(self, seconds: float, tracer) -> None:
        updates = []

        def snap(opt, args, kwargs):  # the statistics after the second update
            updates.append(True)
            if len(updates) == 2:
                with torch.no_grad():
                    for n, s in self.stats.items():
                        self.stats_after[n].copy_(s)

        hook = self.state.optimizer.register_step_post_hook(snap)
        try:
            super().window(seconds, tracer)
        finally:
            hook.remove()
        self.stats_taken = len(updates) >= 2

    def release(self) -> None:
        self.stats_after = {k: v.cpu() for k, v in self.stats_after.items()}
        del self.stats
        super().release()

    def reference_steps(self):
        """``longclip_step``'s two reference steps on ``reference/clip_resnet.py``."""
        rec, dev = self.cfg["recipe"], self.device
        ref = ref_rn.build(self.weights, dev, **self.ref_kw)
        params = {n: p.detach() for n, p in ref.named_parameters() if n not in base.FROZEN}
        opt = ref_longclip.AdamW(params, float(rec["weight_decay"]))
        first, svs = None, []
        for k in range(2):  # the batches the window's first two steps took
            host = self.host_batches[k % len(self.host_batches)]
            img, tl, ts = (torch.from_numpy(a).to(dev) for a in host)
            loss, grads, sv = ref_longclip.loss_and_grads(
                ref, img, tl, ts, int(self.wl["check_block"]), int(rec["pca_dim"]),
                float(rec["ratio_short"]))
            svs.append(sv.cpu())
            if k == 0:
                first = (loss, {n: grads[n].cpu() for n in params if n not in NULL_GRAD})
            opt.step(grads, ref_longclip.schedule(k, float(rec["lr"]), int(rec["warmup_steps"]),
                                                  int(rec["total_steps"])))
            del img, tl, ts, grads
        del ref
        for n in NULL_GRAD:
            del opt.params[n], opt.moved[n]
        return first, svs, opt

    def check(self):
        # the statistics are held by stats_moved; NULL_GRAD by nothing
        for n in self.stat_names + list(NULL_GRAD):
            self.kept.pop(n, None)
            self.after.pop(n, None)
        if not self.stats_taken:
            moved = float("inf")
        else:
            moved = max(float((self.stats_after[n] - self.weights[n]).abs().max())
                        for n in self.stat_names)
        self.log(f"BatchNorm statistics after the second update: largest change {moved!r}")
        return super().check() + [Check("stats_moved", moved, self.limit("stats_moved"))]
