"""The Long-CLIP fine-tune a ``train_longclip`` user runs: the port's train
step (``create_longclip_state`` and ``make_longclip_train_step``, the
functions ``cli/train_longclip.py`` calls) on device-resident batches of
(image, long caption, short caption) triples, back to back.

Set-up: the tower built by the program on the device from the
configuration's sizes (``LONGCLIP_L14``'s at the cell's), weights drawn
from the seed, TF32 as the configuration states; a pool of batches drawn
from the seed (``traffic/<mix>.json``: street frames normalised with CLIP's
statistics, captions of SOT, ids, EOT and zero padding) and copied to the
device; two steps to warm up, then the seeded weights loaded again into a
fresh train state.  Window: the batches in turn, one step each, then one
synchronise; the rate is every image trained over the whole window.
Check: the window's first two steps, from the seeded weights on the pool's
first two batches (the window runs at least two), against the float32
reference (``reference/longclip.py``, TF32 off, in blocks of rows, after
the program's state is freed), which takes the same two steps with its own
gradients and a plain AdamW at the schedule's rates: ``loss_err``, the
first step's loss, relative; ``grad_err_vision`` / ``grad_err_text``, the
first step's gradients (kept by an optimizer pre-hook, before the update),
the worst leaf's relative error (the norm of the difference over the
reference's), ``text`` counting every leaf outside ``visual``
(``logit_scale`` too), ``vision`` over the PCA's conditioning on the
reference's first batch, ``1 + pca_gain * s33^2 / (s32^2 - s33^2)`` with
``s`` its singular values (float32 rounding in the SVD of a nearly
degenerate pair reaches the images' gradients amplified so, the text's
not); ``update_err``, the leaves after the second step
(the first runs at rate 0), the worst leaf's distance from the reference's
over the norm of the reference's update: a step that leaves the state as
it was reads about 1.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from egm_unet_torch.models.clip.model import LONGCLIP_L14  # noqa: F401  (see clip_config)
from port_bench.core import Check
from port_bench.drivers.common import DriverBase, fail_check, forget_peak
from port_bench.drivers.fused_folder import set_tf32
from port_bench.reference import longclip as ref_longclip
from port_bench.traffic import generator
from port_bench.weights import make_weights, shapes_of

FROZEN = ("positional_embedding",)  # the fine-tune's frozen leaf

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_config(c: dict):
    """The program's config: ``LONGCLIP_L14`` with the cell's sizes.  The
    preset is imported with this module, so that a program without it
    fails the cell before any kernel is built."""
    return dataclasses.replace(
        LONGCLIP_L14, embed_dim=c["embed_dim"], image_resolution=c["resolution"],
        vision_layers=c["vision_layers"], vision_width=c["vision_width"],
        vision_patch_size=c["patch"], context_length=c["context"], vocab_size=c["vocab"],
        transformer_width=c["text_width"], transformer_heads=c["text_heads"],
        transformer_layers=c["text_layers"])


def captions(rng: np.random.Generator, n: int, lengths, at_cap: float, context: int,
             vocab: int) -> np.ndarray:
    """``n`` rows of ``context`` token ids: SOT (vocab - 2), ids drawn from
    1 .. vocab - 3, EOT (vocab - 1, the highest) last, zeros after.  A row's
    length (SOT and EOT counted) is ``lengths[1]`` with probability
    ``at_cap``, else drawn from ``lengths[0] .. lengths[1] - 1``; capped at
    ``context``."""
    lo, hi = lengths
    n_tok = np.where(rng.random(n) < at_cap, hi, rng.integers(lo, hi, n))
    n_tok = np.minimum(n_tok, context)
    ids = rng.integers(1, vocab - 2, (n, context))
    col = np.arange(context)[None]
    ids = np.where(col < n_tok[:, None], ids, 0)
    ids[:, 0] = vocab - 2
    ids[np.arange(n), n_tok - 1] = vocab - 1
    return ids.astype(np.int64)


def make_batches(mix: dict, c: dict, seed: int) -> list:
    """``pool_batches`` host batches ``(images [B, R, R, 3] float32, long
    ids, short ids)`` drawn from ``seed``."""
    b, r = int(mix["batch"]), int(c["resolution"])
    out = []
    for k in range(int(mix["pool_batches"])):
        imgs = np.stack([generator.tp_frame(generator.rng_for(seed, 5, k, i), r, r)
                         for i in range(b)])
        imgs = (imgs.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
        rng = generator.rng_for(seed, 6, k)
        tl = captions(rng, b, mix["long_tokens"], float(mix["long_at_cap"]), c["context"],
                      c["vocab"])
        ts = captions(rng, b, mix["short_tokens"], 0.0, c["context"], c["vocab"])
        out.append((imgs, tl, ts))
    return out


def leaf_errors(got: dict, ref: dict, scale: dict) -> dict:
    """Each leaf's ``|got - ref| / |scale|``, in float64 (0 where both norms
    are 0, inf where only the scale's is)."""
    out = {}
    for n, s in scale.items():
        num = float((got[n].double() - ref[n].double()).norm())
        den = float(s.double().norm())
        out[n] = num / den if den else (0.0 if num == 0 else math.inf)
    return out


class Driver(DriverBase):
    def setup(self) -> None:
        from egm_unet_torch.engine.longclip_train import (create_longclip_state,
                                                          make_longclip_train_step)
        from egm_unet_torch.models.clip.model import CLIP

        cfg, dev = self.cfg, self.device
        c, rec = cfg["clip"], cfg["recipe"]
        set_tf32(bool(cfg["tf32"]))
        self.ref_kw = dict(c)  # the reference's keyword arguments
        weights = make_weights(shapes_of(ref_longclip.build(device="meta", **self.ref_kw)),
                               self.seed, dev)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        self.host_batches = make_batches(self.mix, c, self.seed)
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
        for k in range(2):  # builds the kernels and the libraries' plans
            self.state, _ = self.step(self.state, *self.batches[k % len(self.batches)])
        self.model.load_state_dict(self.weights)  # the window starts from the seed
        self.state = fresh_state()
        # what the check keeps of the window, held from here: no allocation in it
        self.params = {n: p for n, p in self.model.named_parameters() if p.requires_grad}
        self.kept = {n: torch.empty_like(p) for n, p in self.params.items()}
        self.after = {n: torch.empty_like(p) for n, p in self.params.items()}

    def window(self, seconds: float, tracer) -> None:
        params, losses, taken = self.params, [], []

        def keep(opt, args, kwargs):  # the first step's gradients, before the update
            if not taken:
                taken.append(True)
                for n, p in params.items():
                    self.kept[n].copy_(p.grad)

        hook = self.state.optimizer.register_step_pre_hook(keep)
        n = 0
        try:
            with tracer.window():
                t0 = time.perf_counter()
                while n < 2 or time.perf_counter() - t0 < seconds:  # the check reads two
                    with record_function("bench.step"):
                        self.state, aux = self.step(self.state,
                                                    *self.batches[n % len(self.batches)])
                    losses.append(aux["loss"])
                    n += 1
                    if n == 2:
                        with torch.no_grad():
                            for k, p in params.items():
                                self.after[k].copy_(p)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.elapsed = time.perf_counter() - t0
        finally:
            hook.remove()
        self.steps, self.took_grads = n, bool(taken)
        self.images = n * int(self.mix["batch"])
        self.attempted = self.images
        finite = torch.isfinite(torch.stack(losses)).cpu()
        self.failed = int((~finite).sum()) * int(self.mix["batch"])
        self.first_loss = float(losses[0])

    def e2e(self) -> dict:
        return {"batch_img_per_s": self.images / self.elapsed}

    def counts(self) -> dict:
        return {"steps": self.steps, "images": self.images, "seconds": self.elapsed,
                "batch": int(self.mix["batch"])}

    def release(self) -> None:
        self.kept = {k: v.cpu() for k, v in self.kept.items()}
        self.after = {k: v.cpu() for k, v in self.after.items()}
        del self.model, self.state, self.step, self.batches, self.params
        self.free_cache()

    def reference_steps(self):
        """The reference's two steps from the seeded weights: the first
        step's loss, gradients and the PCA's singular values, the second's
        singular values, and the AdamW (its leaves after both steps)."""
        rec, dev = self.cfg["recipe"], self.device
        ref = ref_longclip.build(self.weights, dev, **self.ref_kw)
        params = {n: p.detach() for n, p in ref.named_parameters()
                  if n not in FROZEN}
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
                first = (loss, {n: grads[n].cpu() for n in params})
            opt.step(grads, ref_longclip.schedule(k, float(rec["lr"]), int(rec["warmup_steps"]),
                                                  int(rec["total_steps"])))
            del img, tl, ts, grads
        del ref
        return first, svs, opt

    def check(self):
        self.exact_reference()
        d = int(self.cfg["recipe"]["pca_dim"])
        (loss, grads), svs, opt = self.reference_steps()
        if not self.took_grads:
            return fail_check("grad_err_vision", self.limit("grad_err_vision"),
                              "the optimizer never stepped", self.log)
        if set(self.kept) != set(grads):
            return fail_check("grad_err_vision", self.limit("grad_err_vision"),
                              f"the step's leaves are not the reference's trainable ones: "
                              f"{sorted(set(self.kept) ^ set(grads))[:6]}", self.log)
        grad = leaf_errors(self.kept, grads, grads)
        update = leaf_errors(self.after, {n: p.cpu() for n, p in opt.params.items()},
                             opt.moved)
        del opt
        self.free_cache()
        gaps = [float(sv[d - 1] / sv[d]) if sv.numel() > d else math.inf for sv in svs]
        vision = [n for n in grad if n.startswith("visual.")]
        text = [n for n in grad if not n.startswith("visual.")]
        worst = lambda errs, names: max(errs[n] for n in names)  # noqa: E731
        most = lambda errs, names: max(names, key=errs.get)  # noqa: E731
        self.log(f"first step: loss {self.first_loss!r} (reference {loss!r}); "
                 f"PCA sigma{d}/sigma{d + 1} {gaps[0]!r}, second step {gaps[1]!r}; worst "
                 f"leaves: vision {most(grad, vision)}, text {most(grad, text)}, "
                 f"update {most(update, list(update))}")
        # the PCA's conditioning: 1 + gain * sigma33^2 / (sigma32^2 - sigma33^2)
        cond = 1.0 + float(self.wl["pca_gain"]) / max(gaps[0] ** 2 - 1, 1e-30)
        return [Check("loss_err", abs(self.first_loss - loss) / abs(loss),
                      self.limit("loss_err")),
                Check("grad_err_vision", worst(grad, vision) / cond,
                      self.limit("grad_err_vision")),
                Check("grad_err_text", worst(grad, text), self.limit("grad_err_text")),
                Check("update_err", max(update.values()), self.limit("update_err"))]
