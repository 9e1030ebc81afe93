"""The text-prompted fusion a ``predict_clipseg`` / ``eval_clipseg`` user
runs: ``cli/eval_clipseg.py::fused_masks`` on successive folders of raw
frames, closed loop (a folder's masks come back before the next starts).

Set-up: CLIPSeg (ViT-B/16, rd64) and the folded GRFB-UNet built by the
program on the device and given weights drawn from the seed (the UNet's as
a trainer's checkpoint that the program folds), the prompt embeddings drawn
from the seed, TF32 as the configuration states, a pool of frames grouped
into folders, one folder run twice.  Window: the folders in turn; the rate
is every image over the whole window.  Check: a seeded sample of folders,
their masks from their last run in the window, against the float32
reference pipeline: the same PIL preprocessing, both branches, the
back-resize and the fusion.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench.core import Check
from port_bench.drivers.common import (DriverBase, balance, exact, fail_check, forget_peak,
                                       gap_check, keep_outputs, ran, remove, unet_weights,
                                       write_checkpoint)
from port_bench.reference import clipseg as ref_clipseg
from port_bench.reference import pipeline as P
from port_bench.reference import unet as ref_unet
from port_bench.traffic import generator
from port_bench.weights import make_weights, shapes_of


def clip_config(c: dict):
    from egm_unet_torch.models.clip.model import CLIPConfig

    return CLIPConfig(embed_dim=c["embed_dim"], image_resolution=c["resolution"],
                      vision_layers=c["layers"], vision_width=c["width"],
                      vision_patch_size=c["patch"], context_length=c["context"],
                      vocab_size=c["vocab"], transformer_width=c["text_width"],
                      transformer_heads=c["text_width"] // 64,
                      transformer_layers=c["text_layers"], long_clip=True)


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class Driver(DriverBase):
    def setup(self) -> None:
        from egm_unet_torch.models.clipseg import CLIPDensePredT
        from egm_unet_torch.models.registry import create_model
        from egm_unet_torch.utils.checkpoint import folded_state_dict

        cfg, mix, dev = self.cfg, self.mix, self.device
        set_tf32(bool(cfg["tf32"]))
        c, u = cfg["clipseg"], cfg["unet"]
        kw = {k: c[k] for k in ("width", "layers", "patch", "resolution", "embed_dim",
                                "text_width", "text_layers", "context", "vocab",
                                "reduce_dim", "n_heads")}
        kw["extract_layers"] = tuple(c["extract_layers"])
        self.ref_kw = kw
        self.clip_w = make_weights(shapes_of(ref_clipseg.build(device="meta", **kw)),
                                   self.seed, dev)
        self.unet_w = unet_weights(u, self.seed + 1, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed((self.seed + 2) % (2 ** 63))
        self.cond = torch.randn(int(cfg["prompts"]), c["embed_dim"], generator=gen, device=dev)
        frames = generator.frames(mix, self.seed)
        self.folders = [[frames[i] for i in g]
                        for g in generator.groups(mix, self.seed, "folder", "pool_folders")]
        with exact():  # the fused margin split on a frame of the traffic
            cs = ref_clipseg.build(self.clip_w, dev, **kw)
            un = ref_unet.build(u["model"], u["base_c"], u["num_classes"], self.unet_w, dev)
            balance(self.unet_w, self.reference(cs, un, frames[:1])[0][0], float(cfg["alpha"]))
            del cs, un
        forget_peak(dev)
        with torch.device(dev):
            self.clipseg = CLIPDensePredT(clip_cfg=clip_config(c), reduce_dim=c["reduce_dim"],
                                          extract_layers=tuple(c["extract_layers"]),
                                          n_heads=c["n_heads"])
        self.clipseg.load_state_dict(self.clip_w)
        self.clipseg.eval()
        ckpt = write_checkpoint(self.unet_w)
        try:
            state = folded_state_dict(ckpt, u["model"], u["num_classes"], u["base_c"])
        finally:
            remove(ckpt)
        unet = create_model(u["model"], num_classes=u["num_classes"], base_c=u["base_c"])
        unet.load_state_dict(state)
        self.unet = unet.to(dev).eval()
        self.free_cache()
        for _ in range(2):  # builds the kernels on a first run
            self._run(self.folders[0])

    def _run(self, raws):
        cfg = self.cfg
        from egm_unet_torch.cli.eval_clipseg import fused_masks

        return fused_masks(self.clipseg, self.unet, self.cond, raws, float(cfg["alpha"]),
                           base_size=cfg["base_size"], clip_size=cfg["clip_size"],
                           clip_batch=cfg["clip_batch"], unet_batch=cfg["unet_batch"],
                           device=self.device)

    def window(self, seconds: float, tracer) -> None:
        n, last, cur = 0, {}, [None, None]
        self.unet_out, self.clip_out = {}, {}
        hooks = (keep_outputs(self.unet, lambda: cur[0]),
                 keep_outputs(self.clipseg, lambda: cur[1]))
        try:
            with tracer.window():
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    k = n % len(self.folders)
                    cur[0], cur[1] = self.unet_out[k], self.clip_out[k] = [], []
                    with record_function("bench.folder"):
                        last[k] = self._run(self.folders[k])
                    n += 1
                self.elapsed = time.perf_counter() - t0
        finally:
            for h in hooks:
                h.remove()
        self.n_folders, self.last = n, last
        self.images = n * int(self.mix["folder"])
        self.attempted = self.images

    def e2e(self) -> dict:
        return {"fusion_img_per_s": self.images / self.elapsed}

    def counts(self) -> dict:
        cfg, per = self.cfg, int(self.mix["folder"])
        h, w = self.folders[0][0].shape[:2]
        hw = P.short_side((h, w), cfg["base_size"])
        return {"folders": self.n_folders, "images": self.images, "seconds": self.elapsed,
                "pairs": self.images * int(cfg["prompts"]),
                "clip_forwards": self.n_folders * -(-per * int(cfg["prompts"]) // cfg["clip_batch"]),
                "unet_forwards": self.n_folders * -(-per // cfg["unet_batch"]),
                "bucket": P.bucket_hw(hw)}

    def release(self) -> None:
        self.sample = ran(self.last, int(self.wl["check_folders"]), self.seed)
        keep = lambda d: {k: [t.float().cpu() for t in d[k]] for k in self.sample}  # noqa: E731
        self.unet_out, self.clip_out = keep(self.unet_out), keep(self.clip_out)
        del self.clipseg, self.unet
        self.free_cache()

    def check(self):
        self.exact_reference()
        cfg, u = self.cfg, self.cfg["unet"]
        cs = ref_clipseg.build(self.clip_w, self.device, **self.ref_kw)
        un = ref_unet.build(u["model"], u["base_c"], u["num_classes"], self.unet_w, self.device)
        parts, u_err, c_err = [], [], []
        for k in self.sample:
            served = self.last[k]
            margins, cl, ul = self.reference(cs, un, self.folders[k])
            pairs = self.chunks(ul, cl, self.unet_out[k], self.clip_out[k])
            fault = None
            if len(served) != len(self.folders[k]) or pairs is None:
                fault = "masks or branch logits missing, or of other shapes"
            for raw, s in zip(self.folders[k], served):
                if tuple(s.shape) != tuple(raw.shape[:2]) or not np.isin(s, (0, 255)).all():
                    fault = fault or f"a mask of shape {s.shape} or values other than 0, 255"
            if fault:
                return fail_check("mask_gap", self.limit("mask_gap"), f"folder {k}: {fault}",
                                  self.log)
            for which, got, ref in pairs:
                (u_err if which == "unet" else c_err).append(P.logit_err(got, ref))
            parts += [P.mask_gap(m, torch.from_numpy(s > 0)) for m, s in zip(margins, served)]
        del cs, un
        self.free_cache()
        return [Check("unet_logit_err", P.rel_rms(u_err), self.limit("unet_logit_err")),
                Check("clip_logit_err", P.rel_rms(c_err), self.limit("clip_logit_err")),
                *gap_check(parts, self.limit("mask_gap"), self.log)]

    def chunks(self, ul, cl, got_u, got_c):
        """``(branch, program's logits, reference's)`` per forward the
        program ran for a folder, in its order: the UNet by bucket (first
        seen first) in chunks of ``unet_batch``, CLIPSeg on the image-major
        (image, prompt) rows in chunks of ``clip_batch``; their padding rows
        left out.  None where the forwards do not line up."""
        cfg, out = self.cfg, []
        buckets = {}
        for i, u in enumerate(ul):
            buckets.setdefault(tuple(u.shape), []).append(i)
        ub, cb = int(cfg["unet_batch"]), int(cfg["clip_batch"])
        expect = [("unet", torch.stack([ul[i] for i in idxs[s:s + ub]]))
                  for idxs in buckets.values() for s in range(0, len(idxs), ub)]
        expect += [("clip", cl[s:s + cb]) for s in range(0, len(cl), cb)]
        got = list(got_u) + [g[..., 0] for g in got_c]
        if len(got) != len(expect):
            return None
        for (which, ref), g in zip(expect, got):
            if tuple(g.shape[1:]) != tuple(ref.shape[1:]) or g.shape[0] < ref.shape[0]:
                return None
            out.append((which, g[:ref.shape[0]], ref))
        return out

    @torch.no_grad()
    def reference(self, cs, un, raws):
        """The fused margin (paving - background) at each raw frame's size;
        the CLIPSeg logits [N * prompts, S, S] (image-major) and each image's
        UNet logits [bucket h, bucket w, classes] on its padded input, on the
        CPU."""
        cfg, dev, block = self.cfg, self.device, int(self.wl["check_block"])
        size, n_p = cfg["clip_size"], int(cfg["prompts"])
        small, clip_in = [], []
        for raw in raws:
            hw = P.short_side(raw.shape[:2], cfg["base_size"])
            small.append(P.normalize(P.pil_resize(raw, hw), P.TP_MEAN, P.TP_STD))
            clip_in.append(P.normalize(P.pil_resize(raw, (size, size)),
                                       P.IMAGENET_MEAN, P.IMAGENET_STD))
        imgs = torch.from_numpy(np.repeat(np.stack(clip_in), n_p, axis=0)).to(dev)
        conds = self.cond.float().repeat(len(raws), 1)
        cl = torch.cat([cs(imgs[s:s + block], conds[s:s + block])
                        for s in range(0, imgs.shape[0], block)])
        cl = cl.reshape(len(raws), n_p, size, size).permute(0, 2, 3, 1)
        out, uls = [], []
        for i, raw in enumerate(raws):
            rh, rw = small[i].shape[:2]
            x = P.padded([small[i]], P.bucket_hw((rh, rw)))
            ul_full = un(torch.from_numpy(x).to(dev))[0]
            uls.append(ul_full.cpu())
            fused = P.bilinear(cl[i], (rh, rw)) + float(cfg["alpha"]) * ul_full[:rh, :rw]
            margin = fused[..., 1] - fused[..., 0]
            out.append(P.nearest_pil(margin, raw.shape[:2]).cpu())
        cl_flat = cl.permute(0, 3, 1, 2).reshape(-1, size, size).cpu()
        return out, cl_flat, uls
