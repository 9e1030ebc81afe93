"""The serving forward, ``serving.Predictor.forward``, on device-resident
normalised NHWC batches at one bucket: what users pay accelerator time for.

Set-up: the unfolded weights drawn from the seed on the device, written as
a trainer's checkpoint that ``Predictor.from_checkpoint`` folds; a pool of
frames, normalised with the TP statistics and zero-padded to the bucket on
the host, grouped into ``pool_batches`` batches and copied to the device in
the working dtype; every batch run once.  Window: the batches in turn,
back to back, then one synchronise; the rate is every image over the whole
window.  Check: a seeded sample of the pool's batches, the logits (kept by a
forward hook, no copy) of their last run in the window against the float32
reference on the float32 batch, in units of the reference's own error when
it computes in bfloat16; and the masks, pixel for pixel, against the argmax
of those logits.

The workload's ``stand_in`` (a dtype name), for the control only, puts the
plain reference in the program's place with its convolutions' operands
rounded to that dtype: the window and the check run as for the program.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from port_bench.core import Check
from port_bench.drivers.common import (DriverBase, balanced_unet_weights, fail_check,
                                       gap_check, keep_outputs, ran, reference_pair, remove,
                                       unet_margins, write_checkpoint)
from port_bench.reference import pipeline
from port_bench.reference import unet as ref_unet
from port_bench.traffic import generator


class StandIn:
    """The reference in ``Predictor``'s place: ``forward`` returns the
    masks, ``model`` the logits (a module, hooked as the program's is),
    ``block`` images at a time."""

    dtype = torch.float32

    def __init__(self, ref, low: torch.dtype, block: int):
        self.model = _Blocks(ref, low, block)

    def forward(self, x):
        return self.model(x).argmax(dim=-1)


class _Blocks(torch.nn.Module):
    def __init__(self, ref, low: torch.dtype, block: int):
        super().__init__()
        self.ref, self.low, self.block = ref, low, block

    @torch.no_grad()
    def forward(self, x):
        with ref_unet.low_precision(self.low):
            return torch.cat([self.ref(x[s:s + self.block])
                              for s in range(0, x.shape[0], self.block)])


class Driver(DriverBase):
    def setup(self) -> None:
        from egm_unet_torch.serving import Predictor, PredictorConfig

        cfg, mix = self.cfg, self.mix
        frames = generator.frames(mix, self.seed)
        self.weights = balanced_unet_weights(cfg, self.seed, self.device, frames[0])
        if self.wl.get("stand_in"):
            ref = ref_unet.build(cfg["model"], cfg["base_c"], cfg["num_classes"],
                                 self.weights, self.device)
            self.pred = StandIn(ref, getattr(torch, self.wl["stand_in"]),
                                int(self.wl["check_block"]))
        else:
            ckpt = write_checkpoint(self.weights)
            try:
                pcfg = PredictorConfig(
                    model_name=cfg["model"], base_c=cfg["base_c"],
                    num_classes=cfg["num_classes"], batch_size=int(mix["batch"]),
                    base_size=cfg["base_size"], dtype=cfg["dtype"],
                    conv_impl=cfg["conv_impl"], upsample_impl=cfg["upsample_impl"],
                    quant=cfg.get("quant"))
                self.pred = Predictor.from_checkpoint(ckpt, pcfg, device=self.device)
            finally:
                remove(ckpt)
        hw = pipeline.bucket_hw(frames[0].shape[:2])
        if any(pipeline.bucket_hw(f.shape[:2]) != hw for f in frames):
            raise ValueError("a bucket cell's frames must share one bucket")
        normed = [pipeline.normalize(f, pipeline.TP_MEAN, pipeline.TP_STD) for f in frames]
        self.host_batches = [pipeline.padded([normed[i] for i in g], hw)
                             for g in generator.groups(mix, self.seed, "batch", "pool_batches")]
        dtype = self.pred.dtype
        self.batches = [torch.from_numpy(b).to(self.device, dtype) for b in self.host_batches]
        self.hw = hw
        for x in self.batches:  # builds the kernels on a first run; warms every batch
            self.pred.forward(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, tracer) -> None:
        n, last, logits, cur = 0, {}, {}, [None]
        handle = keep_outputs(self.pred.model, lambda: cur[0])
        try:
            with tracer.window():
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    k = n % len(self.batches)
                    cur[0] = logits[k] = []
                    with record_function("bench.forward"):
                        last[k] = self.pred.forward(self.batches[k])
                    n += 1
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.elapsed = time.perf_counter() - t0
        finally:
            handle.remove()
        self.forwards, self.last, self.logits = n, last, logits
        self.images = n * int(self.mix["batch"])
        self.attempted = self.images

    def e2e(self) -> dict:
        return {"batch_img_per_s": self.images / self.elapsed}

    def counts(self) -> dict:
        return {"forwards": self.forwards, "images": self.images, "seconds": self.elapsed,
                "batch": int(self.mix["batch"]), "hw": self.hw}

    def release(self) -> None:
        self.sample = ran(self.last, int(self.wl["check_batches"]), self.seed)
        self.last = {k: self.last[k].cpu() for k in self.sample}
        self.logits = {k: [t.float().cpu() for t in self.logits[k]] for k in self.sample}
        del self.pred, self.batches
        self.free_cache()

    def check(self):
        self.exact_reference()
        cfg, block = self.cfg, int(self.wl["check_block"])
        refs = reference_pair(cfg, self.weights, self.device)
        parts, err, err16, fl, fl16, off = [], [], [], [0, 0.0], [0, 0.0], 0
        for k in self.sample:
            (margin, logits), (m16, l16) = (unet_margins(r, self.host_batches[k], self.device,
                                                         block, dt)
                                            for r, dt in refs)
            served, got = self.last[k], self.logits[k]
            fault = ("served shape " + str(tuple(served.shape))
                     if served.shape != margin.shape else "no logits from the window"
                     if len(got) != 1 or got[0].shape != logits.shape
                     else "a class other than 0 and 1"
                     if not bool(((served == 0) | (served == 1)).all()) else None)
            if fault:
                return fail_check("logit_err_ratio", self.limit("logit_err_ratio"),
                                  f"batch {k}: {fault}", self.log)
            parts.append(pipeline.mask_gap(margin, served == 1))
            off += int((served != got[0].argmax(dim=-1)).sum())
            err.append(pipeline.logit_err(got[0], logits))
            err16.append(pipeline.logit_err(l16, logits))
            fl = [a + b for a, b in zip(fl, pipeline.flips(margin, served == 1))]
            fl16 = [a + b for a, b in zip(fl16, pipeline.flips(margin, m16 > 0))]
        del refs
        self.free_cache()
        e, e16 = pipeline.rel_rms(err), pipeline.rel_rms(err16)
        self.log(f"logits: program error {e!r}, bfloat16 reference's {e16!r} (relative rms); "
                 f"masks: program flips {fl}, bfloat16 reference's {fl16} (count, margin sum); "
                 f"flip ratio {pipeline.ratio(fl[0], fl16[0])!r}")
        gap_check(parts, float("inf"), self.log)  # logged, not compared
        self.log(f"mask flip-mass ratio {pipeline.ratio(fl[1], fl16[1])!r} (not compared: "
                 "PERF.md)")
        return [Check("logit_err_ratio", pipeline.ratio(e, e16), self.limit("logit_err_ratio")),
                Check("mask_logit_off", float(off), self.limit("mask_logit_off"))]
