"""SegFormer served through ``serving.Predictor.forward``, as ``cli/predict.py
--model segformer_b5`` and ``cli/serve.py --model segformer_b5`` serve it:
``bucket_forward``'s driver (the same device-resident batches at one
bucket, the same window and rate, the same two numbers compared) with
SegFormer's weights, reference and stand-in.

What differs:
- the program's SegFormer module is imported with this module, so a
  program without it fails the cell at once (ImportError), before any
  kernel is built;
- the weights: ``weights.py``'s draw for the BatchNorm graph's names (those
  of ``reference/segformer.py``), the classifier's bias balanced on one
  frame through the float32 reference (``common.balance``), written as a
  trainer's checkpoint that ``Predictor.from_checkpoint`` folds;
- the program: ``PredictorConfig(model_name=cfg["model"])``.  The
  configuration's widths are the program's preset of that name
  (``test_bench_segformer.py`` holds them equal); a rehearsal's tiny widths
  stand in for the preset while its predictor is built (``preset``);
- the reference pair: ``reference/segformer.py`` in float32, and in
  bfloat16 (convs and Linears in bfloat16, the norms in float32), whose
  error against the float32 one is the unit of ``logit_err_ratio``;
- the control's stand-in: the float32 reference in the program's place
  with every conv's and Linear's input and weight rounded to the workload's
  ``stand_in`` dtype (``reference/segformer.py::low_precision``).
"""

from __future__ import annotations

import contextlib

import torch

from egm_unet_torch.models import segformer as program
from port_bench.core import Check
from port_bench.drivers import bucket_forward
from port_bench.drivers.common import (balance, exact, fail_check, forget_peak, remove,
                                       unet_margins, write_checkpoint)
from port_bench.reference import pipeline
from port_bench.reference import segformer as ref_seg
from port_bench.traffic import generator
from port_bench.weights import make_weights, shapes_of

BIAS = "head.linear_pred.bias"  # the classifier's bias, balanced


def program_config(cfg: dict) -> program.SegFormerConfig:
    """The program's config at the configuration's widths."""
    a = cfg["segformer"]
    return program.SegFormerConfig(
        hidden_sizes=tuple(a["hidden_sizes"]), depths=tuple(a["depths"]),
        num_attention_heads=tuple(a["num_attention_heads"]), sr_ratios=tuple(a["sr_ratios"]),
        patch_sizes=tuple(a["patch_sizes"]), strides=tuple(a["strides"]),
        mlp_ratio=a["mlp_ratio"], decoder_hidden_size=a["decoder_hidden_size"],
        layer_norm_eps=a["layer_norm_eps"], num_labels=cfg["num_labels"])


@contextlib.contextmanager
def preset(cfg: dict):
    """The program's preset ``cfg["model"]`` at the configuration's widths
    inside the block, as it was after."""
    name = cfg["model"]
    was = program.PRESETS[name]
    program.PRESETS[name] = program_config(cfg)
    try:
        yield
    finally:
        program.PRESETS[name] = was


def reference(cfg: dict, weights, device, dtype=torch.float32):
    return ref_seg.build(cfg["segformer"], cfg["num_labels"], weights, device, dtype)


def segformer_weights(cfg: dict, seed: int, device, frame) -> dict:
    """The BatchNorm graph's state dict drawn on ``device``, the classes
    balanced on ``frame`` through the float32 reference."""
    meta = ref_seg.build(cfg["segformer"], cfg["num_labels"], device="meta")
    w = make_weights(shapes_of(meta), seed, device)
    ref = reference(cfg, w, device)
    hw = pipeline.short_side(frame.shape[:2], cfg["base_size"])
    x = pipeline.normalize(pipeline.pil_resize(frame, hw), pipeline.TP_MEAN, pipeline.TP_STD)
    with exact():
        margin, _ = unet_margins(ref, pipeline.padded([x], pipeline.bucket_hw(hw)), device, 1)
    balance(w, margin[0, :hw[0], :hw[1]], key=BIAS)
    del ref
    forget_peak(device)
    return w


class _Blocks(torch.nn.Module):
    def __init__(self, ref, low: torch.dtype, block: int):
        super().__init__()
        self.ref, self.low, self.block = ref, low, block

    @torch.no_grad()
    def forward(self, x):
        with ref_seg.low_precision(self.low):
            return torch.cat([self.ref(x[s:s + self.block])
                              for s in range(0, x.shape[0], self.block)])


class StandIn(bucket_forward.StandIn):
    """The reference in ``Predictor``'s place, its convs' and Linears'
    operands rounded to ``low``."""

    def __init__(self, ref, low: torch.dtype, block: int):
        self.model = _Blocks(ref, low, block)


class Driver(bucket_forward.Driver):
    def setup(self) -> None:
        from egm_unet_torch.serving import Predictor, PredictorConfig

        cfg, mix = self.cfg, self.mix
        frames = generator.frames(mix, self.seed)
        self.weights = segformer_weights(cfg, self.seed, self.device, frames[0])
        if self.wl.get("stand_in"):
            self.pred = StandIn(reference(cfg, self.weights, self.device),
                                getattr(torch, self.wl["stand_in"]), int(self.wl["check_block"]))
        else:
            ckpt = write_checkpoint(self.weights)
            try:
                pcfg = PredictorConfig(model_name=cfg["model"], num_classes=cfg["num_labels"],
                                       batch_size=int(mix["batch"]), base_size=cfg["base_size"],
                                       dtype=cfg["dtype"])
                with preset(cfg):
                    self.pred = Predictor.from_checkpoint(ckpt, pcfg, device=self.device)
            finally:
                remove(ckpt)
        hw = pipeline.bucket_hw(frames[0].shape[:2])
        if any(pipeline.bucket_hw(f.shape[:2]) != hw for f in frames):
            raise ValueError("a bucket cell's frames must share one bucket")
        normed = [pipeline.normalize(f, pipeline.TP_MEAN, pipeline.TP_STD) for f in frames]
        self.host_batches = [pipeline.padded([normed[i] for i in g], hw)
                             for g in generator.groups(mix, self.seed, "batch", "pool_batches")]
        self.batches = [torch.from_numpy(b).to(self.device, self.pred.dtype)
                        for b in self.host_batches]
        self.hw = hw
        for x in self.batches:  # builds the kernels on a first run; warms every batch
            self.pred.forward(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def check(self):
        self.exact_reference()
        cfg, block = self.cfg, int(self.wl["check_block"])
        low = getattr(torch, cfg["dtype"])
        refs = [(reference(cfg, self.weights, self.device), torch.float32),
                (reference(cfg, self.weights, self.device, low), low)]
        err, err16, fl, fl16, off = [], [], [0, 0.0], [0, 0.0], 0
        for k in self.sample:
            (margin, logits), (m16, l16) = (unet_margins(r, self.host_batches[k], self.device,
                                                         block, dt) for r, dt in refs)
            served, got = self.last[k], self.logits[k]
            fault = ("served shape " + str(tuple(served.shape))
                     if served.shape != margin.shape else "no logits from the window"
                     if len(got) != 1 or got[0].shape != logits.shape
                     else "a class other than 0 and 1"
                     if not bool(((served == 0) | (served == 1)).all()) else None)
            if fault:
                return fail_check("logit_err_ratio", self.limit("logit_err_ratio"),
                                  f"batch {k}: {fault}", self.log)
            off += int((served != got[0].argmax(dim=-1)).sum())
            err.append(pipeline.logit_err(got[0], logits))
            err16.append(pipeline.logit_err(l16, logits))
            fl = [a + b for a, b in zip(fl, pipeline.flips(margin, served == 1))]
            fl16 = [a + b for a, b in zip(fl16, pipeline.flips(margin, m16 > 0))]
        del refs
        self.free_cache()
        e, e16 = pipeline.rel_rms(err), pipeline.rel_rms(err16)
        self.log(f"logits: program error {e!r}, bfloat16 reference's {e16!r} (relative rms); "
                 f"masks: program flips {fl}, bfloat16 reference's {fl16} (count, margin sum)")
        return [Check("logit_err_ratio", pipeline.ratio(e, e16), self.limit("logit_err_ratio")),
                Check("mask_logit_off", float(off), self.limit("mask_logit_off"))]
