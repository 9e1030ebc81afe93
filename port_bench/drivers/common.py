"""What the drivers share: seeded weights handed to the program the way its
users hand them (a trainer's checkpoint directory, which the program folds
itself), the reference's logits in blocks, and the numbers a driver keeps.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from port_bench.core import Check
from port_bench.reference import pipeline
from port_bench.reference import unet as ref_unet
from port_bench.weights import make_weights, shapes_of


class DriverBase:
    """The harness's protocol: ``setup``, ``window(seconds, tracer)``,
    ``memory_peak``, ``e2e``, ``attempted`` / ``failed``, ``release`` (free
    the program's state), ``check`` (a list of ``Check``), ``counts``."""

    def __init__(self, cell, seed: int, device: torch.device, log):
        self.cell, self.seed, self.device, self.log = cell, int(seed), device, log
        self.cfg, self.mix, self.wl = cell.config, cell.traffic, cell.workload
        self.attempted = self.failed = 0

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.max_memory_allocated(self.device))

    def release(self) -> None:
        pass

    def counts(self) -> Dict:
        return {}

    def limit(self, name: str) -> float:
        return float(self.wl["limits"][name])

    def free_cache(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def exact_reference(self) -> None:
        """float32 without TF32 for the reference's products, from here on
        (the program's state is freed before the check)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def exact():
    """float32 without TF32 inside, the flags as they were after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def unet_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The unfolded (BatchNorm) graph's state dict, drawn on ``device``."""
    meta = ref_unet.build(cfg["model"], cfg["base_c"], cfg["num_classes"], device="meta")
    return make_weights(shapes_of(meta), seed, device)


def balance(weights: Dict[str, torch.Tensor], margin: torch.Tensor, scale: float = 1.0,
            key: str = "out_conv.bias") -> None:
    """Shift the output layer's class biases so that the median margin on
    ``margin`` (the reference's, from a frame of the cell's traffic) is 0.

    A network with random weights mostly paints one class everywhere (its
    ReLU features' means leak into the margin); its masks then carry little
    to compare.  A trained one splits a frame; so do these weights after the
    shift.  ``scale``: the factor the UNet's logits take in the margin."""
    shift = float(margin.float().median()) / scale
    with torch.no_grad():
        weights[key][1] -= shift / 2
        weights[key][0] += shift / 2


def balanced_unet_weights(cfg: dict, seed: int, device, frame: np.ndarray
                          ) -> Dict[str, torch.Tensor]:
    """``unet_weights`` balanced on one frame through the reference."""
    w = unet_weights(cfg, seed, device)
    ref = ref_unet.build(cfg["model"], cfg["base_c"], cfg["num_classes"], w, device)
    hw = pipeline.short_side(frame.shape[:2], cfg["base_size"])
    x = pipeline.normalize(pipeline.pil_resize(frame, hw), pipeline.TP_MEAN, pipeline.TP_STD)
    with exact():
        margin, _ = unet_margins(ref, pipeline.padded([x], pipeline.bucket_hw(hw)), device, 1)
    balance(w, margin[0, :hw[0], :hw[1]])
    del ref
    forget_peak(device)
    return w


def forget_peak(device) -> None:
    """Free what the harness's own reference left cached and restart the
    device's peak: ``memory_peak_bytes`` is the program's."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def write_checkpoint(state: Dict[str, torch.Tensor]) -> str:
    """A trainer's checkpoint directory (``<epoch>/checkpoint.pt`` holding
    ``{"state": {"model": ...}}``) under TMPDIR; the caller removes it."""
    d = tempfile.mkdtemp(prefix="port_bench_weights_")
    os.makedirs(os.path.join(d, "0"))
    torch.save({"state": {"model": {k: v.cpu() for k, v in state.items()}},
                "epoch": 0, "best_dice": 0.0}, os.path.join(d, "0", "checkpoint.pt"))
    return d


def remove(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


@torch.no_grad()
def unet_margins(model, x: np.ndarray, device, block: int,
                 dtype=torch.float32) -> tuple:
    """The reference's margins l1 - l0 and logits (float32, on the CPU) for
    a float32 NHWC batch cast to ``dtype``, ``block`` images at a time on
    ``device``."""
    logits = torch.cat([model(torch.from_numpy(x[s:s + block]).to(device, dtype)).float().cpu()
                        for s in range(0, x.shape[0], block)])
    return logits[..., 1] - logits[..., 0], logits


def reference_pair(cfg: dict, weights, device) -> list:
    """``[(reference, dtype)]``: float32, and the same weights computing in
    the configuration's dtype (parameters and input rounded to it; the
    BatchNorms normalise in float32 and round their output)."""
    build = lambda: ref_unet.build(cfg["model"], cfg["base_c"], cfg["num_classes"],  # noqa: E731
                                   weights, device)
    low = getattr(torch, cfg["dtype"])
    return [(build(), torch.float32), (build().to(low), low)]


def keep_outputs(module, sink: Callable[[], Optional[list]]):
    """A forward hook on ``module`` that appends a reference to each output
    (no copy, no work on the device) to the list ``sink()`` returns, if
    any; returns the hook's handle."""
    def hook(mod, args, out):
        lst = sink()
        if lst is not None:
            lst.append(out["out"] if isinstance(out, dict)
                       else out[0] if isinstance(out, tuple) else out)
    return module.register_forward_hook(hook)


def ran(last: dict, sample_size: int, seed: int) -> List[int]:
    """A seeded sample of the pool entries the window ran."""
    from port_bench.traffic import generator

    keys = sorted(last)
    rng = generator.rng_for(seed, 4)
    return sorted(int(keys[i]) for i in rng.choice(len(keys), size=min(sample_size, len(keys)),
                                                   replace=False))


def gap_check(parts, limit: float, log) -> List[Check]:
    r = pipeline.combine(parts)
    log(f"compared {r['pixels']} pixels: {r['flips']} flipped "
        f"(share {r['flip_share']!r}), widest flipped margin {r['gap']!r}, "
        f"margin rms {r['rms']!r}, reference foreground share {r['fg_share']!r}, "
        f"mean margin error inferred from the flips {r['err_est']!r} rms")
    return [Check("mask_gap", r["mask_gap"], limit)]


def fail_check(name: str, limit: float, why: str, log) -> List[Check]:
    """A compared number that cannot be read: it fails."""
    log(f"check {name} cannot be read: {why}")
    return [Check(name, float("inf"), limit)]
