"""A whole forward's model FLOPs from the layer shapes: the plain reference
run on the meta device under ``torch.utils.flop_counter``, which counts the
convolutions and matrix products (2 per multiply-add) and nothing else, so
resizes, pools and elementwise work are not model FLOPs."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode


def _count(model, *inputs) -> float:
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(*inputs)
    return float(fc.get_total_flops())


@functools.lru_cache(maxsize=8)
def unet_flops(model: str, base_c: int, num_classes: int, hw: tuple) -> float:
    """FLOPs of one image's forward at the bucket ``hw``."""
    from port_bench.reference import unet

    ref = unet.build(model, base_c, num_classes, device="meta")
    return _count(ref, torch.empty(1, hw[0], hw[1], 3, device="meta"))


@functools.lru_cache(maxsize=8)
def clipseg_flops(size: int, **kw) -> float:
    """FLOPs of one (image, prompt) pair's CLIPSeg forward at ``size``."""
    from port_bench.reference import clipseg

    ref = clipseg.build(device="meta", **kw)
    embed = ref.film_mul.kernel.shape[0]
    return _count(ref, torch.empty(1, size, size, 3, device="meta"),
                  torch.empty(1, embed, device="meta"))
