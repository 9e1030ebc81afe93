"""Model FLOPs of one SegFormer image at a bucket: the plain reference
(``reference/segformer.py``) run on the meta device under
``torch.utils.flop_counter``, which counts the convolutions (the depthwise
ones at their groups), the Linears and the attention's two products, 2 per
multiply-add; resizes, norms, softmax and GELU are not model FLOPs."""

from __future__ import annotations

import functools

import torch

from port_bench.roofline.flops import _count


def segformer_flops(arch: dict, num_labels: int, hw: tuple) -> float:
    """FLOPs of one image's forward at the bucket ``hw``; ``arch`` a
    configuration's ``segformer`` group."""
    from port_bench.reference.segformer import ARCH_KEYS

    key = tuple((k, tuple(arch[k]) if isinstance(arch[k], list) else arch[k])
                for k in ARCH_KEYS)
    return _flops(key, int(num_labels), tuple(hw))


@functools.lru_cache(maxsize=8)
def _flops(key: tuple, num_labels: int, hw: tuple) -> float:
    from port_bench.reference import segformer

    ref = segformer.build(dict(key), num_labels, device="meta")
    return _count(ref, torch.empty(1, hw[0], hw[1], 3, device="meta"))
