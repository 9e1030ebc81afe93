"""Model FLOPs of one Long-CLIP fine-tune triple (an image, a long and a
short caption): the products and the patch convolution of both towers'
forward passes, the text tower twice, counted on the plain reference at the
meta device under ``torch.utils.flop_counter``, times 3 for the forward and
the two products of each backward.  Recomputed blocks are not model FLOPs,
and the loss's products (B x B similarities, the PCA) are left out."""

from __future__ import annotations

import functools

import torch

from port_bench.roofline.flops import _count


@functools.lru_cache(maxsize=8)
def longclip_triple_flops(**kw) -> float:
    from port_bench.reference import longclip

    ref = longclip.build(device="meta", **kw)
    r, ctx = kw["resolution"], kw["context"]
    image = torch.empty(1, r, r, 3, device="meta")
    ids = torch.zeros(1, ctx, dtype=torch.long, device="meta")
    return 3.0 * _count(lambda *a: longclip.features(ref, *a), image, ids, ids)
