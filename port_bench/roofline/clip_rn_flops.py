"""Model FLOPs of one fine-tune triple of a ModifiedResNet CLIP (an image,
a long and a short caption): the convolutions and products of both towers'
forward passes, the text tower twice, counted on the plain reference
(``reference/clip_resnet.py``) at the meta device under
``torch.utils.flop_counter``, times 3 for the forward and the two products
of each backward.  Recomputed blocks are not model FLOPs; pools,
BatchNorms and the loss's products are left out.  The attention pool
counts the mean token's query alone, as upstream computes it."""

from __future__ import annotations

import functools

import torch

from port_bench.roofline.flops import _count


def clip_rn_triple_flops(**kw) -> float:
    return _triple_flops(tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                                      for k, v in kw.items())))


@functools.lru_cache(maxsize=8)
def _triple_flops(items: tuple) -> float:
    from port_bench.reference import clip_resnet, longclip

    kw = dict(items)
    ref = clip_resnet.build(device="meta", **kw)
    r, ctx = kw["resolution"], kw["context"]
    image = torch.empty(1, r, r, 3, device="meta")
    ids = torch.zeros(1, ctx, dtype=torch.long, device="meta")
    return 3.0 * _count(lambda *a: longclip.features(ref, *a), image, ids, ids)
