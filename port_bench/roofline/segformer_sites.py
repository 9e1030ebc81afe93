"""Bytes and operations of SegFormer's spatial-reduction attention calls in
one forward, from the configuration's widths at a bucket: one call a Block,
q [B, N, C] over k and v [B, M, C] with N the stage's grid and M the grid
after the reduction conv (``sr x sr``, stride ``sr``; M = N where ``sr`` is
1).  A call reads q, k and v once and writes its output once, in the
working dtype; its operations are the two products, ``q k^T`` and ``P v``,
4 B N M C.  The softmax's exponentials are not counted."""

from __future__ import annotations

from typing import List

from port_bench.roofline import ITEMSIZE
from port_bench.roofline.sites import Site


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def stage_grids(arch: dict, hw) -> List[tuple]:
    """``[(H_i, W_i, H'_i, W'_i)]``: each stage's grid and its keys' grid."""
    out, (h, w) = [], hw
    for k, s, r in zip(arch["patch_sizes"], arch["strides"], arch["sr_ratios"]):
        h, w = conv_out(h, k, s, k // 2), conv_out(w, k, s, k // 2)
        out.append((h, w, conv_out(h, r, r, 0), conv_out(w, r, r, 0)) if r > 1 else (h, w, h, w))
    return out


def segformer_attention_sites(arch: dict, batch: int, hw, dtype: str) -> List[Site]:
    """The attention calls of one forward of ``batch`` images at ``hw``."""
    it = ITEMSIZE[dtype]
    sites = []
    for (h, w, hk, wk), c, depth in zip(stage_grids(arch, hw), arch["hidden_sizes"],
                                        arch["depths"]):
        n, m = h * w, hk * wk
        one = Site("segformer_attention", batch * (2 * n + 2 * m) * c * it,
                   4.0 * batch * n * m * c)
        sites += [one] * depth
    return sites
