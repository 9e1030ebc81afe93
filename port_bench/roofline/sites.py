"""Bytes and operations of each hand-written kernel's calls in one forward,
counted from the model's layer shapes (the counts of the port's
``chip_smoke.py``, frozen here): a call reads each input byte once and
writes each output byte once; its operations are those the function needs,
not the padded tiles a kernel runs.

- K2 ``conv3x3_gemm`` (3x3, pad 1, ReLU): x, kernel (working dtype), float32
  bias, out; 2 B H W 9 C Co.
- K5 ``up_concat_conv`` (x1 upsampled 2x, concatenated after x2, 3x3):
  x2, x1, kernel, bias, out; 2 B H W 9 (C2 + C1) Co.
- K1 ``mca_fused``: x read and written, three float32 gate vectors; 40 per
  element.
- K6 ``csa_attention``: q, k, v read, out written; two score products and
  one weighted sum, 6 B heads S^2 hd.
"""

from __future__ import annotations

from typing import List, NamedTuple

from port_bench.roofline import ITEMSIZE, bound_s


class Site(NamedTuple):
    op: str
    nbytes: float
    flops: float


def conv3x3(b, h, w, c, co, dtype) -> Site:
    it = ITEMSIZE[dtype]
    nb = b * h * w * c * it + 9 * c * co * it + co * 4 + b * h * w * co * it
    return Site("conv3x3_gemm", nb, 2.0 * b * h * w * 9 * c * co)


def up_concat(b, h, w, c2, c1, co, dtype) -> Site:
    it = ITEMSIZE[dtype]
    nb = (b * h * w * c2 * it + b * (h // 2) * (w // 2) * c1 * it
          + 9 * (c2 + c1) * co * it + co * 4 + b * h * w * co * it)
    return Site("up_concat_conv", nb, 2.0 * b * h * w * 9 * (c2 + c1) * co)


def mca(b, h, w, c, dtype) -> Site:
    it = ITEMSIZE[dtype]
    return Site("mca_fused", 2 * b * h * w * c * it + 4 * b * (h + w + c),
                40.0 * b * h * w * c)


def unet_sites(model: str, base_c: int, batch: int, hw, dtype: str) -> List[Site]:
    """The K1 / K2 / K5 calls of one forward of the folded ``egm_unet``
    (A+B+C) or ``grfb_unet`` on the default route at the bucket ``hw``."""
    if model not in ("egm_unet", "grfb_unet"):
        raise ValueError(f"no site list for {model!r}")
    edge, use_mca = model == "egm_unet", model == "egm_unet"
    c, b = base_c, batch
    h, w = hw
    at = lambda k: (h >> k, w >> k)  # noqa: E731
    sites = [conv3x3(b, h, w, 3, c, dtype), conv3x3(b, h, w, c, c, dtype)]
    widths = [c, 2 * c, 4 * c, 8 * c, 8 * c]
    for k in range(1, 5):
        cin, ck = widths[k - 1], widths[k]
        hk, wk = at(k)
        sites.append(conv3x3(b, hk, wk, cin, ck, dtype))
        if use_mca:
            sites.append(mca(b, hk, wk, ck, dtype))
        sites.append(conv3x3(b, hk, wk, ck, ck, dtype))
        if edge:  # the EGRFB's ctx0: a plain 3x3 down to max(C // 8, 4)
            sites.append(conv3x3(b, hk, wk, ck, max(ck // 8, 4), dtype))
    # decoder k = 3..0: x2 the skip of level k, x1 the map below; the first
    # conv to the mid width (C2 + C1) // 2, the second to the stage's width
    below = 8 * c
    for k, out in ((3, 4 * c), (2, 2 * c), (1, c), (0, c)):
        skip = widths[k]
        hk, wk = at(k)
        mid = (skip + below) // 2
        sites.append(up_concat(b, hk, wk, skip, below, mid, dtype))
        sites.append(conv3x3(b, hk, wk, mid, out, dtype))
        below = out
    return sites


def csa_sites(batch: int, seq: int, width: int, heads: int, blocks: int,
              dtype: str) -> List[Site]:
    """K6 once per block of a CLIP tower's dense pass."""
    it = ITEMSIZE[dtype]
    hd = width // heads
    one = Site("csa_attention", 4.0 * batch * seq * width * it,
               6.0 * batch * heads * seq * seq * hd)
    return [one] * blocks


def bound_of(sites: List[Site], dtype: str) -> float:
    """Seconds: the sum of each call's bound."""
    return sum(bound_s(s.nbytes, s.flops, dtype) for s in sites)
