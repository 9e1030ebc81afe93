"""Bilinear and bicubic resize as separable interpolation matrices, and
nearest resize as an index gather (NHWC).

Port of ``egm_unet_tpu/ops/resize.py``: the same ``(n_out, n_in)`` matrices,
applied as two matmuls (rows, then columns) accumulated in float32, with the
intermediate rounded to the working dtype after the first pass as the JAX
``_apply_separable`` does.

- ``align_corners=True`` is ``nn.Upsample(mode='bilinear',
  align_corners=True)``, the UNet decoder's upsample.
- ``align_corners=False`` is ``F.interpolate(mode='bilinear')``, used to
  resize masks back to the original image size and CLIPSeg logits to the
  UNet grid.
- ``resize_bicubic`` is the Keys cubic with ``a = -0.75`` and replicated
  borders (``F.interpolate(mode='bicubic')``), which resamples the ViT's
  positional grid.
- ``resize_nearest`` has the two index conventions the reference mixes:
  ``'torch'`` = ``floor(i * n_in / n_out)`` and ``'pil'`` =
  ``floor((i + 0.5) * n_in / n_out)``.
- ``upsample2x_rows``: the decoder's upsample of a map split by rows over a
  spatial group (``parallel.use_spatial_group``), each rank's output rows
  from the rows of the global matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from egm_unet_torch.parallel.halo import fetch_rows
from egm_unet_torch.parallel.mesh import Spatial, spatial


@functools.lru_cache(maxsize=256)
def _linear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) row-stochastic linear-interpolation matrix."""
    a = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1:
        # align_corners=True maps the single output to source 0; the
        # half-pixel convention maps it to the (clamped) center.
        src = np.array([0.0 if align_corners else max(0.0, 0.5 * n_in - 0.5)])
    elif align_corners:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    else:
        src = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(n_out)
    a[rows, lo] += 1.0 - frac
    a[rows, hi] += frac
    return a


@functools.lru_cache(maxsize=256)
def linear_taps(n_in: int, n_out: int, align_corners: bool = True):
    """The two non-zero entries of each row of ``_linear_matrix``:
    ``(lo, hi, w_lo, w_hi)`` with ``w_hi = 0`` where ``lo == hi``.  The
    weights are the matrix's own float32 values, so a two-tap blend equals
    the matrix row product."""
    a = _linear_matrix(n_in, n_out, align_corners)
    lo = np.argmax(a != 0, axis=1).astype(np.int32)
    hi = np.minimum(lo + 1, n_in - 1).astype(np.int32)
    rows = np.arange(n_out)
    w_lo = a[rows, lo]
    w_hi = np.where(hi != lo, a[rows, hi], 0.0).astype(np.float32)
    return lo, hi, w_lo, w_hi


_DEVICE_TAPS = {}  # (n_in, weight dtype, device) -> tap tables on the device


def upsample2x_taps(n_in: int, dtype: torch.dtype, device: torch.device):
    """``linear_taps(n_in, 2 * n_in)`` as tensors on ``device``, made once:
    int32 ``lo`` and ``hi``, and float32 ``w_lo`` and ``w_hi`` holding the
    weights rounded to ``dtype``."""
    key = (n_in, dtype, device)
    if key not in _DEVICE_TAPS:
        lo, hi, w_lo, w_hi = linear_taps(n_in, 2 * n_in, True)
        cast = lambda a: torch.from_numpy(a).to(dtype).float().to(device)
        _DEVICE_TAPS[key] = (torch.from_numpy(lo).to(device),
                             torch.from_numpy(hi).to(device), cast(w_lo), cast(w_hi))
    return _DEVICE_TAPS[key]


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic kernel with ``a = -0.75``."""
    t = np.abs(t)
    w = np.where(
        t <= 1.0,
        (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
        np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a, 0.0),
    )
    return w.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _cubic_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    a = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1:
        src = np.array([0.0 if align_corners else max(0.0, 0.5 * n_in - 0.5)])
    elif align_corners:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    else:
        src = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    rows = np.arange(n_out)
    for k in range(-1, 3):
        idx = np.clip(base + k, 0, n_in - 1)  # replicated border
        a[rows, idx] += _cubic_weight(frac - k)
    return a


@functools.lru_cache(maxsize=256)
def _nearest_index(n_in: int, n_out: int, mode: str) -> np.ndarray:
    if mode == "torch":
        idx = np.floor(np.arange(n_out) * n_in / n_out)
    elif mode == "pil":
        idx = np.floor((np.arange(n_out) + 0.5) * n_in / n_out)
    else:
        raise ValueError(f"unknown nearest mode {mode!r}")
    return np.clip(idx.astype(np.int64), 0, n_in - 1)


def _spatial_hw(x: torch.Tensor):
    return (x.shape[1], x.shape[2]) if x.ndim == 4 else (x.shape[0], x.shape[1])


@functools.lru_cache(maxsize=512)
def _matrix_on(cubic: bool, n_in: int, n_out: int, align_corners: bool,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A resize matrix rounded to ``dtype``, as float32 on ``device``, made
    once: a forward then copies nothing to the device for it."""
    a = (_cubic_matrix if cubic else _linear_matrix)(n_in, n_out, align_corners)
    with torch.inference_mode(False):
        return torch.from_numpy(a).to(device, dtype).float()


def _apply_separable(x: torch.Tensor, cubic: bool, out_hw,
                     align_corners: bool) -> torch.Tensor:
    """Rows, then columns, of a floating NHWC or HWC tensor; the matrices are
    rounded to x's dtype, the products summed in float32, and the row pass
    rounded to x's dtype before the column pass."""
    dtype = x.dtype
    (h_in, w_in), (h_out, w_out) = _spatial_hw(x), (int(out_hw[0]), int(out_hw[1]))
    ah_t = _matrix_on(cubic, h_in, h_out, align_corners, dtype, x.device)
    aw_t = _matrix_on(cubic, w_in, w_out, align_corners, dtype, x.device)
    lead = "b" if x.ndim == 4 else ""
    if x.ndim not in (3, 4):
        raise ValueError(f"rank {x.ndim} not supported")
    y = torch.einsum(f"ph,{lead}hwc->{lead}pwc", ah_t, x.float()).to(dtype).float()
    return torch.einsum(f"qw,{lead}pwc->{lead}pqc", aw_t, y).to(dtype)


def resize_bilinear(x: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    return _apply_separable(x, False, out_hw, align_corners)


def resize_bicubic(x: torch.Tensor, out_hw,
                   align_corners: bool = False) -> torch.Tensor:
    return _apply_separable(x, True, out_hw, align_corners)


def resize_nearest(x: torch.Tensor, out_hw, mode: str = "torch") -> torch.Tensor:
    """NHWC, HWC or HW tensor of any dtype; rows, then columns."""
    if x.ndim not in (2, 3, 4):
        raise ValueError(f"rank {x.ndim} not supported")
    ax_h = 1 if x.ndim == 4 else 0
    for axis, n_out in ((ax_h, int(out_hw[0])), (ax_h + 1, int(out_hw[1]))):
        idx = torch.from_numpy(_nearest_index(x.shape[axis], n_out, mode))
        x = x.index_select(axis, idx.to(x.device))
    return x


def upsample2x_rows(x: torch.Tensor, height_in: int, height_out: int,
                    top: int = 0) -> torch.Tensor:
    """``upsample2x_bilinear_align_corners`` (the matmul route) of a map
    split by rows over the spatial group, whose global height is
    ``height_in``, placed ``top`` rows down a map of ``height_out`` rows
    (zero elsewhere, as ``pad_to_match`` pads): this rank's rows
    ``row_range(height_out)`` of it.  Each output row is a row of the global
    matrix ``_linear_matrix(height_in, 2 * height_in)``, not of a matrix of
    this rank's slab, and reads the source rows that row's taps name,
    fetched from the ranks that hold them; the products are rounded and
    summed as ``_apply_separable`` does."""
    sp = spatial()
    h2 = 2 * height_in
    lo_tap, hi_tap, _, _ = linear_taps(height_in, h2, True)
    spans, asks = [], ([], [])
    for a, b in sp.ranges(height_out):
        u0, u1 = max(a - top, 0), min(b - top, h2)
        spans.append((a, b, u0, u1))
        s0 = int(lo_tap[u0]) if u1 > u0 else 0
        asks[0].append(s0)
        asks[1].append(int(hi_tap[u1 - 1]) + 1 if u1 > u0 else s0)
    src = fetch_rows(x, *asks, fill=0.0, scope=Spatial(sp.group, height_in))
    a, b, u0, u1 = spans[sp.group.rank]
    bsz, _, w_in, c = x.shape
    dtype = x.dtype
    out = x.new_zeros((bsz, b - a, 2 * w_in, c))
    if u1 > u0:
        s0 = asks[0][sp.group.rank]
        ah = _matrix_on(False, height_in, h2, True, dtype, x.device)[
            u0:u1, s0:s0 + src.shape[1]]
        aw = _matrix_on(False, w_in, 2 * w_in, True, dtype, x.device)
        y = torch.einsum("ph,bhwc->bpwc", ah, src.float()).to(dtype).float()
        y = torch.einsum("qw,bpwc->bpqc", aw, y).to(dtype)
        out = torch.cat([out[:, :u0 + top - a], y, out[:, u1 + top - a:]], dim=1)
    return out


UPSAMPLE_IMPLS = ("matmul", "fused")


def upsample2x_bilinear_align_corners(x: torch.Tensor,
                                      impl: str | None = None) -> torch.Tensor:
    """The UNet decoder's ``Upsample(scale_factor=2, align_corners=True)``,
    NHWC.  ``impl``: ``"matmul"`` (default), the two interpolation-matrix
    products above, or ``"fused"``, the one-pass ``upsample2x_fused`` kernel
    (``ops/cuda/resize2x.py``), which rounds columns first and so differs
    from the matmul form by a few rounding steps in bfloat16."""
    impl = impl or "matmul"
    if impl == "fused":
        from egm_unet_torch.ops.cuda.resize2x import upsample2x_fused

        return upsample2x_fused(x.contiguous())
    if impl != "matmul":
        raise ValueError(f"unknown upsample impl {impl!r}; choose from "
                         f"{list(UPSAMPLE_IMPLS)}")
    return resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]),
                           align_corners=True)
