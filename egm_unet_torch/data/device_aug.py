"""Paired augmentation on the device (port of
``egm_unet_tpu/data/device_aug.py``).

The host-side train preset (``data/transforms.py::TrainTransform``: random
short-side resize, flips, random crop, normalize) as tensor gathers over a
batch of fixed-size sources: per sample, a short side drawn in [min_size,
max_size], a crop offset in the scaled image and h/v flips; each output pixel
centre maps back to a source coordinate, the image is sampled bilinearly and
the mask by the floor of that coordinate (PIL's NEAREST), both with fill 0
out of bounds (the pad fills of the reference's crop).  Distribution-
equivalent to the host preset, not pixel-identical to PIL's resampling.

The draws (``draw_params``) and the geometry (``augment_with_params``) are
split, so that the same draws can be applied on two devices, or taken from
the JAX package's key.  Everything is NHWC tensors on the caller's device,
float32 coordinates and arithmetic; every division has a tensor divisor,
which CUDA divides correctly rounded as the CPU does (by a Python number it
multiplies by the reciprocal), so the card and the CPU compute the same
bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    # torch.full fills on the device: no host-to-device copy per call
    return x / torch.full((), float(d), dtype=torch.float32, device=x.device)


def to_unit(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 images as float32 in [0, 1]."""
    return _div(images_u8.float(), 255.0)


def draw_params(generator: torch.Generator, b: int, short: int, crop_size: int,
                min_size: int, max_size: int,
                hw: Optional[Tuple[int, int]] = None,
                rows=None) -> Dict[str, torch.Tensor]:
    """Draws for ``b`` sources of size ``hw`` (default ``short`` x ``short``)
    on ``generator``'s device: ``sizes`` (the scaled short side, inclusive on
    both ends, as the reference's ``random.randint``), crop offsets ``oy``,
    ``ox`` (float32, uniform in the scaled image's room past the crop) and
    the booleans ``hflip``, ``vflip`` (p 0.5).  ``rows``: only these of the
    ``b`` draws (data parallel: every rank draws the global batch's from
    one seed and keeps its own rows, ``parallel.rank_rows``)."""
    h, w = hw or (short, short)
    dev = generator.device
    sizes = torch.randint(min_size, max_size + 1, (b,), generator=generator,
                          device=dev)
    scales = _div(sizes.float(), short)
    max_oy = torch.clamp_min(h * scales - crop_size, 0.0)
    max_ox = torch.clamp_min(w * scales - crop_size, 0.0)
    oy = torch.rand(b, generator=generator, device=dev) * max_oy
    ox = torch.rand(b, generator=generator, device=dev) * max_ox
    hflip = torch.rand(b, generator=generator, device=dev) < 0.5
    vflip = torch.rand(b, generator=generator, device=dev) < 0.5
    params = {"sizes": sizes, "oy": oy, "ox": ox, "hflip": hflip, "vflip": vflip}
    if rows is not None:
        idx = torch.as_tensor(rows, device=dev)
        params = {k: v[idx] for k, v in params.items()}
    return params


def source_coords(params: Dict[str, torch.Tensor], short: int, crop_size: int):
    """(src_y [B, crop], src_x [B, crop]): the float32 source coordinate of
    each output row and column, ``(g + o + 0.5) / scale - 0.5`` with ``g``
    the (flipped) output index."""
    dev = params["oy"].device
    scale = _div(params["sizes"].to(dev).float(), short)
    g = torch.arange(crop_size, dtype=torch.float32, device=dev)
    gy = torch.where(params["vflip"].to(dev)[:, None], crop_size - 1 - g, g)
    gx = torch.where(params["hflip"].to(dev)[:, None], crop_size - 1 - g, g)
    src_y = (gy + params["oy"].float()[:, None] + 0.5) / scale[:, None] - 0.5
    src_x = (gx + params["ox"].float()[:, None] + 0.5) / scale[:, None] - 0.5
    return src_y, src_x


def _taps(src: torch.Tensor, n: int):
    """Integer index, clipped index and in-bounds flag of ``src``'s floor."""
    i = torch.floor(src).to(torch.int64)
    return i, i.clamp(0, n - 1), (i >= 0) & (i < n)


def augment_with_params(images: torch.Tensor, masks: torch.Tensor,
                        params: Dict[str, torch.Tensor], mean, std,
                        crop_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, H, W, 3] float (already / 255), masks [B, H, W] integer ->
    ([B, crop, crop, 3] normalized in images' dtype, [B, crop, crop] masks
    in masks' dtype)."""
    b, h, w, _ = images.shape
    dev = images.device
    src_y, src_x = source_coords({k: v.to(dev) for k, v in params.items()},
                                 min(h, w), crop_size)
    y0, y0c, y0v = _taps(src_y, h)
    x0, x0c, x0v = _taps(src_x, w)
    y1c, y1v = (y0 + 1).clamp(0, h - 1), (y0 + 1 >= 0) & (y0 + 1 < h)
    x1c, x1v = (x0 + 1).clamp(0, w - 1), (x0 + 1 >= 0) & (x0 + 1 < w)
    fy = (src_y - torch.floor(src_y))[:, :, None, None]
    fx = (src_x - torch.floor(src_x))[:, None, :, None]
    bi = torch.arange(b, device=dev)[:, None, None]
    img = images.float()

    def tap(yc, yv, xc, xv):
        v = img[bi, yc[:, :, None], xc[:, None, :]]
        valid = (yv[:, :, None] & xv[:, None, :])[..., None]
        return torch.where(valid, v, 0.0)

    top = tap(y0c, y0v, x0c, x0v) * (1 - fx) + tap(y0c, y0v, x1c, x1v) * fx
    bot = tap(y1c, y1v, x0c, x0v) * (1 - fx) + tap(y1c, y1v, x1c, x1v) * fx
    out = top * (1 - fy) + bot * fy
    mean = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    std = torch.as_tensor(std, dtype=torch.float32, device=dev)
    out = ((out - mean) / std).to(images.dtype)
    m = masks[bi, y0c[:, :, None], x0c[:, None, :]]
    m = torch.where(y0v[:, :, None] & x0v[:, None, :], m, torch.zeros_like(m))
    return out, m


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  masks: torch.Tensor, mean, std, crop_size: int = 480,
                  min_size: int = 282, max_size: int = 678):
    """``draw_params`` on ``generator``, then ``augment_with_params``: random
    short-side scale -> random crop -> random h/v flips -> normalize."""
    b, h, w, _ = images.shape
    params = draw_params(generator, b, min(h, w), crop_size, min_size, max_size,
                         hw=(h, w))
    return augment_with_params(images, masks, params, mean, std, crop_size)
