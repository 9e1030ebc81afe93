"""Visual-prompt composites: blend an image with a segmentation mask (port of
``egm_unet_tpu/data/blend.py``; ref: datasets/utils.py:6-68
blend_image_segmentation).

The blur/crop modes in the reference delegate to a missing upstream
``evaluation_utils.img_preprocess``; here they are implemented natively:
``blur*`` = background gaussian-ish box blur + foreground highlight with
background factor ``bg_fac``; ``crop`` = tight crop around the mask with
``center_context`` margin, resized to ``image_size``.

Layout: NHWC-style (H, W, C) numpy images in [0, 1]; seg is (H, W) {0,1}.
"""

from __future__ import annotations

import numpy as np
import torch

from egm_unet_torch.ops.resize import resize_bilinear


def _box_blur(img: np.ndarray, radius: int) -> np.ndarray:
    if radius <= 0:
        return img
    k = 2 * radius + 1
    pad = np.pad(img, ((radius, radius), (radius, radius), (0, 0)), mode="edge")
    # separable box filter via cumulative sums
    cs = np.cumsum(pad, axis=0)
    cs = np.concatenate([cs[k - 1 : k], cs[k:] - cs[:-k]], axis=0)
    cs2 = np.cumsum(cs, axis=1)
    out = np.concatenate([cs2[:, k - 1 : k], cs2[:, k:] - cs2[:, :-k]], axis=1)
    return out / (k * k)


def _crop_around_mask(img, seg, center_context: float, image_size: int):
    ys, xs = np.where(seg > 0)
    if len(ys) == 0:
        y0, y1, x0, x1 = 0, seg.shape[0], 0, seg.shape[1]
    else:
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        my = int(center_context * (y1 - y0))
        mx = int(center_context * (x1 - x0))
        y0, y1 = max(y0 - my, 0), min(y1 + my, seg.shape[0])
        x0, x1 = max(x0 - mx, 0), min(x1 + mx, seg.shape[1])
    crop = np.ascontiguousarray(img[y0:y1, x0:x1])
    return resize_bilinear(torch.from_numpy(crop), (image_size, image_size)).numpy()


def blend_image_segmentation(img: np.ndarray, seg: np.ndarray, mode: str,
                             image_size: int = 224, rng=None):
    img = np.asarray(img, np.float32)
    seg = np.asarray(seg, np.float32)
    seg3 = seg[..., None]

    if mode == "overlay":
        return [img * seg3]
    if mode == "highlight":
        return [img * seg3 * 0.85 + 0.15 * img]
    if mode == "highlight2":
        half = img / 2
        return [(half + 0.1) * seg3 + 0.3 * half]
    if mode in {"blur_highlight", "blur3_highlight", "blur3_highlight01",
                "blur_highlight_random"}:
        if mode == "blur_highlight":
            blur, bg_fac = 1, 0.5
        elif mode == "blur3_highlight":
            blur, bg_fac = 3, 0.5
        elif mode == "blur3_highlight01":
            blur, bg_fac = 3, 0.1
        else:
            rng = rng or np.random.default_rng()
            blur = int(rng.integers(0, 3))
            bg_fac = 0.1 + 0.8 * float(rng.random())
        blurred = _box_blur(img, blur)
        out = img * seg3 + blurred * (1 - seg3) * bg_fac
        return [out - 0.01]
    if mode == "crop":
        return [_crop_around_mask(img, seg, 0.1, image_size)]
    if mode in {"crop_blur_highlight", "crop_blur_highlight352"}:
        size = 352 if mode.endswith("352") else image_size
        blurred = _box_blur(img, 3)
        hl = img * seg3 + blurred * (1 - seg3) * 0.1
        return [_crop_around_mask(hl, seg, 0.1, size)]
    if mode == "shape":
        return [np.repeat(seg3, 3, axis=-1)]
    if mode == "concat":
        return [np.concatenate([img, seg3], axis=-1)]
    if mode == "image_only" or mode is None:
        return [img]
    if mode == "image_black":
        return [img * 0]
    if mode == "separate":
        return [img, seg.astype(np.int64)]
    if mode == "separate_img_black":
        return [img * 0, seg.astype(np.int64)]
    if mode == "separate_seg_ones":
        return [img, np.ones_like(seg, np.int64)]
    if mode == "separate_both_black":
        return [img * 0, seg.astype(np.int64) * 0]
    raise ValueError(f"invalid mode: {mode}")
