"""The host side of the reference pipelines (PIL resizes, normalisation, the
64-pixel buckets, the back-resizes and the fusion), and the comparison that
decides ``correct``.

The comparison: a served mask is the argmax of two logits per pixel.  Where
it picks another class than the float32 reference, the reference's margin
there (|l1 - l0|) says how wrong it is: rounding flips only pixels whose
margin is about the rounding step.  ``mask_gap`` is the widest such margin
over the compared pixels, as a share of the reference margins' root mean
square, so that it reads alike whatever the logits' scale; 0 where every
pixel agrees.  For a bfloat16 configuration the program's error is read in
units of the reference's own error when it computes in bfloat16 on the same
inputs (``ratio``): a random network amplifies rounding by a factor that
differs from seed to seed, and the ratio takes that factor out.  Nothing
here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

TP_MEAN = np.array([0.709, 0.381, 0.224], np.float32)
TP_STD = np.array([0.127, 0.079, 0.043], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
BUCKET = 64


def pil_resize(arr: np.ndarray, hw) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(arr).resize((int(hw[1]), int(hw[0])), Image.BILINEAR))


def short_side(hw, size: int) -> tuple:
    """torchvision's ``resize(size)``: the short side to ``size``, the long
    side rounded to keep the aspect."""
    h, w = hw
    if h < w:
        return size, max(1, int(round(size * w / h)))
    return max(1, int(round(size * h / w))), size


def normalize(img_u8: np.ndarray, mean, std) -> np.ndarray:
    return (img_u8.astype(np.float32) / 255.0 - mean) / std


def bucket_hw(hw) -> tuple:
    return tuple(-(-int(s) // BUCKET) * BUCKET for s in hw)


def padded(arrs, hw) -> np.ndarray:
    """HWC float arrays zero-padded at the bottom and right into one batch."""
    out = np.zeros((len(arrs), hw[0], hw[1], arrs[0].shape[-1]), np.float32)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0], :a.shape[1]] = a
    return out


def bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """NHWC (or HWC) bilinear resize, half-pixel centres, no antialias."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if tuple(x.shape[1:3]) != tuple(hw):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    return x[0] if squeeze else x


def nearest_pil(x: torch.Tensor, hw) -> torch.Tensor:
    """HW nearest resize by PIL's index rule floor((i + 0.5) n_in / n_out)."""
    for axis, n_out in ((0, int(hw[0])), (1, int(hw[1]))):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        idx = torch.clamp(((torch.arange(n_out, dtype=torch.float64) + 0.5) * n_in
                           / n_out).floor().long(), 0, n_in - 1)
        x = x.index_select(axis, idx.to(x.device))
    return x


def logit_err(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The parts of a relative root-mean-square error of ``got`` (what the
    program's timed path computed) against ``ref``."""
    got, ref = got.double(), ref.double()
    return {"sq_err": float(((got - ref) ** 2).sum()), "sq_ref": float((ref ** 2).sum())}


def rel_rms(parts) -> float:
    """sqrt(sum of squared errors / sum of squared references) over parts."""
    ref = sum(p["sq_ref"] for p in parts)
    return float(np.sqrt(sum(p["sq_err"] for p in parts) / ref)) if ref > 0 else float("inf")


def flips(margin: torch.Tensor, fg: torch.Tensor) -> tuple:
    """(pixels whose class ``fg`` differs from the one ``margin`` picks, the
    sum of |margin| over them): a flip needs an error past its margin, so
    the sum weighs each flip by the error it took."""
    off = (margin > 0) != fg.bool()
    return int(off.sum()), float(margin.double().abs()[off].sum())


def ratio(num: float, den: float) -> float:
    """``num / den``, with a floor of one count or one ulp under ``den``."""
    return num / max(den, 1e-30) if den > 0 else (0.0 if num == 0 else num / 1e-30)


def mask_gap(margin: torch.Tensor, served_fg: torch.Tensor) -> dict:
    """``margin``: the reference's l1 - l0 per pixel (any shape);
    ``served_fg``: the served class (bool, same shape).  The reference picks
    class 1 where its margin is above 0 (argmax takes the first of a tie)."""
    margin = margin.float()
    ref_fg = margin > 0
    flips = ref_fg != served_fg.bool()
    n_flip = int(flips.sum())
    gap = float(margin.abs()[flips].max()) if n_flip else 0.0
    rms = float(torch.sqrt((margin.double() ** 2).mean()))
    near = int((margin.abs() < 0.05 * rms).sum())
    return {"gap": gap, "rms": rms, "flips": n_flip, "pixels": int(margin.numel()),
            "fg": int(ref_fg.sum()), "near": near}


def combine(parts) -> dict:
    """One ``mask_gap`` over several compared blocks: the widest gap, the
    pooled root mean square, the summed flips."""
    n = sum(p["pixels"] for p in parts)
    rms = float(np.sqrt(sum(p["rms"] ** 2 * p["pixels"] for p in parts) / max(n, 1)))
    gap = max((p["gap"] for p in parts), default=0.0)
    return {"gap": gap, "rms": rms, "flips": sum(p["flips"] for p in parts), "pixels": n,
            "mask_gap": gap / rms if rms > 0 else float("inf"),
            "flip_share": sum(p["flips"] for p in parts) / max(n, 1),
            "fg_share": sum(p["fg"] for p in parts) / max(n, 1),
            # flips / pixels is about the density of margins at 0 times the
            # mean margin error: the error in rms units, inferred from flips
            "err_est": (sum(p["flips"] for p in parts) / max(n, 1))
            / max(sum(p["near"] for p in parts) / max(n, 1) / 0.1, 1e-12)}
