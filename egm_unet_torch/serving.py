"""Batched inference (port of ``egm_unet_tpu/serving.py``), and the UNet
inference path that the CLIs share.

Requests are resized (short side ``base_size``) and normalized on the host,
grouped into shape buckets (multiples of 64 pixels), packed into
fixed-size batches whose free slots hold zero images (``bucket_batches``),
run through the BN-folded model, and their argmax masks resized back to each
image's original size (``restore_mask``).  In ``bfloat16`` the weights are
cast to bfloat16, as the JAX package's deployment cast does.  ``unet_state``
reads the weights that ``Predictor.from_checkpoint``, ``cli/predict.py`` and
the fusion CLIs load.

``quant`` (``"int8df"``, ``"int8"``, ``"int8full"``; ``ops/quant.py``):
the scales are calibrated on the first bucket batch the predictor runs,
then the mode is held around every forward.  The storage sites default to
``SHIP_QSTORE_SITES`` (``qstore_sites``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from egm_unet_torch.data.transforms import normalize, resize_short_side
from egm_unet_torch.device import resolve_device
from egm_unet_torch.models.registry import create_model
from egm_unet_torch.ops.quant import (QUANT_MODES, SHIP_QSTORE_SITES, Quantizer,
                                      calibrate_quant_scales)
from egm_unet_torch.ops.resize import resize_bilinear
from egm_unet_torch.utils.checkpoint import folded_state_dict, saved_epochs
from egm_unet_torch.utils.from_flax import load_flax_variables

PAD_MULTIPLE = 64  # bucket granularity, as the JAX Predictor's default


def bucket_of(hw) -> tuple:
    """The (H, W) bucket of a preprocessed image: each side rounded up to a
    multiple of PAD_MULTIPLE."""
    m = PAD_MULTIPLE
    return -(-hw[0] // m) * m, -(-hw[1] // m) * m


def bucket_batches(images: Sequence[np.ndarray], batch_size: int,
                   pack: Callable[[], Any] = contextlib.nullcontext
                   ) -> Iterator[Tuple[List[int], np.ndarray]]:
    """Preprocessed HWC images grouped by bucket (in first-seen order), in
    fixed batches of ``batch_size``: yields ``(idxs, batch)``, image
    ``idxs[r]`` at the top left of row r of the zero batch [batch_size,
    bucket H, bucket W, 3] in the images' dtype (float32 normalised images,
    or the raw uint8 ones that ``zero_padding`` completes on the device).
    ``pack()`` is entered around the grouping and around each fill (a
    profiling span, say)."""
    buckets = {}
    with pack():
        for i, im in enumerate(images):
            buckets.setdefault(bucket_of(im.shape), []).append(i)
    for (bh, bw), idxs in buckets.items():
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start:start + batch_size]
            with pack():
                batch = np.zeros((batch_size, bh, bw, 3), images[chunk[0]].dtype)
                for row, i in enumerate(chunk):
                    im = images[i]
                    batch[row, :im.shape[0], :im.shape[1]] = im
            yield chunk, batch


def zero_padding(batch: torch.Tensor, hws: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """A ``bucket_batches`` batch normalised on the device, with every pixel
    of row r outside its image's ``hws[r]`` and every row past ``len(hws)``
    set to 0 in place, as the float32 batch holds them there."""
    for row, (h, w) in enumerate(hws):
        batch[row, h:] = 0
        batch[row, :h, w:] = 0
    batch[len(hws):] = 0
    return batch


def restore_mask(pred: torch.Tensor, hw, size_hw) -> np.ndarray:
    """A bucket row's argmax mask cropped to the preprocessed image's ``hw``,
    bilinearly resized to the original ``size_hw`` and rounded: uint8."""
    mask = pred[:hw[0], :hw[1]].float()
    full = resize_bilinear(mask[..., None], size_hw)
    return np.rint(full[..., 0].cpu().numpy()).astype(np.uint8)


def unet_state(path: str, model_name: str, num_classes: int,
               base_c: int) -> Optional[dict]:
    """The ``state_dict`` of the BN-folded ``create_model(model_name, ...)``
    that ``path`` holds: a directory written by the port's trainer
    (``cli/train.py``, ``utils/checkpoint.py``), whose best epoch (else its
    latest) is folded; or a file holding the ``state_dict`` as
    ``torch.save`` wrote it (the names are the same on every kernel route).
    None when ``path`` is neither.  The JAX package's orbax directories are
    not read (orbax needs JAX)."""
    if saved_epochs(path):
        return folded_state_dict(path, model_name, num_classes, base_c)
    if os.path.isfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    return None


@dataclasses.dataclass
class PredictorConfig:
    model_name: str = "egm_unet"
    base_c: int = 32
    num_classes: int = 2
    batch_size: int = 128
    base_size: int = 565  # short-side resize, like the reference eval
    dtype: str = "bfloat16"
    # kernel routes of the DoubleConvs (models.registry.create_model):
    # "gemm" | "pair", and "matmul" | "fused"
    conv_impl: str = "gemm"
    upsample_impl: str = "matmul"
    # None | "int8" | "int8df" | "int8full" (serving-only, off-parity)
    quant: Optional[str] = None
    # active int8 storage sites (ops/quant.py); None: SHIP_QSTORE_SITES
    qstore_sites: Optional[str] = None


class Predictor:
    """``variables``: a flax variables tree (``{"params"[, "batch_stats"]}``,
    bridged by ``utils/from_flax.py``), or None for random weights drawn from
    ``generator`` (default seed 0).  Images are normalized with the TP-Dataset
    statistics."""

    def __init__(self, variables: Optional[Mapping[str, Any]] = None,
                 config: PredictorConfig = PredictorConfig(), *, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        if config.quant not in (None,) + QUANT_MODES:
            raise ValueError(f"unknown quant {config.quant!r}; choose from "
                             f"{list(QUANT_MODES)}")
        self.cfg = config
        self.quantizer: Optional[Quantizer] = None
        self.calibration_s: Optional[float] = None
        self.dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
        kw = dict(num_classes=config.num_classes, base_c=config.base_c,
                  conv_impl=config.conv_impl, upsample_impl=config.upsample_impl)
        if variables is None:
            model = create_model(config.model_name, **kw,
                                 generator=generator or torch.Generator().manual_seed(0))
        else:
            model = load_flax_variables(create_model(config.model_name, **kw),
                                        variables)
        self.model = model.to(self.device, self.dtype).eval()

    @classmethod
    def from_checkpoint(cls, path: str, config: PredictorConfig = PredictorConfig(),
                        *, device=None) -> "Predictor":
        """A predictor on the weights in ``path`` (``unet_state``); raises
        when ``path`` holds none."""
        state = unet_state(path, config.model_name, config.num_classes, config.base_c)
        if state is None:
            raise FileNotFoundError(f"no trainer checkpoint or state_dict file at {path}")
        pred = cls(config=config, device=device)
        pred.model.load_state_dict(state)
        return pred

    def preprocess(self, image: np.ndarray) -> np.ndarray:
        resized, _ = resize_short_side(image, None, self.cfg.base_size)
        return normalize(resized)

    def calibrate(self, batch: torch.Tensor) -> None:
        """int8 scales from ``batch`` (``ops/quant.py::calibrate_quant_scales``);
        ``forward`` calls it on its first batch when ``quant`` is set."""
        t0 = time.perf_counter()
        scales = calibrate_quant_scales(self.model, [batch])
        sites = self.cfg.qstore_sites or SHIP_QSTORE_SITES
        self.quantizer = Quantizer(self.model, self.cfg.quant, scales, sites)
        self.calibration_s = time.perf_counter() - t0

    @torch.inference_mode()
    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """NHWC batch (working dtype, on the device) -> argmax masks."""
        if self.cfg.quant and self.quantizer is None:
            self.calibrate(batch)
        with (self.quantizer.active() if self.quantizer else contextlib.nullcontext()):
            return self.model(batch)["out"].argmax(dim=-1)

    @torch.inference_mode()
    def predict(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """uint8 HWC images (any sizes) -> per-image uint8 mask at the
        original resolution."""
        prepped = [self.preprocess(img) for img in images]
        results: List[Optional[np.ndarray]] = [None] * len(images)
        for idxs, batch in bucket_batches(prepped, self.cfg.batch_size):
            preds = self.forward(torch.from_numpy(batch).to(self.device, self.dtype))
            for row, i in enumerate(idxs):
                results[i] = restore_mask(preds[row], prepped[i].shape, images[i].shape[:2])
        return results  # type: ignore[return-value]
