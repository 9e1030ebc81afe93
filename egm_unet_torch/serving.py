"""Batched inference (port of ``egm_unet_tpu/serving.py``).

Requests are resized (short side ``base_size``) and normalized on the host,
grouped into shape buckets (multiples of 64 pixels), packed into
fixed-size batches whose free slots hold zero images, run through the
BN-folded model, and their argmax masks resized back to each image's
original size.  In ``bfloat16`` the weights are cast to bfloat16, as the JAX
package's deployment cast does.

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
from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from egm_unet_torch.data.transforms import normalize, resize_short_side
from egm_unet_torch.device import resolve_device
from egm_unet_torch.models.registry import create_model
from egm_unet_torch.ops.quant import (QUANT_MODES, SHIP_QSTORE_SITES, Quantizer,
                                      calibrate_quant_scales)
from egm_unet_torch.ops.resize import resize_bilinear
from egm_unet_torch.utils.checkpoint import folded_state_dict
from egm_unet_torch.utils.from_flax import load_flax_variables

PAD_MULTIPLE = 64  # bucket granularity, as the JAX Predictor's default


def bucket_of(hw) -> tuple:
    """The (H, W) bucket of a preprocessed image: each side rounded up to a
    multiple of PAD_MULTIPLE."""
    m = PAD_MULTIPLE
    return -(-hw[0] // m) * m, -(-hw[1] // m) * m


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
        """A predictor on the weights in ``path``: a directory written by the
        port's trainer (``cli/train.py``, ``utils/checkpoint.py``), whose best
        epoch (else its latest) is folded into the inference graph; or a file
        holding the ``state_dict`` of ``create_model(config.model_name,
        ...)`` as ``torch.save`` wrote it (what ``cli/eval_clipseg.py
        --unet-weights`` loads too; the names are the same on every kernel
        route).  The JAX package's orbax directories are not read (orbax
        needs JAX)."""
        pred = cls(config=config, device=device)
        if os.path.isdir(path):
            state = folded_state_dict(path, config.model_name, config.num_classes,
                                      config.base_c)
        else:
            state = torch.load(path, map_location="cpu", weights_only=True)
        pred.model.load_state_dict(state)
        return pred

    def _preprocess(self, image: np.ndarray) -> np.ndarray:
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
        prepped = [self._preprocess(img) for img in images]
        buckets = {}
        for i, p in enumerate(prepped):
            buckets.setdefault(bucket_of(p.shape), []).append(i)

        results: List[Optional[np.ndarray]] = [None] * len(images)
        bs = self.cfg.batch_size
        for (bh, bw), idxs in buckets.items():
            for start in range(0, len(idxs), bs):
                chunk = idxs[start:start + bs]
                # always a full fixed-size batch: free slots are zero images
                batch = np.zeros((bs, bh, bw, 3), np.float32)
                for row, i in enumerate(chunk):
                    p = prepped[i]
                    batch[row, :p.shape[0], :p.shape[1]] = p
                x = torch.from_numpy(batch).to(self.device, self.dtype)
                preds = self.forward(x)
                for row, i in enumerate(chunk):
                    p = prepped[i]
                    h, w = images[i].shape[:2]
                    mask = preds[row, :p.shape[0], :p.shape[1]].float()
                    full = resize_bilinear(mask[..., None], (h, w))
                    results[i] = np.rint(full[..., 0].cpu().numpy()).astype(np.uint8)
        return results  # type: ignore[return-value]
