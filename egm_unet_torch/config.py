"""Experiment configs for CLIPSeg training (port of
``egm_unet_tpu/config.py``): the typed ``ClipSegExperiment``, a loader of the
reference's experiments YAML (a ``configuration`` block and
``individual_configurations`` overrides, the schema of
experiments/phrasecut.yaml) and a factory of the matching
``CLIPDensePredT`` and its train state.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class ClipSegExperiment:
    name: str = "default"
    version: str = "ViT-B/16"
    batch_size: int = 64
    lr: float = 1e-3
    t_max: int = 20000
    eta_min: float = 1e-4
    max_iterations: int = 20000
    image_size: int = 352
    reduce_dim: int = 64
    extract_layers: Tuple[int, ...] = (3, 7, 9)
    prompt: str = "shuffle+"
    negative_prob: float = 0.0
    complex_trans_conv: bool = False
    with_visual: bool = False
    mix: bool = False
    mix_text_max: float = 0.0
    mask: str = "text_and_crop_blur_highlight352"
    loss: str = "binary_cross_entropy_with_logits"
    amp: bool = True
    split: str = "train"
    normalize: bool = True


_YAML_KEYS = {
    "batch_size": "batch_size", "lr": "lr", "T_max": "t_max",
    "eta_min": "eta_min", "max_iterations": "max_iterations",
    "image_size": "image_size", "reduce_dim": "reduce_dim",
    "extract_layers": "extract_layers", "prompt": "prompt",
    "negative_prob": "negative_prob",
    "complex_trans_conv": "complex_trans_conv",
    "with_visual": "with_visual", "mix": "mix", "mix_text_max": "mix_text_max",
    "mask": "mask", "amp": "amp", "split": "split", "normalize": "normalize",
    "version": "version", "name": "name",
}


def _apply(cfg: ClipSegExperiment, d: dict) -> ClipSegExperiment:
    updates = {}
    for yk, field in _YAML_KEYS.items():
        if yk in d:
            v = d[yk]
            if field == "extract_layers":
                v = tuple(v)
            updates[field] = v
    return dataclasses.replace(cfg, **updates)


def load_experiments(path: str):
    """Parse a reference-format experiments YAML -> {name: ClipSegExperiment}.

    The shared ``configuration`` block seeds every run; each entry of
    ``individual_configurations`` overrides it (the schema used by
    experiments/phrasecut.yaml, incl. the rd64-uni / rd64-uni-refined runs).
    """
    import yaml  # only this loader needs PyYAML

    with open(path) as f:
        raw = yaml.safe_load(f)
    base = _apply(ClipSegExperiment(), raw.get("configuration", {}))
    runs = {}
    for entry in raw.get("individual_configurations", []) or []:
        cfg = _apply(base, entry)
        runs[cfg.name] = cfg
    if not runs:
        runs[base.name] = base
    return runs


def build_from_experiment(cfg: ClipSegExperiment, dtype=None):
    """``ClipSegExperiment`` -> ``(CLIPDensePredT, create_state)``, where
    ``create_state(generator)`` draws the model's weights from ``generator``
    (``models.registry.init_weights``) and returns its train state
    (``engine/clipseg_train.py``).  ``dtype`` defaults to bfloat16 with
    ``amp`` and float32 without; a bfloat16 model has its matmul and conv
    weights cast (``nn.layers.cast_weights``)."""
    import torch

    from egm_unet_torch.engine.clipseg_train import create_clipseg_state
    from egm_unet_torch.models.clip.model import VIT_B16, VIT_B32
    from egm_unet_torch.models.clipseg import CLIPDensePredT
    from egm_unet_torch.models.registry import init_weights
    from egm_unet_torch.nn.layers import cast_weights

    clip_cfg = {"ViT-B/16": VIT_B16, "ViT-B/32": VIT_B32}[cfg.version]
    model = CLIPDensePredT(
        clip_cfg=clip_cfg,
        extract_layers=tuple(cfg.extract_layers),
        reduce_dim=cfg.reduce_dim,
        prompt=cfg.prompt,
        complex_trans_conv=cfg.complex_trans_conv,
    )
    dtype = dtype or (torch.bfloat16 if cfg.amp else torch.float32)

    def create_state(generator: torch.Generator):
        init_weights(model, generator)
        if dtype != torch.float32:
            cast_weights(model, dtype)
        return create_clipseg_state(model, lr=cfg.lr, t_max=cfg.t_max,
                                    eta_min=cfg.eta_min)

    return model, create_state
