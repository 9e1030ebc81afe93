"""Vanilla CLIP + CSA: the standard 77-token text encoding and the CSA image
path on vanilla CLIP weights (port of ``egm_unet_tpu/models/clip/csa_api.py``).
The same ``CLIP`` class with another config."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from egm_unet_torch.models.clip.model import CLIP, VIT_B16, CLIPConfig
from egm_unet_torch.models.clip.tokenizer import SimpleTokenizer
from egm_unet_torch.models.clip.tokenizer import tokenize as _tokenize

VANILLA_CSA_B16 = dataclasses.replace(VIT_B16, context_length=77, long_clip=False)
VANILLA_CSA_B32 = dataclasses.replace(VANILLA_CSA_B16, vision_patch_size=32)


def tokenize77(texts: Union[str, List[str]], truncate: bool = False,
               tokenizer: Optional[SimpleTokenizer] = None) -> np.ndarray:
    """Standard 77-token CLIP tokenization."""
    return _tokenize(texts, context_length=77, truncate=truncate,
                     tokenizer=tokenizer)


def build_vanilla_csa(checkpoint_path: Optional[str] = None,
                      generator: Optional[torch.Generator] = None,
                      cfg: CLIPConfig = VANILLA_CSA_B16) -> CLIP:
    """The vanilla 77-context CSA model: loaded from an OpenAI-format
    checkpoint when given (without the Long-CLIP positional stretch; the
    config then comes from the checkpoint's shapes), else ``cfg`` with random
    weights drawn from ``generator`` (zeros without one)."""
    if checkpoint_path:
        from egm_unet_torch.utils.convert import load_clip_checkpoint

        cfg_kw, state = load_clip_checkpoint(checkpoint_path, stretch_to_long=False)
        model = CLIP(CLIPConfig(**cfg_kw))
        model.load_state_dict(state)
        return model
    model = CLIP(cfg)
    if generator is not None:
        from egm_unet_torch.models.registry import init_weights

        init_weights(model, generator)
    return model
