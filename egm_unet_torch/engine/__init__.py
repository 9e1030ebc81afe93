"""Engines: the logit-fusion ensemble."""

from egm_unet_torch.engine.fusion import (  # noqa: F401
    fuse_logits,
    fused_confmats,
    load_alpha,
    save_alpha,
    search_best_alpha,
)
