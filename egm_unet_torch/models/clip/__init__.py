"""CLIP stack: BPE tokenizer, Long-CLIP text encoder, CSA ViT."""

from egm_unet_torch.models.clip.model import (  # noqa: F401
    CLIP,
    KEEP_LEN,
    VIT_B16,
    VIT_B32,
    CLIPConfig,
    get_attn,
    stretch_positional_embedding,
)
from egm_unet_torch.models.clip.tokenizer import SimpleTokenizer, tokenize  # noqa: F401
