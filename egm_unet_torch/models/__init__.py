"""The UNet family (BN-folded inference graphs and BatchNorm training
graphs), CLIP and CLIPSeg."""

from egm_unet_torch.models.egm_unet import DoubleConv1, EGMUNet  # noqa: F401
from egm_unet_torch.models.unet import UNet, Up  # noqa: F401
from egm_unet_torch.models.registry import (  # noqa: F401
    MODEL_CONFIGS,
    create_model,
    init_reference,
    init_weights,
)
