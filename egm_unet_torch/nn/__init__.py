"""Building blocks of the folded EGM-UNet, NHWC."""

from egm_unet_torch.nn.attention import (  # noqa: F401
    ChannelAttention,
    MCAGate,
    MCALayer,
    RecursiveGatedAttention,
    SpatialAttention,
)
from egm_unet_torch.nn.grfb import EdgeEnhancedGRFB, FusionConv  # noqa: F401
from egm_unet_torch.nn.layers import (  # noqa: F401
    BasicConv,
    Conv,
    ConvBNReLU,
    DoubleConv,
    EdgeAwareFeatureEnhancer,
    pad_to_match,
)
