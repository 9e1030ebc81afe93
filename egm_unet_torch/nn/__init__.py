"""Building blocks of the UNet family, folded for inference or with
BatchNorm for training (NHWC), and of the transformer models."""

from egm_unet_torch.nn.attention import (  # noqa: F401
    ChannelAttention,
    MCAGate,
    MCALayer,
    RecursiveGatedAttention,
    SpatialAttention,
)
from egm_unet_torch.nn.grfb import GRFB, EdgeEnhancedGRFB, FusionConv  # noqa: F401
from egm_unet_torch.nn.layers import (  # noqa: F401
    BasicConv,
    BatchNorm,
    Conv,
    ConvBNReLU,
    CoreConv,
    Dense,
    DoubleConv,
    EdgeAwareFeatureEnhancer,
    LayerNorm,
    cast_weights,
    pad_to_match,
    remat,
    torch_bias_init,
    torch_kernel_init,
)
