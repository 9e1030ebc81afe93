"""Tensor ops, NHWC activations and HWIO kernels as in the JAX package."""

from egm_unet_torch.ops.attention import multi_head_attention  # noqa: F401
from egm_unet_torch.ops.conv import (  # noqa: F401
    conv2d,
    conv_transpose2d_nonoverlap,
    depthwise_conv2d,
)
from egm_unet_torch.ops.fft import fft_magnitude_enhance  # noqa: F401
from egm_unet_torch.ops.pooling import (  # noqa: F401
    avg_pool2d,
    global_avg_pool,
    global_max_pool,
    global_std_pool,
    max_pool2d,
    min_pool2d,
)
from egm_unet_torch.ops.resize import (  # noqa: F401
    resize_bicubic,
    resize_bilinear,
    resize_nearest,
    upsample2x_bilinear_align_corners,
)
from egm_unet_torch.ops.shuffle import channel_shuffle  # noqa: F401
from egm_unet_torch.ops.stencil import (  # noqa: F401
    LAPLACE4,
    LAPLACE8,
    SOBEL_X,
    SOBEL_Y,
    stencil2d,
)
