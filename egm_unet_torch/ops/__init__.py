"""Tensor ops, NHWC activations and HWIO kernels as in the JAX package."""

from egm_unet_torch.ops.attention import multi_head_attention  # noqa: F401
from egm_unet_torch.ops.conv import conv2d, conv_transpose2d_nonoverlap  # noqa: F401
from egm_unet_torch.ops.fft import fft_magnitude_enhance  # noqa: F401
from egm_unet_torch.ops.pooling import avg_pool2d, max_pool2d, min_pool2d  # noqa: F401
from egm_unet_torch.ops.resize import (  # noqa: F401
    resize_bicubic,
    resize_bilinear,
    resize_nearest,
    upsample2x_bilinear_align_corners,
)
from egm_unet_torch.ops.shuffle import channel_shuffle  # noqa: F401
