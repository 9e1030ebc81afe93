"""Host-side data: eval transforms and the synthetic generator."""

from egm_unet_torch.data.synthetic import synthetic_tp_sample  # noqa: F401
from egm_unet_torch.data.transforms import (  # noqa: F401
    TP_MEAN,
    TP_STD,
    normalize,
    resize_short_side,
)
