"""Host-side data: the TP-Dataset loader, eval transforms and the synthetic
generator."""

from egm_unet_torch.data.dataset import DriveDataset  # noqa: F401
from egm_unet_torch.data.synthetic import (  # noqa: F401
    SyntheticTPDataset,
    synthetic_tp_sample,
)
from egm_unet_torch.data.transforms import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    TP_MEAN,
    TP_STD,
    EvalTransform,
    normalize,
    resize_short_side,
)
