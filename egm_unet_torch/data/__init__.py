"""Host-side data: the TP-Dataset loader, train and eval transforms, the
synthetic generators and the batch loader."""

from egm_unet_torch.data.dataset import DriveDataset, collate_pad  # noqa: F401
from egm_unet_torch.data.fewshot import FewShotSegDataset  # noqa: F401
from egm_unet_torch.data.synthetic import (  # noqa: F401
    SyntheticTPDataset,
    synthetic_tp_batch,
    synthetic_tp_sample,
    synthetic_tp_sample_hard,
)
from egm_unet_torch.data.transforms import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    TP_MEAN,
    TP_STD,
    EvalTransform,
    TrainTransform,
    normalize,
    resize_short_side,
)
