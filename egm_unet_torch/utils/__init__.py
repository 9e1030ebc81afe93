"""Utilities: the flax weight bridge, the checkpoint converters, training
checkpoints, logging, seeds, color maps and profiling."""

from egm_unet_torch.utils.checkpoint import CheckpointManager  # noqa: F401
from egm_unet_torch.utils.from_flax import (  # noqa: F401
    flax_from_state_dict,
    load_flax_variables,
    state_dict_from_flax,
)
from egm_unet_torch.utils.logging import MetricLogger, ResultsWriter  # noqa: F401
