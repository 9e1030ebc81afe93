"""Utilities: the flax weight bridge, the checkpoint converters, training
checkpoints, logging and seeds."""

from egm_unet_torch.utils.from_flax import (  # noqa: F401
    flax_from_state_dict,
    load_flax_variables,
    state_dict_from_flax,
)
