"""Utilities: the flax weight bridge and the checkpoint converters."""

from egm_unet_torch.utils.from_flax import (  # noqa: F401
    load_flax_variables,
    state_dict_from_flax,
)
