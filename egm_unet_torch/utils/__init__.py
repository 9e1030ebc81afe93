"""Utilities: the flax weight bridge."""

from egm_unet_torch.utils.from_flax import (  # noqa: F401
    load_flax_variables,
    state_dict_from_flax,
)
