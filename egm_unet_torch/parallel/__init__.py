"""Data, spatial and tensor parallelism across processes and GPUs on
``torch.distributed`` (the ``data``, ``spatial`` and ``model`` axes of
``egm_unet_tpu/parallel``): ``mesh`` (groups, grids, batch sharding),
``halo`` (the collectives of row-split maps), ``tp`` (Megatron-split CLIP
towers)."""

from egm_unet_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    Grid,
    Spatial,
    all_gather,
    all_reduce_grads,
    at_height,
    check_spatial_height,
    data_group,
    global_height,
    launch,
    make_grid,
    model_group,
    rank_rows,
    replicated,
    row_range,
    shard_batch,
    shard_batch_spatial,
    shard_superbatch,
    shard_superbatch_spatial,
    spatial,
    use_data_group,
    use_model_group,
    use_spatial,
    use_spatial_group,
)
from egm_unet_torch.parallel.halo import (  # noqa: F401
    fetch_rows,
    halo,
    spatial_max,
    spatial_sum,
)
from egm_unet_torch.parallel.tp import (  # noqa: F401
    clip_param_specs,
    copy_to_model,
    gather_clip_state,
    reduce_from_model,
    shard_clip,
)
