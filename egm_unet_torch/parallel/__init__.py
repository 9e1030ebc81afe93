"""Data parallelism across processes and GPUs on ``torch.distributed`` (the
data axis of ``egm_unet_tpu/parallel``)."""

from egm_unet_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    all_gather,
    all_reduce_grads,
    data_group,
    launch,
    rank_rows,
    replicated,
    shard_batch,
    shard_superbatch,
    use_data_group,
)
