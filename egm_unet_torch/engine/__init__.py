"""Engines: training (schedule, state, train and eval steps) and the
logit-fusion ensemble."""

from egm_unet_torch.engine.fusion import (  # noqa: F401
    fuse_logits,
    fused_confmats,
    load_alpha,
    save_alpha,
    search_best_alpha,
)
from egm_unet_torch.engine.schedule import warmup_poly_schedule  # noqa: F401
from egm_unet_torch.engine.state import (  # noqa: F401
    TrainState,
    create_train_state,
    sgd_torch,
)
from egm_unet_torch.engine.train import (  # noqa: F401
    eval_step,
    make_eval_step,
    make_train_multistep,
    make_train_step,
    make_train_step_accum,
    reduce_eval,
)
