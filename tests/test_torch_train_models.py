"""``engine.make_train_step`` on the vanilla UNet and the GRFB-UNet baseline
(base_c 8, batch 2, 64x64) against the JAX package's step on the CPU: the
first step's loss, every gradient leaf and the new batch statistics, and
every parameter after three steps.  Setup and tolerances as
``tests/test_torch_train.py`` (no warm-up, base rate 5e-4).

Both sides compute these two models in float64 on float32 parameters
(``input_dtype=torch.float64``; flax ``dtype=float64`` under
``jax.enable_x64``); the losses stay float32 on both.  In float32 the two
libraries' forwards part by about 2e-5 of the logits after ten BatchNorms
of fast variance, and at that distance a max-pool or ReLU boundary moves:
a 1e-5 relative change of the input moves the port's own float32 gradients
of the vanilla UNet 96 times past the tolerance (1e-6: 0.03 times)."""

import functools

import pytest
import torch

from egm_unet_tpu.engine import make_train_step as j_make_train_step
from egm_unet_torch.engine import make_train_step
from torch_train_util import (train_test_env,  # noqa: F401 (autouse fixture)
                              STEPS, assert_grads_close, assert_tree_close, batches,
                              jax_run, port_records, port_state)

MODELS = ["unet", "grfb_unet"]


@functools.lru_cache(maxsize=None)
def runs(name):
    v, ref, _ = jax_run(name, j_make_train_step(), batches(), x64=True)
    mine, _ = port_records(port_state(name, v),
                           make_train_step(input_dtype=torch.float64), batches())
    return ref, mine


@pytest.mark.parametrize("name", MODELS)
def test_first_step_loss_gradients_and_stats(name):
    ref, mine = runs(name)
    assert mine[0]["loss"] == pytest.approx(ref[0]["loss"], rel=1e-5)
    assert_grads_close(mine[0]["grads"], ref[0]["grads"])
    assert_tree_close(mine[0]["stats"], ref[0]["stats"], 1e-4, 1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_three_steps_params(name):
    ref, mine = runs(name)
    for k in range(STEPS):
        assert mine[k]["loss"] == pytest.approx(ref[k]["loss"], rel=1e-5)
        assert mine[k]["lr"] == pytest.approx(ref[k]["lr"], abs=1e-7)
    assert_tree_close(mine[-1]["params"], ref[-1]["params"], 1e-4, 1e-6)
    assert_tree_close(mine[-1]["stats"], ref[-1]["stats"], 1e-4, 1e-4)
