"""``engine.make_train_step`` and ``make_eval_step`` on egm_unet (A+B+C),
base_c 8, batch 2, 64x64, against the JAX package's steps on the CPU from
the same variables (``torch_port_util.random_variables``, BatchNorm
statistics randomized) and the same seeded batches.

The JAX state's optimiser is the package's ``sgd_torch`` behind a pass-
through transformation that keeps the last gradients in its state, so one
compiled JAX step gives the loss, every gradient leaf, the new batch
statistics and the new parameters.  The schedule has no warm-up
(``warmup=False``): the first warm-up rate, 0.02 * 1e-3, would barely move
the parameters.  Its base rate is 5e-4, not the recipe's 0.02: from these
random weights a step at 0.02 changes the early kernels by about their own
size, and three such steps are chaotic, so that a 1e-7 relative change of
the input moves the port's own parameters 300 times past the tolerance
after the second step.  At 5e-4 the same change stays under 0.04 of it
while the parameters move up to 1000 times it.  At 32x32 (a 2x2
bottleneck, BatchNorm over 8 values) the gradients themselves are that
sensitive.  Tolerances (float32): loss rtol 1e-5; gradients max |diff|
<= 1e-3 * max |g_ref| + 1e-6 per leaf; batch statistics rtol/atol 1e-4;
parameters after three steps rtol 1e-4 / atol 1e-6; the eval step's
confusion matrix exactly, its dice to 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu import metrics as JM
from egm_unet_tpu.engine import make_eval_step as j_make_eval_step
from egm_unet_tpu.engine import make_train_step as j_make_train_step
from egm_unet_torch import metrics as M
from egm_unet_torch.engine import make_eval_step, make_train_step
from torch_train_util import (train_test_env,  # noqa: F401 (autouse fixture)
                              STEPS, assert_grads_close, assert_tree_close, batches,
                              jax_run, port_records, port_state)

NAME = "egm_unet"


@functools.lru_cache(maxsize=None)
def reference():
    return jax_run(NAME, j_make_train_step(), batches())


@functools.lru_cache(maxsize=None)
def port_run():
    v, _, _ = reference()
    return port_records(port_state(NAME, v), make_train_step(), batches())


def test_first_step_loss():
    _, ref, _ = reference()
    mine, _ = port_run()
    assert mine[0]["loss"] == pytest.approx(ref[0]["loss"], rel=1e-5)


def test_first_step_gradients_every_leaf():
    _, ref, _ = reference()
    mine, _ = port_run()
    assert len(ref[0]["grads"]) > 150  # the whole A+B+C tree
    assert_grads_close(mine[0]["grads"], ref[0]["grads"])


def test_first_step_batch_stats():
    _, ref, _ = reference()
    mine, _ = port_run()
    assert_tree_close(mine[0]["stats"], ref[0]["stats"], 1e-4, 1e-4)


def test_three_steps_params_losses_and_lr():
    _, ref, _ = reference()
    mine, state = port_run()
    for k in range(STEPS):
        assert mine[k]["loss"] == pytest.approx(ref[k]["loss"], rel=1e-5)
        # aux["lr"] is schedule(step) after the increment, as in JAX
        assert mine[k]["lr"] == pytest.approx(ref[k]["lr"], abs=1e-7)
        assert mine[k]["step"] == ref[k]["step"] == k + 1
    assert_tree_close(mine[-1]["params"], ref[-1]["params"], 1e-4, 1e-6)
    assert_tree_close(mine[-1]["stats"], ref[-1]["stats"], 1e-4, 1e-4)
    # the optimiser's rate for the next update is schedule(3)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(ref[-1]["lr"], abs=1e-7)


def test_eval_step_confmat_and_dice():
    """The unfolded graph in eval mode (running statistics) after three
    steps: the same confusion matrix and dice as the JAX eval step."""
    _, _, jstate = reference()
    _, state = port_run()
    images, targets = batches(n=1, seed=5)[0]
    cm, dice = jax.jit(j_make_eval_step())(jstate, jnp.asarray(images), jnp.asarray(targets),
                                           JM.confmat_init(2), JM.dice_init())
    pcm, pdice = make_eval_step()(state, torch.from_numpy(images),
                                  torch.from_numpy(targets), M.confmat_init(2),
                                  M.dice_init())
    assert not state.model.training
    np.testing.assert_array_equal(pcm.numpy(), np.asarray(cm))
    assert int(pdice.count) == int(dice.count) == 1
    assert float(pdice.value) == pytest.approx(float(dice.value), abs=1e-6)
