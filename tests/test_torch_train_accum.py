"""Gradient accumulation, several steps per call and rematerialisation of the
port's train step (base_c 8, 64x64, the setup of
``tests/test_torch_train.py``).

- ``make_train_step_accum(2)`` on a batch of 4 against the JAX package's
  accumulation step (per-microbatch BatchNorm statistics threaded in order,
  gradients averaged, one update), on the vanilla UNet in float64 as
  ``tests/test_torch_train_models.py`` runs it (the accumulation does not
  depend on the model; the UNet compiles in seconds): loss rtol 1e-5,
  every gradient leaf to 1e-3 * max |g_ref| + 1e-6, statistics and
  parameters rtol 1e-4 (atol 1e-4 / 1e-6); a batch that does not split
  raises ValueError.
- On egm_unet: ``make_train_multistep`` over K stacked batches equals K
  single steps.
- ``remat="stage"`` and ``"fine"`` (``torch.utils.checkpoint``) give the
  gradients, statistics and parameters of the model without remat to 1e-5,
  and update each running statistic once, not again in the recomputation.
"""

import functools

import numpy as np
import pytest
import torch

from egm_unet_tpu.engine import make_train_step_accum as j_make_train_step_accum
from egm_unet_torch.engine import (make_train_multistep, make_train_step,
                                   make_train_step_accum)
from torch_train_util import (train_test_env,  # noqa: F401 (autouse fixture)
                              assert_grads_close, assert_tree_close, batches, jax_run,
                              port_records, port_state)

NAME = "egm_unet"


@functools.lru_cache(maxsize=None)
def accum_runs():
    data = batches(n=1, batch=4, seed=2)
    v, ref, _ = jax_run("unet", j_make_train_step_accum(2), data, batch=4, x64=True)
    mine, _ = port_records(port_state("unet", v),
                           make_train_step_accum(2, input_dtype=torch.float64), data)
    return ref, mine


def test_accum_step_matches_jax():
    ref, mine = accum_runs()
    assert mine[0]["loss"] == pytest.approx(ref[0]["loss"], rel=1e-5)
    assert_grads_close(mine[0]["grads"], ref[0]["grads"])
    assert_tree_close(mine[0]["stats"], ref[0]["stats"], 1e-4, 1e-4)
    assert_tree_close(mine[0]["params"], ref[0]["params"], 1e-4, 1e-6)
    assert mine[0]["lr"] == pytest.approx(ref[0]["lr"], abs=1e-7)


def test_accum_rejects_a_batch_that_does_not_split():
    v, _ = _variables()
    state = port_state(NAME, v)
    images, targets = batches(n=1, batch=3)[0]
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step_accum(2)(state, torch.from_numpy(images), torch.from_numpy(targets))
    assert state.step == 0


@functools.lru_cache(maxsize=None)
def _variables():
    import jax.numpy as jnp

    from egm_unet_tpu.models import create_model as j_create_model
    from torch_port_util import random_variables

    v = random_variables(j_create_model(NAME, base_c=8), jnp.zeros((2, 32, 32, 3)),
                         train=True)
    return v, batches(n=3, seed=3)


@pytest.mark.parametrize("accum", [1, 2])
def test_multistep_equals_the_step_loop(accum):
    v, data = _variables()
    loop, s1 = port_records(port_state(NAME, v), make_train_step_accum(accum)
                            if accum > 1 else make_train_step(), data)
    s2 = port_state(NAME, v)
    images = torch.from_numpy(np.stack([d[0] for d in data]))
    targets = torch.from_numpy(np.stack([d[1] for d in data]))
    s2, aux = make_train_multistep(accum=accum)(s2, images, targets)
    assert s2.step == s1.step == 3
    np.testing.assert_array_equal(aux["loss"].numpy(), [r["loss"] for r in loop])
    assert aux["lr"] == [r["lr"] for r in loop]
    for (k, a), b in zip(s1.model.state_dict().items(), s2.model.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("mode", ["stage", "fine"])
def test_remat_matches_no_remat(mode):
    v, data = _variables()
    plain, _ = port_records(port_state(NAME, v), make_train_step(), data[:2])
    remat, state = port_records(port_state(NAME, v, remat=mode), make_train_step(),
                                data[:2])
    assert state.model.remat and (mode == "fine") == state.model.in_conv.fine_remat
    for a, b in zip(plain, remat):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-5)
        for key in ("grads", "stats", "params"):
            assert set(a[key]) == set(b[key])
            for path in a[key]:
                np.testing.assert_allclose(b[key][path], a[key][path], rtol=1e-5,
                                           atol=1e-5 * float(np.abs(a[key][path]).max()),
                                           err_msg=f"{key} {path}")
