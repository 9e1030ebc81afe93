"""The data-parallel train step (``engine/train.py`` with a group) on 2 gloo
ranks on the CPU, against the JAX package's step under a 2-device mesh
(``jax.jit(make_train_step(...))`` on ``shard_batch``ed inputs under
``jax.set_mesh``, as ``__graft_entry__.dryrun_multichip`` runs it) and
against the port's one-process step on the whole batch.

Cases, from ``torch_port_util.random_variables`` at base_c 8, lr 5e-4 (see
``tests/test_torch_train.py``), two steps each: egm_unet in float32 at batch
4 on 64x64; ``make_train_step_accum(2)`` at batch 8 (each rank's rows laid
out by microbatch); the vanilla unet in float64; egm_unet with stage remat
(the recomputed forwards all-reduce again); and ``make_train_multistep``
over both steps in one call.  One spawn of 2 ranks runs them all (about 20
s), in a thread of the test process while the JAX steps compile there.

Bounds (``dryrun_multichip``'s): the loss of every step within 1e-5
relative, the parameters and BatchNorm statistics after the second step
within 1e-4 (max abs difference)."""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.engine import make_train_step as j_make_train_step
from egm_unet_tpu.engine import make_train_step_accum as j_make_train_step_accum
from egm_unet_tpu.models import create_model as j_create_model
from egm_unet_tpu.parallel import get_mesh
from egm_unet_tpu.parallel import shard_batch as j_shard_batch
from egm_unet_torch.engine import make_train_step, make_train_step_accum
from egm_unet_torch.parallel import launch
from egm_unet_torch.utils import flax_from_state_dict

from tests.torch_dist_util import train_cases
from tests.torch_port_util import random_variables
from tests.torch_train_util import (train_test_env,  # noqa: F401 (autouse fixture)
                                    BASE_C, batches, flat, jax_state, port_records,
                                    port_state)

STEPS = 2
# name -> (model, global batch, accum, x64, remat, multistep)
CASES = {"egm_unet": ("egm_unet", 4, 1, False, False, False),
         "accum2": ("egm_unet", 8, 2, False, False, False),
         "unet_f64": ("unet", 4, 1, True, False, False),
         "remat": ("egm_unet", 4, 1, False, "stage", False),
         "multistep": ("egm_unet", 4, 1, False, False, True)}


@functools.lru_cache(maxsize=None)
def variables(name):
    return random_variables(j_create_model(name, base_c=BASE_C),
                            jnp.zeros((2, 32, 32, 3)), train=True)


def data(case):
    _, batch, *_ = CASES[case]
    return batches(n=STEPS, seed=7, batch=batch)


@functools.lru_cache(maxsize=None)
def jax_mesh_run(name, batch, accum, x64):
    """Losses and the flat params / stats after each step of the JAX step
    jitted under a 2-device mesh."""
    mesh = get_mesh(n_data=2, devices=jax.devices()[:2])
    dtype = jnp.float64 if x64 else jnp.float32
    step_fn = j_make_train_step_accum(accum) if accum > 1 else j_make_train_step()
    records = []
    with jax.enable_x64(x64):
        state = jax_state(name, variables(name), dtype)
        step = jax.jit(step_fn)
        with jax.set_mesh(mesh):
            for images, targets in batches(n=STEPS, seed=7, batch=batch):
                x, t = j_shard_batch(mesh, jnp.asarray(images, dtype), jnp.asarray(targets))
                state, aux = step(state, x, t)
                records.append({"loss": float(aux["loss"]), "params": flat(state.params),
                                "stats": flat(state.batch_stats)})
    return records


def port_one_process(case):
    name, batch, accum, x64, _, _ = CASES[case]
    dtype = torch.float64 if x64 else torch.float32
    step = (make_train_step_accum(accum, input_dtype=dtype) if accum > 1
            else make_train_step(input_dtype=dtype))
    records, _ = port_records(port_state(name, variables(name)), step, data(case))
    return records


def dp_launch():
    cases = []
    for case, (name, batch, accum, x64, remat, multistep) in CASES.items():
        cases.append({"name": name, "state_dict": port_state(name, variables(name))
                      .model.state_dict(), "data": data(case), "accum": accum,
                      "dtype": torch.float64 if x64 else torch.float32,
                      "remat": remat, "multistep": multistep})
    ranks = launch(train_cases, 2, "gloo", cases)  # per rank, per case
    return {case: [r[i] for r in ranks] for i, case in enumerate(CASES)}


@functools.lru_cache(maxsize=None)
def dp_future():
    """The ranks' run, started once, in a thread: it waits on processes."""
    return ThreadPoolExecutor(1).submit(dp_launch)


def dp_runs():
    return dp_future().result()


def dp_trees(case):
    """Rank 0's and rank 1's (losses, flat params, flat stats)."""
    name = CASES[case][0]
    model = port_state(name, variables(name)).model
    out = []
    for rank in dp_runs()[case]:
        sd = {k: torch.from_numpy(v) for k, v in rank["state"].items()}
        tree = flax_from_state_dict(model, sd)
        out.append((rank["losses"], flat(tree["params"]), flat(tree["batch_stats"])))
    return out


def assert_trees(port, ref, what):
    assert set(port) == set(ref)
    worst = max(float(np.abs(port[k] - ref[k]).max()) for k in ref)
    assert worst < 1e-4, f"{what}: max |diff| {worst}"


@pytest.mark.parametrize("case", ["egm_unet", "accum2", "unet_f64"])
def test_dp_step_matches_jax_under_a_two_device_mesh(case):
    name, batch, accum, x64, _, _ = CASES[case]
    dp_future()  # the ranks run while JAX compiles
    ref = jax_mesh_run(name, batch, accum, x64)
    for losses, params, stats in dp_trees(case):
        for k in range(STEPS):
            assert losses[k] == pytest.approx(ref[k]["loss"], rel=1e-5)
        assert_trees(params, ref[-1]["params"], f"{case} params")
        assert_trees(stats, ref[-1]["stats"], f"{case} stats")


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_the_one_process_step(case):
    ref = port_one_process(case)
    for losses, params, stats in dp_trees(case):
        for k in range(STEPS):
            assert losses[k] == pytest.approx(ref[k]["loss"], rel=1e-5)
        assert_trees(params, ref[-1]["params"], f"{case} params")
        assert_trees(stats, ref[-1]["stats"], f"{case} stats")


def test_ranks_stay_identical():
    """Both ranks make the same update from the same reduced gradients."""
    for case in CASES:
        (l0, p0, s0), (l1, p1, s1) = dp_trees(case)
        assert l0 == l1
        for k in p0:
            np.testing.assert_array_equal(p0[k], p1[k], err_msg=f"{case} {k}")
        for k in s0:
            np.testing.assert_array_equal(s0[k], s1[k], err_msg=f"{case} {k}")


def test_collectives_per_step():
    """Per step: two all-reduces per BatchNorm (forward sums, backward
    sums), one for the loss, one for the gradients; a remat stage adds one
    more per BatchNorm it recomputes."""
    model = port_state("egm_unet", variables("egm_unet")).model
    n_bn = sum(1 for m in model.modules() if type(m).__name__ == "BatchNorm")
    runs = dp_runs()
    assert runs["egm_unet"][0]["collectives"] == STEPS * (2 * n_bn + 2)
    assert runs["multistep"][0]["collectives"] == STEPS * (2 * n_bn + 2)
    assert runs["accum2"][0]["collectives"] == STEPS * (2 * (2 * n_bn + 1) + 1)
    assert runs["remat"][0]["collectives"] > STEPS * (2 * n_bn + 2)
