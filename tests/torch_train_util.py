"""Shared helpers of the training-slice parity tests: seeded batches, the JAX
train step run under ``jax.jit`` with an optimiser that keeps the last
gradients, the port's state on the same variables, and the per-leaf
comparisons."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egm_unet_tpu.engine import warmup_poly_schedule as j_schedule
from egm_unet_tpu.engine.state import TrainState as JTrainState
from egm_unet_tpu.engine.state import sgd_torch as j_sgd_torch
from egm_unet_tpu.models import create_model as j_create_model
from egm_unet_torch.engine import create_train_state, warmup_poly_schedule
from egm_unet_torch.models import create_model
from egm_unet_torch.utils import flax_from_state_dict, load_flax_variables
from egm_unet_torch.utils.from_flax import flax_path
from torch_port_util import random_variables

@contextlib.contextmanager
def one_thread():
    """Autograd on (other test modules switch it off for their whole
    process) and one intra-op thread: the suite runs several workers on the
    machine's cores, and oversubscribed threads slow every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.enable_grad():
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def train_test_env():
    """``one_thread`` around every test of a module that imports it."""
    with one_thread():
        yield


BASE_C, BATCH, SIZE, STEPS = 8, 2, 64, 3
# no warm-up, and a base rate of 5e-4: see tests/test_torch_train.py
SCHED = dict(base_lr=5e-4, num_step=5, epochs=3, warmup=False)


def batches(n=STEPS, seed=0, batch=BATCH, size=None):
    size = size or SIZE
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
        targets = rng.integers(0, 2, (batch, size, size)).astype(np.int32)
        targets[rng.random((batch, size, size)) < 0.05] = 255
        out.append((images, targets))
    return out


def recording(inner):
    """``inner`` with the gradients it was last given kept in its state."""
    def init(params):
        return {"grads": jax.tree_util.tree_map(jnp.zeros_like, params),
                "inner": inner.init(params)}

    def update(grads, state, params=None):
        updates, inner_state = inner.update(grads, state["inner"], params)
        return updates, {"grads": grads, "inner": inner_state}

    return optax.GradientTransformation(init, update)


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def jax_state(name, variables, dtype=jnp.float32):
    sched = j_schedule(**SCHED)
    stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                   variables["batch_stats"])
    return JTrainState.create(
        apply_fn=j_create_model(name, base_c=BASE_C, dtype=dtype).apply,
        params=variables["params"], batch_stats=stats,
        tx=recording(j_sgd_torch(sched)), lr_fn=sched)


def jax_run(name, step_fn, data, batch=BATCH, x64=False):
    """(variables, per-step records, final state) of ``step_fn`` jitted, from
    seeded variables: loss, lr, gradients, batch statistics, parameters.
    ``x64``: the model computes in float64 on its float32 parameters (the
    losses stay float32, as they cast the logits)."""
    jm = j_create_model(name, base_c=BASE_C)
    v = random_variables(jm, jnp.zeros((batch, 32, 32, 3)), train=True)
    dtype = jnp.float64 if x64 else jnp.float32
    records = []
    with jax.enable_x64(x64):
        state = jax_state(name, v, dtype)
        step = jax.jit(step_fn)
        for images, targets in data:
            state, aux = step(state, jnp.asarray(images, dtype), jnp.asarray(targets))
            records.append({"loss": float(aux["loss"]), "lr": float(aux["lr"]),
                            "grads": flat(state.opt_state["grads"]),
                            "stats": flat(state.batch_stats),
                            "params": flat(state.params), "step": int(state.step)})
    return v, records, state


def port_state(name, variables, **kw):
    model = load_flax_variables(create_model(name, base_c=BASE_C, fold_bn=False, **kw),
                                variables)
    return create_train_state(model, warmup_poly_schedule(**SCHED))


def port_grads(model):
    return {flax_path(model, k): p.grad.numpy().copy() for k, p in model.named_parameters()}


def assert_grads_close(grads, ref):
    assert set(grads) == set(ref)
    for path, g in grads.items():
        tol = 1e-3 * float(np.abs(ref[path]).max()) + 1e-6
        diff = float(np.abs(g - ref[path]).max())
        assert diff <= tol, f"{path}: max |diff| {diff} > {tol}"


def assert_tree_close(port, ref, rtol, atol):
    assert set(port) == set(ref)
    for path in ref:
        np.testing.assert_allclose(port[path], ref[path], rtol=rtol, atol=atol,
                                   err_msg=path)




def port_records(state, step, data):
    """Run the port's ``step`` over ``data``; per step the loss, lr,
    gradients, statistics, parameters and step count (copies)."""
    import torch

    records = []
    for images, targets in data:
        state, aux = step(state, torch.from_numpy(images), torch.from_numpy(targets))
        tree = flax_from_state_dict(state.model)
        records.append({"loss": aux["loss"].item(), "lr": aux["lr"],
                        "grads": port_grads(state.model),
                        "stats": flat(tree["batch_stats"]),
                        "params": flat(tree["params"]), "step": state.step})
    return records, state
