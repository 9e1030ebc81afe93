"""egm_unet_torch's remainder of the JAX package's public surface against
egm_unet_tpu's on the same inputs: ``nn/extra.py`` (the reference's unwired
modules) with bridged weights, ``depthwise_conv2d``, the global pools,
``stencil2d``, the torch-default initialisers by distribution, the public
names of ``ops``, ``nn``, ``engine``, ``data`` and ``utils``, and
``engine.eval_step``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egm_unet_tpu import ops as jops
from egm_unet_tpu.engine import eval_step as j_eval_step
from egm_unet_tpu.engine.state import TrainState as JTrainState
from egm_unet_tpu.metrics import confmat_init as j_confmat_init
from egm_unet_tpu.metrics import dice_init as j_dice_init
from egm_unet_tpu.models import create_model as j_create_model
from egm_unet_tpu.nn import extra as jextra
from egm_unet_tpu.nn.layers import torch_bias_init as j_bias_init
from egm_unet_tpu.nn.layers import torch_kernel_init as j_kernel_init

from egm_unet_torch import metrics as M
from egm_unet_torch import ops
from egm_unet_torch.engine import create_train_state, eval_step, warmup_poly_schedule
from egm_unet_torch.models import create_model
from egm_unet_torch.nn import extra
from egm_unet_torch.nn.layers import torch_bias_init, torch_kernel_init
from egm_unet_torch.utils.from_flax import load_flax_variables, state_dict_from_flax

from tests.torch_port_util import random_variables, to_torch


def close(port: torch.Tensor, ref, rel: float = 1e-5) -> None:
    """Within ``rel`` of the reference's largest magnitude."""
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    diff = float(np.abs(port.detach().float().numpy() - ref).max())
    assert diff <= rel * scale, f"max |diff| {diff} > {rel} * {scale}"


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_ela_matches_jax():
    x = _x((2, 12, 20, 32))
    jm = jextra.ELA()
    v = random_variables(jm, jnp.zeros(x.shape))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = load_flax_variables(extra.ELA(32), v)
    close(port(to_torch(x)), ref)


@pytest.mark.parametrize("den, stride", [((0.5,), 1), ((0.3, 0.7), 2)])
def test_wconv2d_matches_jax(den, stride):
    x = _x((2, 11, 13, 5))
    k = 2 * len(den) + 1
    jm = jextra.WConv2d(features=6, kernel_size=k, den=den, stride=stride)
    v = random_variables(jm, jnp.zeros(x.shape))
    v["params"]["alpha"] = np.float32(1.3)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = load_flax_variables(extra.WConv2d(5, 6, k, den=den, stride=stride), v)
    close(port(to_torch(x)), ref)


@pytest.mark.parametrize("train", [False, True])
def test_hegdc_matches_jax(train):
    """Both BatchNorm modes: train mode's output and updated running
    statistics, eval mode's output on the running statistics."""
    x = _x((2, 16, 18, 8))
    jm = jextra.HEGDC(features=12, mid_features=10)
    v = random_variables(jm, jnp.zeros(x.shape), train=True)
    v["params"]["alpha"] = np.float32(1.2)
    v["params"]["den"] = np.asarray([0.4], np.float32)
    port = load_flax_variables(extra.HEGDC(8, 12, mid_features=10), v)
    if train:
        ref, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                                 mutable=["batch_stats"]))(v, jnp.asarray(x))
        out = port.train()(to_torch(x))
        want = state_dict_from_flax(port, {"params": v["params"], **upd})
        for name in ("bn1.mean", "bn1.var", "bn2.mean", "bn2.var"):
            close(port.state_dict()[name], want[name].numpy())
    else:
        ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
        out = port.eval()(to_torch(x))
    close(out, ref)


def test_edge_stencils_match_jax():
    """``scharr_conv`` and ``sobel_conv`` against JAX.  ``sobel_conv`` is the
    JAX function's sum of the Sobel x and y responses, not the reference
    module's zeros (PARITY.md)."""
    x = _x((2, 10, 12, 3))
    close(extra.scharr_conv(to_torch(x)), jextra.scharr_conv(jnp.asarray(x)))
    sob = extra.sobel_conv(to_torch(x))
    close(sob, jextra.sobel_conv(jnp.asarray(x)))
    assert float(sob.abs().max()) > 1.0


def test_soft_pooling_matches_jax():
    x = _x((2, 5, 7, 3)) * 30.0  # large activations: the softmax form holds
    out = extra.soft_pooling_2d(to_torch(x))
    assert out.shape == (2, 1, 1, 3)
    close(out, jextra.soft_pooling_2d(jnp.asarray(x)))


@pytest.mark.parametrize("stride, dilation", [(1, 1), (2, 1), (1, 2)])
def test_depthwise_conv2d_matches_jax(stride, dilation):
    x, w = _x((2, 13, 11, 6)), _x((3, 3, 1, 6), seed=1)
    ref = jops.depthwise_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                padding=1, dilation=dilation)
    close(ops.depthwise_conv2d(to_torch(x), to_torch(w), stride=stride, padding=1,
                               dilation=dilation), ref)


@pytest.mark.parametrize("name", ["global_avg_pool", "global_max_pool", "global_std_pool"])
@pytest.mark.parametrize("axes, keepdims", [((1, 2), False), ((1, 2), True), ((3,), False)])
def test_global_pools_match_jax(name, axes, keepdims):
    x = _x((2, 7, 9, 5)) + 0.5
    ref = getattr(jops, name)(jnp.asarray(x), axes=axes, keepdims=keepdims)
    got = getattr(ops, name)(to_torch(x), axes=axes, keepdims=keepdims)
    assert tuple(got.shape) == tuple(ref.shape)
    close(got, ref)


@pytest.mark.parametrize("kernel", ["LAPLACE4", "LAPLACE8", "SOBEL_X", "SOBEL_Y"])
def test_stencils_match_jax(kernel):
    np.testing.assert_array_equal(np.asarray(getattr(ops, kernel), np.float32),
                                  np.asarray(getattr(jops, kernel)))
    for shape in ((2, 9, 11), (9, 11), (2, 9, 11, 1)):
        x = _x(shape)
        close(ops.stencil2d(to_torch(x), getattr(ops, kernel)),
              jops.stencil2d(jnp.asarray(x), getattr(jops, kernel)))


@pytest.mark.parametrize("shape", [(3, 3, 64, 128), (512, 256)])
def test_torch_kernel_init_distribution(shape):
    """Uniform in +-1/sqrt(fan_in), as JAX's ``torch_kernel_init`` draws:
    the bound holds, the variance is bound^2 / 3, and both match JAX's
    draws of the same shape."""
    bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
    t = torch_kernel_init(torch.empty(shape), torch.Generator().manual_seed(0)).numpy()
    j = np.asarray(j_kernel_init(jax.random.key(0), shape, jnp.float32))
    for draw in (t, j):
        assert np.abs(draw).max() <= bound
        assert np.abs(draw).max() > 0.99 * bound
        assert abs(draw.var() / (bound ** 2 / 3) - 1) < 0.03
        assert abs(draw.mean()) < 0.01 * bound
    assert abs(t.var() / j.var() - 1) < 0.04


def test_torch_bias_init_distribution():
    shape, fan_in = (50_000,), 576
    bound = 1.0 / np.sqrt(fan_in)
    t = torch_bias_init(torch.empty(shape), torch.Generator().manual_seed(1), fan_in).numpy()
    j = np.asarray(j_bias_init(jax.random.key(1), shape, jnp.float32, fan_in))
    for draw in (t, j):
        assert np.abs(draw).max() <= bound and np.abs(draw).max() > 0.99 * bound
        assert abs(draw.var() / (bound ** 2 / 3) - 1) < 0.03
    assert np.abs(torch_bias_init(torch.empty(1000), torch.Generator()).numpy()).max() <= 1.0


PUBLIC_NAMES = {
    "egm_unet_torch.ops": ["depthwise_conv2d", "global_avg_pool", "global_max_pool",
                           "global_std_pool", "stencil2d", "SOBEL_X", "SOBEL_Y",
                           "LAPLACE4", "LAPLACE8"],
    "egm_unet_torch.nn": ["torch_kernel_init", "torch_bias_init"],
    "egm_unet_torch.engine": ["eval_step"],
    "egm_unet_torch.data": ["FewShotSegDataset"],
    "egm_unet_torch.utils": ["CheckpointManager", "MetricLogger", "ResultsWriter"],
}


@pytest.mark.parametrize("module, name", [(m, n) for m, names in PUBLIC_NAMES.items()
                                          for n in names])
def test_public_names(module, name):
    """The JAX package's public names that the port's packages lacked."""
    assert getattr(importlib.import_module(module), name) is not None
    jmod = importlib.import_module(module.replace("egm_unet_torch", "egm_unet_tpu"))
    assert hasattr(jmod, name)


def test_eval_step_matches_jax():
    """One small batch through ``engine.eval_step`` (the training graph in
    eval mode): the same confusion matrix as the JAX package's jitted
    ``eval_step``, and the same dice."""
    jm = j_create_model("egm_unet", base_c=8)
    v = random_variables(jm, jnp.zeros((2, 32, 32, 3)), train=True, seed=4)
    rng = np.random.default_rng(6)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    targets = rng.integers(0, 2, (2, 32, 32)).astype(np.int32)
    targets[rng.random(targets.shape) < 0.05] = 255
    jstate = JTrainState.create(apply_fn=jm.apply, params=v["params"],
                                batch_stats=v["batch_stats"], tx=optax.sgd(0.1))
    cm, dice = j_eval_step(jstate, jnp.asarray(images), jnp.asarray(targets),
                           j_confmat_init(2), j_dice_init())
    model = load_flax_variables(create_model("egm_unet", base_c=8, fold_bn=False), v)
    state = create_train_state(model, warmup_poly_schedule(0.01, 1, 1))
    pcm, pdice = eval_step(state, torch.from_numpy(images), torch.from_numpy(targets),
                           M.confmat_init(2), M.dice_init())
    np.testing.assert_array_equal(pcm.numpy(), np.asarray(cm))
    assert int(pcm.sum()) > 0 and not model.training
    assert float(pdice.value) == pytest.approx(float(dice.value), abs=1e-6)
