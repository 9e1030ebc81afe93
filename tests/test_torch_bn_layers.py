"""The training graph's layers (fold_bn=False) against the JAX package's
BatchNorm layers on the CPU: train-mode outputs and the new running
statistics, eval-mode outputs, and the gradients of a fixed scalar,
``mean(y * probe)`` with a seeded normal probe, with respect to the inputs
and every parameter.

Weights: ``torch_port_util.random_variables`` (BatchNorm statistics and
affine parameters randomized), bridged with ``utils/from_flax.py``.  One
jitted JAX function per layer computes everything the tests compare.
Tolerances (float32): outputs and statistics rtol/atol 1e-4; gradients
max |diff| <= 1e-3 * max |g_ref| + 1e-6 per leaf.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.nn import attention as jatt
from egm_unet_tpu.nn import grfb as jgrfb
from egm_unet_tpu.nn import layers as jl
from egm_unet_torch.nn import attention as patt
from egm_unet_torch.nn import grfb as pgrfb
from egm_unet_torch.nn import layers as pl
from egm_unet_torch.utils import flax_from_state_dict, load_flax_variables
from egm_unet_torch.utils.from_flax import flax_path
from torch_port_util import random_variables
from torch_train_util import train_test_env  # noqa: F401 (autouse fixture)


def _act(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pos(rng, shape):
    # strictly positive and tie-free: MCA's 3x3 max / min pools route their
    # gradient to one element of a tie, which need not be the same one
    return (np.abs(rng.standard_normal(shape)) + 0.1).astype(np.float32)


# name -> (flax module, port module, input makers, takes `train`, up_pair)
CASES = {
    "basic_conv_dilated": (
        lambda: jl.BasicConv(8, 3, padding=2, dilation=2),
        lambda: pl.BasicConv(6, 8, 3, padding=2, dilation=2, fold_bn=False),
        [(2, 16, 16, 6)], True, False),
    "basic_conv_grouped_linear": (
        lambda: jl.BasicConv(8, 3, padding=1, groups=2, relu=False),
        lambda: pl.BasicConv(4, 8, 3, padding=1, groups=2, relu=False, fold_bn=False),
        [(2, 12, 12, 4)], True, False),
    "conv_bn_relu": (
        lambda: jl.ConvBNReLU(8),
        lambda: pl.ConvBNReLU(4, 8, fold_bn=False),
        [(2, 16, 16, 4)], True, False),
    "conv_bn_relu_up_pair": (
        lambda: jl.ConvBNReLU(8),
        lambda: pl.ConvBNReLU(10, 8, fold_bn=False),
        [(2, 16, 16, 4), (2, 8, 8, 6)], True, True),
    "double_conv": (
        lambda: jl.DoubleConv(8, mid_features=6),
        lambda: pl.DoubleConv(4, 8, mid_features=6, fold_bn=False),
        [(2, 16, 16, 4)], True, False),
    "edge_aware_enhancer": (
        lambda: jl.EdgeAwareFeatureEnhancer(),
        lambda: pl.EdgeAwareFeatureEnhancer(8, fold_bn=False),
        [(2, 12, 12, 8)], True, False),
    "edge_enhanced_grfb": (
        lambda: jgrfb.EdgeEnhancedGRFB(16),
        lambda: pgrfb.EdgeEnhancedGRFB(16, 16, fold_bn=False),
        [(2, 24, 24, 16)], True, False),
    "grfb": (
        lambda: jgrfb.GRFB(16),
        lambda: pgrfb.GRFB(16, 16, fold_bn=False),
        [(2, 20, 20, 16)], True, False),
    "mca_layer": (
        lambda: jatt.MCALayer(),
        lambda: patt.MCALayer(8, fused=False),
        [(2, 12, 14, 8)], False, False),
    "recursive_gated_attention": (
        lambda: jatt.RecursiveGatedAttention(dim=16),
        lambda: patt.RecursiveGatedAttention(16),
        [(2, 6, 8, 16)], False, False),
}


def _inputs(name):
    _, _, shapes, _, _ = CASES[name]
    rng = np.random.default_rng(7)
    make = _pos if name == "mca_layer" else _act
    return [make(rng, s) for s in shapes]


def _jax_apply(module, variables, inputs, train, takes_train, up_pair):
    kw = {"train": train} if takes_train else {}
    if up_pair:
        args = (None,)
        kw["up_pair"] = (inputs[0], inputs[1])
    else:
        args = tuple(inputs)
    if train and takes_train:
        return module.apply(variables, *args, mutable=["batch_stats"], **kw)
    return module.apply(variables, *args, **kw), {}


def _port_apply(module, inputs, up_pair):
    if up_pair:
        return module(up_pair=(inputs[0], inputs[1]))
    return module(*inputs)


@functools.lru_cache(maxsize=None)
def reference(name):
    """(variables, inputs, probe, JAX results) of case ``name``."""
    jmod_fn, _, _, takes_train, up_pair = CASES[name]
    jm = jmod_fn()
    inputs = _inputs(name)
    call_args = (None,) if up_pair else tuple(jnp.asarray(a) for a in inputs)
    kw = {"train": True} if takes_train else {}
    if up_pair:
        kw["up_pair"] = tuple(jnp.asarray(a) for a in inputs)
    v = random_variables(jm, *call_args, **kw)
    rest = {k: val for k, val in v.items() if k != "params"}

    def run(params, ins, probe):
        def scalar(params, ins):
            y, upd = _jax_apply(jm, {"params": params, **rest}, ins, True,
                                takes_train, up_pair)
            return jnp.mean(y * probe), (y, upd)

        (_, (y, upd)), (gp, gx) = jax.value_and_grad(
            scalar, argnums=(0, 1), has_aux=True)(params, ins)
        y_eval, _ = _jax_apply(jm, {"params": params, **rest}, ins, False,
                               takes_train, up_pair)
        return y, upd, gp, gx, y_eval

    ins = [jnp.asarray(a) for a in inputs]
    y_shape = jax.eval_shape(lambda: _jax_apply(jm, v, ins, True, takes_train,
                                                 up_pair)[0]).shape
    probe = np.random.default_rng(11).standard_normal(y_shape).astype(np.float32)
    out = jax.jit(run)(v["params"], ins, jnp.asarray(probe))
    return v, inputs, probe, jax.tree_util.tree_map(np.asarray, out)


def _port(name, v):
    return load_flax_variables(CASES[name][1](), v)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_mode_outputs_and_running_stats(name):
    v, inputs, _, (y, upd, _, _, _) = reference(name)
    port = _port(name, v).train()
    out = _port_apply(port, [torch.from_numpy(a) for a in inputs], CASES[name][4])
    np.testing.assert_allclose(out.detach().numpy(), y, rtol=1e-4, atol=1e-4)
    stats = _flat(flax_from_state_dict(port)["batch_stats"])
    ref = _flat(upd.get("batch_stats", {}))
    assert set(stats) == set(ref)
    assert bool(ref) == CASES[name][3]  # every layer with `train` holds a BN
    for path in ref:
        np.testing.assert_allclose(stats[path], ref[path], rtol=1e-4, atol=1e-4,
                                   err_msg=path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_mode_outputs(name):
    v, inputs, _, (_, _, _, _, y_eval) = reference(name)
    port = _port(name, v).eval()
    out = _port_apply(port, [torch.from_numpy(a) for a in inputs], CASES[name][4])
    np.testing.assert_allclose(out.detach().numpy(), y_eval, rtol=1e-4, atol=1e-4)
    if CASES[name][3]:  # eval mode leaves the running statistics alone
        stats = _flat(flax_from_state_dict(port)["batch_stats"])
        for path, ref in _flat(v["batch_stats"]).items():
            np.testing.assert_array_equal(stats[path], ref, err_msg=path)


def _grad_close(port, ref, what):
    ref = np.asarray(ref)
    tol = 1e-3 * float(np.abs(ref).max()) + 1e-6
    diff = float(np.abs(port - ref).max())
    assert diff <= tol, f"{what}: max |diff| {diff} > {tol}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_of_a_fixed_scalar(name):
    v, inputs, probe, (_, _, gp, gx, _) = reference(name)
    port = _port(name, v).train()
    xs = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out = _port_apply(port, xs, CASES[name][4])
    (out * torch.from_numpy(probe)).mean().backward()
    for i, x in enumerate(xs):
        _grad_close(x.grad.numpy(), gx[i], f"input {i}")
    ref = _flat(gp)
    grads = {flax_path(port, k): p.grad.numpy() for k, p in port.named_parameters()}
    assert set(grads) == set(ref)
    for path, g in grads.items():
        _grad_close(g, ref[path], path)


def test_batchnorm_stats_are_flax_fast_variance_and_momentum():
    """The update by hand: biased E[x^2] - E[x]^2 in float32, clipped at 0,
    ra = m ra + (1 - m) batch with m = 1 - torch momentum; not the unbiased
    variance F.batch_norm would store."""
    bn = pl.BatchNorm(3, torch_momentum=0.01).train()
    x = torch.from_numpy(_act(np.random.default_rng(3), (2, 5, 4, 3)))
    y = bn(x)
    xf = x.reshape(-1, 3).double()
    mean = xf.mean(0)
    var = (xf * xf).mean(0) - mean * mean
    np.testing.assert_allclose(bn.mean.numpy(), 0.01 * mean.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.var.numpy(), 0.99 + 0.01 * var.numpy(), rtol=1e-5)
    np.testing.assert_allclose(y.detach().double().numpy(),
                               ((xf - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape),
                               rtol=1e-4, atol=1e-5)
    bn.frozen = 1  # a recomputed checkpoint forward: statistics untouched
    before = bn.mean.clone()
    bn(x * 2)
    assert torch.equal(bn.mean, before)
