"""egm_unet_torch modules against the BN-folded flax modules of
egm_unet_tpu, on the CPU in float32.  Weights are seeded numpy arrays with
randomized BN statistics; the JAX side folds them with its
``fold_bn_variables``, the port's weight bridge folds them with its own.

Tolerance 1e-4: the same float32 arithmetic, summed in other orders by
XLA's and PyTorch's CPU convolutions, through up to a dozen layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.models.egm_unet import DoubleConv1 as JDoubleConv1
from egm_unet_tpu.models.fold_bn import fold_bn_variables as jfold
from egm_unet_tpu.models.unet import Up as JUp
from egm_unet_tpu.nn import attention as jatt
from egm_unet_tpu.nn import grfb as jgrfb
from egm_unet_tpu.nn.layers import EdgeAwareFeatureEnhancer as JEAFE

from egm_unet_torch.models.egm_unet import DoubleConv1
from egm_unet_torch.models.unet import Up
from egm_unet_torch.nn.attention import MCALayer, RecursiveGatedAttention
from egm_unet_torch.nn.grfb import EdgeEnhancedGRFB, FusionConv
from egm_unet_torch.nn.layers import EdgeAwareFeatureEnhancer
from egm_unet_torch.utils import load_flax_variables

from tests.torch_port_util import assert_close, random_variables, to_torch

torch.set_grad_enabled(False)
TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _folded_ref(unfolded, folded, *inputs, **kw):
    """Random weights for ``unfolded``; ``folded`` applied to them after the
    JAX fold.  Returns (numpy variables, reference output)."""
    v = random_variables(unfolded, *map(jnp.asarray, inputs), train=True)
    out = jax.jit(lambda fv, *a: folded.apply(fv, *a, **kw))(
        jfold(v), *map(jnp.asarray, inputs))
    return v, np.asarray(out)


def _ref(module, *inputs):
    v = random_variables(module, *map(jnp.asarray, inputs))
    return v, np.asarray(jax.jit(module.apply)(v, *map(jnp.asarray, inputs)))


def test_mca_layer():
    x = np.abs(_x((2, 12, 10, 32)))  # post-ReLU activations
    v, ref = _ref(jatt.MCALayer(), x)
    port = load_flax_variables(MCALayer(32), v)
    assert_close(port(to_torch(x)), ref, **TOL)


def test_recursive_gated_attention():
    x = _x((2, 8, 8, 32), seed=1)
    v, ref = _ref(jatt.RecursiveGatedAttention(dim=32), x)
    port = load_flax_variables(RecursiveGatedAttention(32), v)
    assert_close(port(to_torch(x)), ref, **TOL)


def test_edge_aware_feature_enhancer():
    x = _x((2, 14, 14, 8), seed=2)
    v, ref = _folded_ref(JEAFE(), JEAFE(fold_bn=True), x)
    port = load_flax_variables(EdgeAwareFeatureEnhancer(8), v)
    assert_close(port(to_torch(x)), ref, **TOL)


def test_fusion_conv():
    x = _x((2, 9, 9, 20), seed=3)
    m = jgrfb.FusionConv(16)
    v = random_variables(m, jnp.asarray(x), jnp.asarray(x))
    ref = np.asarray(jax.jit(lambda v, a: m.apply(v, a, a))(v, jnp.asarray(x)))
    port = load_flax_variables(FusionConv(20, 16), v)
    assert_close(port(to_torch(x)), ref, **TOL)


def test_edge_enhanced_grfb():
    x = np.abs(_x((1, 16, 16, 32), seed=4))
    v, ref = _folded_ref(jgrfb.EdgeEnhancedGRFB(32, visual=2),
                         jgrfb.EdgeEnhancedGRFB(32, visual=2, fold_bn=True), x)
    port = load_flax_variables(EdgeEnhancedGRFB(32, 32, visual=2), v)
    assert_close(port(to_torch(x)), ref, **TOL)


@pytest.mark.parametrize("block,use_mca", [("edge", True), (None, True), ("edge", False)])
def test_double_conv1(block, use_mca):
    x = _x((1, 16, 16, 8), seed=5)
    kw = dict(block=block, use_mca=use_mca)
    v, ref = _folded_ref(JDoubleConv1(16, **kw), JDoubleConv1(16, fold_bn=True, **kw), x)
    port = load_flax_variables(DoubleConv1(8, 16, **kw), v)
    assert_close(port(to_torch(x)), ref, **TOL)


@pytest.mark.parametrize("x1_hw,x2_hw", [((4, 6), (8, 12)),  # exact 2x: up_concat_conv
                                         ((4, 5), (9, 11))])  # upsample + pad route
def test_up(x1_hw, x2_hw):
    x1 = _x((2, *x1_hw, 16), seed=6)
    x2 = _x((2, *x2_hw, 16), seed=7)
    v, ref = _folded_ref(JUp(8), JUp(8, fold_bn=True), x1, x2)
    port = load_flax_variables(Up(16, 16, 8), v)
    assert_close(port(to_torch(x1), to_torch(x2)), ref, **TOL)
