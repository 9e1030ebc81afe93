"""egm_unet_torch's VITDensePredT against egm_unet_tpu's: a narrow plain ViT
(width 64, 2 layers, 2 heads, resolution 64) with seeded weights bridged
from the flax tree; inputs at the backbone's resolution and resized to it,
with and without ``return_features``; and the frozen backbone.  float32
logits within 1e-5 absolute: their largest magnitude is about 0.3, the
backbone's activations agree to 1.5e-6 of theirs, and the post-norm decoder
at width 16 carries that to about 1.4e-5 of the logits' largest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.models.vitseg import VITDensePredT as JVITDensePredT

from egm_unet_torch.models.vitseg import VITDensePredT
from egm_unet_torch.utils.from_flax import load_flax_variables

from tests.torch_port_util import random_variables, to_torch

KW = dict(extract_layers=(0, 1), reduce_dim=16, n_heads=4, cond_dim=8,
          vit_width=64, vit_layers=2, vit_heads=2, resolution=64)


@pytest.fixture(scope="module")
def models():
    jm = JVITDensePredT(**KW)
    v = random_variables(jm, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 8)), seed=2)
    return jm, v, load_flax_variables(VITDensePredT(**KW), v)


@pytest.mark.parametrize("size", [64, 48])
@pytest.mark.parametrize("return_features", [False, True])
def test_vitseg_matches_jax(models, size, return_features):
    jm, v, port = models
    rng = np.random.default_rng(size)
    img = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 8)).astype(np.float32)
    (ref,) = jax.jit(lambda v, i, c: jm.apply(v, i, c, return_features=return_features))(
        v, jnp.asarray(img), jnp.asarray(cond))
    with torch.no_grad():
        out = port(to_torch(img), to_torch(cond), return_features=return_features)
    assert len(out) == 1
    (logits,) = out
    assert logits.shape == (2, 64, 64, 1) and logits.dtype == torch.float32
    ref = np.asarray(ref)
    assert 0.1 < float(np.abs(ref).max()) < 1.0
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=1e-5)


def test_vitseg_backbone_frozen(models):
    _, _, port = models
    with torch.enable_grad():
        img = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
        (logits,) = port(img, torch.randn(1, 8, generator=torch.Generator().manual_seed(1)))
        logits.square().sum().backward()
    assert all(p.grad is None for p in port.vit.parameters())
    assert port.trans_conv_kernel.grad is not None and port.reduce0.kernel.grad is not None
    port.zero_grad(set_to_none=True)
