"""The full egm_unet_torch EGMUNet against the BN-folded JAX forward, and the
weight bridge over every ported configuration, on the CPU in float32.

Logit tolerance rtol/atol 1e-3, the bar tests/test_parity_modules.py sets
for the torch oracle of the same model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.models import create_model as jcreate
from egm_unet_tpu.models.fold_bn import fold_bn_variables as jfold

from egm_unet_torch.models import MODEL_CONFIGS, create_model
from egm_unet_torch.utils import load_flax_variables, state_dict_from_flax

from tests.torch_port_util import assert_close, random_variables, to_torch

torch.set_grad_enabled(False)


@pytest.mark.parametrize("name", ["egm_unet", "egm_unet_ab", "grfb_unet", "unet"])
def test_full_model_logits(name):
    x = np.random.default_rng(0).standard_normal((2, 64, 48, 3)).astype(np.float32)
    v = random_variables(jcreate(name, base_c=8), jnp.asarray(x), train=True)
    folded = jcreate(name, base_c=8, fold_bn=True)
    ref = np.asarray(jax.jit(folded.apply)(jfold(v), jnp.asarray(x))["out"])
    port = load_flax_variables(create_model(name, base_c=8), v)
    out = port(to_torch(x))["out"]
    assert out.dtype == torch.float32 and out.shape == (2, 64, 48, 2)
    assert_close(out, ref, 1e-3, 1e-3)


@pytest.mark.parametrize("hw", [(64, 48), (36, 52)])  # exact 2x stages, and padded ones
def test_unet_transposed_conv_decoder(hw):
    """``bilinear=False``: the Up stage is the stride-2 transposed conv
    (``up_kernel``), padded to the skip where the sizes are odd."""
    x = np.random.default_rng(1).standard_normal((1, *hw, 3)).astype(np.float32)
    v = random_variables(jcreate("unet", base_c=8, bilinear=False), jnp.asarray(x),
                         train=True, seed=4)
    folded = jcreate("unet", base_c=8, bilinear=False, fold_bn=True)
    ref = np.asarray(jax.jit(folded.apply)(jfold(v), jnp.asarray(x))["out"])
    port = load_flax_variables(create_model("unet", base_c=8, bilinear=False), v)
    assert port.up1.up_kernel.shape == (128, 2, 2, 64)
    assert_close(port(to_torch(x))["out"], ref, 1e-3, 1e-3)
    with pytest.raises(ValueError, match="bilinear"):
        create_model("egm_unet", bilinear=False)


def _shape_tree(name):
    x = jnp.zeros((1, 32, 32, 3))
    return random_variables(jcreate(name, base_c=8), x, train=True)


@pytest.mark.parametrize("name", sorted([*MODEL_CONFIGS, "unet"]))
def test_bridge_consumes_every_leaf(name):
    v = _shape_tree(name)
    model = create_model(name, base_c=8)
    state = state_dict_from_flax(model, v)  # raises on any unused leaf
    assert set(state) == set(model.state_dict())
    # the folded tree (no batch_stats) maps the same way
    folded = {"params": jax.tree_util.tree_map(np.asarray, jfold(v)["params"])}
    state_f = state_dict_from_flax(model, folded)
    for k in state:
        torch.testing.assert_close(state_f[k], state[k], rtol=1e-6, atol=1e-6)


def test_bridge_rejects_missing_and_unused_leaves():
    v = _shape_tree("egm_unet_b")
    model = create_model("egm_unet_b", base_c=8)
    params = dict(v["params"])
    params["extra"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        state_dict_from_flax(model, {"params": params, "batch_stats": v["batch_stats"]})
    params = dict(v["params"])
    del params["out_conv"]
    with pytest.raises(KeyError, match="out_conv"):
        state_dict_from_flax(model, {"params": params, "batch_stats": v["batch_stats"]})


def test_unported_configs_raise():
    """Every configuration of the JAX registry is ported now; only an unknown
    name raises."""
    from egm_unet_tpu.models.registry import MODEL_CONFIGS as JCONFIGS

    assert set(MODEL_CONFIGS) == set(JCONFIGS)
    for name in ("unet", "grfb_unet"):
        model = create_model(name, base_c=8, generator=torch.Generator().manual_seed(0))
        assert model(torch.zeros(1, 32, 32, 3))["out"].shape == (1, 32, 32, 2)
    with pytest.raises(ValueError, match="unknown model"):
        create_model("no_such_model")
