"""egm_unet_torch CLIPSeg (every variant) against egm_unet_tpu on the CPU in
float32, on the TINY config of ``tests/test_clipseg.py``; weights from seeded
numpy through the flax bridge.

Tolerance 1e-3 on logits: a ViT tower plus decoder blocks of float32 matmuls
summed in another order than XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.models import clipseg as jclipseg
from egm_unet_tpu.models.clip import model as jmodel

from egm_unet_torch.models import clipseg
from egm_unet_torch.models.clip.model import CLIPConfig
from egm_unet_torch.nn.layers import cast_weights
from egm_unet_torch.utils import load_flax_variables, state_dict_from_flax

from tests.torch_port_util import assert_close, random_variables, to_torch

KW = dict(embed_dim=32, image_resolution=32, vision_layers=3, vision_width=64,
          vision_patch_size=16, context_length=24, vocab_size=512,
          transformer_width=64, transformer_heads=2, transformer_layers=3,
          long_clip=True)
TINY, JTINY = CLIPConfig(**KW), jmodel.CLIPConfig(**KW)
TOL = dict(rtol=1e-3, atol=1e-3)
# (extract layers never include 0 here: the decoder always extracts block 0
# for itself, and a flax tree holds no parameters for a duplicate of it)


def _data(seed=0, size=32, batch=2):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    cond = rng.standard_normal((batch, KW["embed_dim"])).astype(np.float32)
    tok = np.zeros((batch, KW["context_length"]), np.int32)
    tok[:, :4] = rng.integers(1, 500, (batch, 4))
    tok[:, 4] = 511
    return img, cond, tok


def _pair(jcls, pcls, img, cond, seed=3, **kw):
    jm = jcls(clip_cfg=JTINY, **kw)
    # token init materializes the text tower too
    v = random_variables(jm, jnp.asarray(img), jnp.zeros((img.shape[0], 24), jnp.int32),
                         seed=seed)
    port = load_flax_variables(pcls(clip_cfg=TINY, **kw), v).eval()
    return jm, v, port


VARIANTS = {
    "default": dict(extract_layers=(1, 2), reduce_dim=16),
    "one_layer": dict(extract_layers=(2,), reduce_dim=16),
    "complex_trans_conv": dict(extract_layers=(1, 2), reduce_dim=16,
                               complex_trans_conv=True),
    "extra_blocks": dict(extract_layers=(1, 2), reduce_dim=16, extra_blocks=2),
    "rev_activations": dict(extract_layers=(1, 2), reduce_dim=16,
                            rev_activations=True, cond_layer=1),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_clipseg_logits(variant):
    img, cond, _ = _data(seed=1)
    jm, v, port = _pair(jclipseg.CLIPDensePredT, clipseg.CLIPDensePredT, img, cond,
                        **VARIANTS[variant])
    (ref,) = jax.jit(jm.apply)(v, jnp.asarray(img), jnp.asarray(cond))
    with torch.no_grad():
        (out,) = port(to_torch(img), to_torch(cond))
    assert out.shape == (2, 32, 32, 1) and out.dtype == torch.float32
    assert_close(out, ref, **TOL)


def test_clipseg_tokens_features_and_early_stop():
    img, cond, tok = _data(seed=2, size=64)
    jm, v, port = _pair(jclipseg.CLIPDensePredT, clipseg.CLIPDensePredT, img, cond,
                        extract_layers=(1,), reduce_dim=16)
    ref = jax.jit(lambda vv, x, t: jm.apply(vv, x, t, return_features=True))(
        v, jnp.asarray(img), jnp.asarray(tok))
    with torch.no_grad():
        out = port(to_torch(img), torch.from_numpy(tok), return_features=True)
        (short,) = port(to_torch(img), torch.from_numpy(tok))
    assert out[0].shape == (2, 64, 64, 1)
    assert_close(out[0], ref[0], **TOL)  # logits
    assert_close(out[1], ref[1], **TOL)  # visual_q
    assert_close(out[2], ref[2], **TOL)  # text conditional
    assert len(out[3]) == len(ref[3]) == 2
    for a, r in zip(out[3], ref[3]):
        assert_close(a, r, **TOL)
    # without return_features the tower stops after block 1 of 3; same logits
    torch.testing.assert_close(short, out[0], rtol=0, atol=0)
    ref_cond = jax.jit(lambda vv, t: jm.apply(vv, t, method=jm.compute_conditional))(
        v, jnp.asarray(tok))
    with torch.no_grad():
        assert_close(port.compute_conditional(torch.from_numpy(tok)), ref_cond, **TOL)


def test_masked_one_shot():
    img, cond, _ = _data(seed=4)
    img_s, _, _ = _data(seed=5)
    seg = (np.random.default_rng(6).uniform(0, 1, (2, 32, 32)) > 0.4).astype(np.float32)
    jm, v, port = _pair(jclipseg.CLIPDensePredTMasked, clipseg.CLIPDensePredTMasked,
                        img, cond, extract_layers=(1, 2), reduce_dim=16)
    (ref,) = jax.jit(jm.apply)(v, jnp.asarray(img), jnp.asarray(img_s), jnp.asarray(seg))
    ref_cond = jax.jit(lambda vv, a, s: jm.apply(
        vv, a, s, method=jm.visual_forward_masked))(v, jnp.asarray(img_s), jnp.asarray(seg))
    with torch.no_grad():
        (out,) = port(to_torch(img), to_torch(img_s), to_torch(seg))
        (plain,) = port(to_torch(img), to_torch(cond))
        pooled = port.visual_forward_masked(to_torch(img_s), to_torch(seg))
    assert_close(pooled, ref_cond, **TOL)
    assert_close(out, ref, **TOL)
    (ref_plain,) = jax.jit(jm.apply)(v, jnp.asarray(img), jnp.asarray(cond))
    assert_close(plain, ref_plain, **TOL)


def test_baseline():
    img, cond, tok = _data(seed=7)
    jm = jclipseg.CLIPDenseBaseline(clip_cfg=JTINY, extract_layer=1, reduce_dim=16,
                                    reduce2_dim=8)
    v = random_variables(jm, jnp.asarray(img), jnp.asarray(tok), seed=8)
    port = load_flax_variables(clipseg.CLIPDenseBaseline(
        clip_cfg=TINY, extract_layer=1, reduce_dim=16, reduce2_dim=8), v).eval()
    (ref,) = jax.jit(jm.apply)(v, jnp.asarray(img), jnp.asarray(cond))
    (ref_t,) = jax.jit(jm.apply)(v, jnp.asarray(img), jnp.asarray(tok))
    with torch.no_grad():
        assert_close(port(to_torch(img), to_torch(cond))[0], ref, **TOL)
        assert_close(port(to_torch(img), torch.from_numpy(tok))[0], ref_t, **TOL)
        feats = port(to_torch(img), to_torch(cond), return_features=True)
    assert feats[1].shape == (2, 32) and len(feats[3]) == 1


def test_multilabel():
    img, _, _ = _data(seed=9)
    conds = np.random.default_rng(10).standard_normal((4, 32)).astype(np.float32)
    jm, v, port = _pair(jclipseg.CLIPDensePredT, clipseg.CLIPDensePredT, img, conds[:2],
                        extract_layers=(1,), reduce_dim=16)
    ref = jclipseg.clipseg_multilabel(jm, v, jnp.asarray(img), jnp.asarray(conds))
    with torch.no_grad():
        out = clipseg.clipseg_multilabel(port, to_torch(img), to_torch(conds))
    assert out.shape == (2, 32, 32, 4)
    assert_close(out, ref, **TOL)
    assert clipseg.PASCAL_VOC_CLASSES == jclipseg.PASCAL_VOC_CLASSES


def test_encoder_layer_and_prompts():
    x = np.random.default_rng(11).standard_normal((2, 6, 16)).astype(np.float32)
    jl = jclipseg.TorchEncoderLayer(16, 4, dim_feedforward=32)
    v = random_variables(jl, jnp.asarray(x), seed=12)
    layer = load_flax_variables(clipseg.TorchEncoderLayer(16, 4, dim_feedforward=32), v)
    with torch.no_grad():
        assert_close(layer(to_torch(x)), jax.jit(jl.apply)(v, jnp.asarray(x)),
                     2e-4, 2e-4)
    for mode in ("plain", "fixed", "shuffle", "shuffle+"):
        assert clipseg.get_prompt_list(mode) == jclipseg.get_prompt_list(mode)
    with pytest.raises(ValueError):
        clipseg.get_prompt_list("nope")
    words = ["cat", "dog", "bus"]
    plist = clipseg.get_prompt_list("shuffle+")
    assert (clipseg.sample_prompts(words, plist, np.random.default_rng(3))
            == jclipseg.sample_prompts(words, plist, np.random.default_rng(3)))


def test_tower_frozen_decoder_trains():
    img, cond, _ = _data(seed=13)
    _, _, port = _pair(jclipseg.CLIPDensePredT, clipseg.CLIPDensePredT, img, cond,
                       extract_layers=(1, 2), reduce_dim=16)
    with torch.enable_grad():  # other test modules switch grad off globally
        (logits,) = port(to_torch(img), to_torch(cond))
        (logits ** 2).sum().backward()
    for name, p in port.named_parameters():
        if name.startswith("clip."):
            assert p.grad is None, name
    assert port.film_mul.kernel.grad.abs().max() > 0
    assert port.trans_conv_kernel.grad.abs().max() > 0


def test_bridge_is_strict_on_the_clipseg_tree():
    img, cond, _ = _data()
    jm = jclipseg.CLIPDensePredT(clip_cfg=JTINY, extract_layers=(1,), reduce_dim=16)
    v = random_variables(jm, jnp.asarray(img), jnp.zeros((2, 24), jnp.int32))
    model = clipseg.CLIPDensePredT(clip_cfg=TINY, extract_layers=(1,), reduce_dim=16)
    state = state_dict_from_flax(model, v)
    assert set(state) == set(model.state_dict())
    params = dict(v["params"])
    params["reduce0"] = {"kernel": np.zeros((3, 3), np.float32),
                         "bias": params["reduce0"]["bias"]}
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(model, {"params": params})
    params = dict(v["params"])
    del params["trans_conv_bias"]
    with pytest.raises(KeyError, match="trans_conv_bias"):
        state_dict_from_flax(model, {"params": params})
    params = dict(v["params"])
    params["extra0"] = {"norm1": {"scale": np.ones(16, np.float32)}}
    with pytest.raises(ValueError, match="not consumed"):
        state_dict_from_flax(model, {"params": params})


def test_bf16_weights_keep_the_decoder_tail_float32():
    img, cond, _ = _data(seed=14)
    _, _, port = _pair(jclipseg.CLIPDensePredT, clipseg.CLIPDensePredT, img, cond,
                       extract_layers=(1, 2), reduce_dim=16)
    with torch.no_grad():
        (want,) = port(to_torch(img), to_torch(cond))
        cast_weights(port, torch.bfloat16)
        (got,) = port(to_torch(img), to_torch(cond))
    assert port.block0.norm1.scale.dtype == torch.float32
    assert port.trans_conv_kernel.dtype == torch.float32
    assert port.reduce0.kernel.dtype == torch.bfloat16
    assert got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < 0.1 * max(scale, 1.0)
