"""egm_unet_torch's ModifiedResNet CLIP tower (``models/clip/resnet.py``,
``utils/convert.py::_rn_visual``) against egm_unet_tpu on the CPU in float32,
from a synthetic reference-format RN CLIP state dict with randomized
BatchNorm statistics: the shape inference, both converters (the JAX tree
bridged into the port equals the port's own conversion bit for bit), and
``encode_image`` (pooled and all tokens), ``encode_text`` and the contrastive
logits.

Tolerance 1e-4 of each output's largest value: a few float32 convs, eval
BatchNorms and one attention pool summed in another order than XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.models.clip import model as jmodel
from egm_unet_tpu.utils import convert as jconvert

from egm_unet_torch.models.clip.model import CLIP, CLIPConfig
from egm_unet_torch.models.clip.resnet import (AttentionPool2d, Bottleneck,
                                               InferenceBatchNorm, ModifiedResNet)
from egm_unet_torch.utils import convert, load_flax_variables

from tests.torch_port_util import to_torch

LAYERS, WIDTH, EMBED, RES, TEXT_W, CTX = (1, 2, 1, 1), 16, 32, 64, 64, 16


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _ref_state_dict(seed=0):
    """A reference-format RN CLIP state dict (module names of the upstream
    ``clip/model.py``), float32 numpy, BatchNorm statistics randomized."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = (rng.standard_normal((cout, cin, k, k))
                                * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.7, 1.3, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    def linear(name, cout, cin):
        sd[f"{name}.weight"] = (rng.standard_normal((cout, cin)) / np.sqrt(cin)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.02, cout).astype(np.float32)

    w = WIDTH
    for i, (cin, cout) in enumerate([(3, w // 2), (w // 2, w // 2), (w // 2, w)], start=1):
        conv(f"visual.conv{i}", cout, cin, 3)
        bn(f"visual.bn{i}", cout)
    inplanes = w
    for stage, blocks in enumerate(LAYERS, start=1):
        planes = w * 2 ** (stage - 1)
        for b in range(blocks):
            p = f"visual.layer{stage}.{b}"
            conv(f"{p}.conv1", planes, inplanes, 1)
            conv(f"{p}.conv2", planes, planes, 3)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            for j, c in ((1, planes), (2, planes), (3, planes * 4)):
                bn(f"{p}.bn{j}", c)
            if b == 0 and (stage > 1 or inplanes != planes * 4):
                conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    dim = w * 32
    sd["visual.attnpool.positional_embedding"] = (
        rng.standard_normal(((RES // 32) ** 2 + 1, dim)) / np.sqrt(dim)).astype(np.float32)
    for name in ("q_proj", "k_proj", "v_proj"):
        linear(f"visual.attnpool.{name}", dim, dim)
    linear("visual.attnpool.c_proj", EMBED, dim)

    sd["token_embedding.weight"] = rng.normal(0, 0.3, (64, TEXT_W)).astype(np.float32)
    for name in ("positional_embedding", "positional_embedding_res"):
        sd[name] = rng.normal(0, 0.3, (CTX, TEXT_W)).astype(np.float32)
    sd["ln_final.weight"] = rng.uniform(0.7, 1.3, TEXT_W).astype(np.float32)
    sd["ln_final.bias"] = rng.normal(0, 0.1, TEXT_W).astype(np.float32)
    sd["text_projection"] = (rng.standard_normal((TEXT_W, EMBED)) / 8).astype(np.float32)
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    p = "transformer.resblocks.0"
    sd[f"{p}.attn.in_proj_weight"] = (rng.standard_normal((3 * TEXT_W, TEXT_W)) / 8).astype(
        np.float32)
    sd[f"{p}.attn.in_proj_bias"] = rng.normal(0, 0.02, 3 * TEXT_W).astype(np.float32)
    linear(f"{p}.attn.out_proj", TEXT_W, TEXT_W)
    linear(f"{p}.mlp.c_fc", 4 * TEXT_W, TEXT_W)
    linear(f"{p}.mlp.c_proj", TEXT_W, 4 * TEXT_W)
    for ln in ("ln_1", "ln_2"):
        sd[f"{p}.{ln}.weight"] = rng.uniform(0.7, 1.3, TEXT_W).astype(np.float32)
        sd[f"{p}.{ln}.bias"] = rng.normal(0, 0.1, TEXT_W).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def towers():
    sd = _ref_state_dict()
    cfg_kw = convert.infer_clip_config(sd)
    params = jconvert.clip_from_torch(sd, cfg_kw["vision_layers"], cfg_kw["transformer_layers"])
    jm = jmodel.CLIP(jmodel.CLIPConfig(**cfg_kw))
    port = CLIP(CLIPConfig(**cfg_kw))
    port.load_state_dict(convert.clip_from_torch(sd, cfg_kw["vision_layers"],
                                                 cfg_kw["transformer_layers"]))
    return sd, cfg_kw, jm, params, port.eval()


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((2, RES, RES, 3)).astype(np.float32)
    tok = rng.integers(1, 50, (2, CTX)).astype(np.int32)
    tok[0, 5], tok[1, 12] = 63, 63  # EOT: the highest id
    return img, tok


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_shape_inference_is_the_jax_packages(towers):
    sd, cfg_kw, *_ = towers
    assert cfg_kw == jconvert.infer_clip_config(sd)
    assert cfg_kw["vision_layers"] == LAYERS and cfg_kw["image_resolution"] == RES


def test_converters_agree_bit_for_bit(towers):
    _, cfg_kw, _, params, port = towers
    bridged = load_flax_variables(CLIP(CLIPConfig(**cfg_kw)), {"params": params})
    mine = port.state_dict()
    theirs = bridged.state_dict()
    assert set(mine) == set(theirs)
    assert any(k.endswith(".ds_conv.kernel") for k in mine)
    assert {"visual.stem_bn1.mean", "visual.stem_bn1.var"} <= set(mine)
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k


@pytest.mark.parametrize("return_all", [False, True])
def test_encode_image(towers, return_all):
    _, _, jm, params, port = towers
    img, _ = _inputs()
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, return_all=return_all,
                                        method=jm.encode_image))(params, jnp.asarray(img))
    out = port.encode_image(to_torch(img), return_all=return_all)
    assert out.shape == ref.shape == ((2, 5, EMBED) if return_all else (2, EMBED))
    _close(out, ref)


def test_encode_text_and_logits(towers):
    _, _, jm, params, port = towers
    img, tok = _inputs(seed=2)
    ref_txt = jax.jit(lambda p, t: jm.apply({"params": p}, t, method=jm.encode_text))(
        params, jnp.asarray(tok))
    _close(port.encode_text(torch.from_numpy(tok)), ref_txt)
    ref, _ = jax.jit(lambda p, x, t: jm.apply({"params": p}, x, t))(
        params, jnp.asarray(img), jnp.asarray(tok))
    out, out_t = port(to_torch(img), torch.from_numpy(tok))
    _close(out, ref)
    assert torch.equal(out_t, out.T)


def test_rn_tower_has_no_dense_path(towers):
    *_, port = towers
    with pytest.raises(ValueError):
        port.visual_forward_dense(torch.zeros(1, RES, RES, 3), [1])
    assert isinstance(port.visual, ModifiedResNet) and port.dtype == torch.float32


def test_modules_by_name():
    """The flax names the bridge maps by, and the anti-aliased downsample."""
    blk = Bottleneck(16, 8, stride=2)
    names = {k for k, _ in blk.named_parameters()}
    assert {"conv1.kernel", "bn3.var", "ds_conv.kernel", "ds_bn.mean"} <= names
    assert blk(torch.randn(1, 8, 8, 16)).shape == (1, 4, 4, 32)
    assert not Bottleneck(32, 8).has_ds
    bn = InferenceBatchNorm(3)
    x = torch.randn(2, 4, 4, 3, dtype=torch.float64)
    assert bn(x).dtype == torch.float64
    pool = AttentionPool2d(2, 16, 2, 8)
    assert pool(torch.randn(3, 2, 2, 16)).shape == (3, 8)
