"""egm_unet_torch checkpoint converters against egm_unet_tpu's, on synthetic
reference-format state dicts: the same tensors must come out by both routes,
state dict -> JAX params -> flax bridge, and state dict -> the port."""

import dataclasses

import numpy as np
import pytest
import torch

from egm_unet_tpu.utils import convert as jconvert

from egm_unet_torch.models.clip.model import CLIP, CLIPConfig
from egm_unet_torch.models.clipseg import CLIPDensePredT
from egm_unet_torch.utils import convert
from egm_unet_torch.utils.from_flax import state_dict_from_flax

W, TW, E, P, RES, CTX, VOCAB, VL, TL = 64, 64, 32, 16, 32, 77, 300, 2, 2


def _clip_sd(seed=0, long_clip=False, ctx=CTX):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    sd = {"visual.conv1.weight": r(W, 3, P, P), "visual.class_embedding": r(W),
          "visual.positional_embedding": r((RES // P) ** 2 + 1, W),
          "visual.ln_pre.weight": r(W), "visual.ln_pre.bias": r(W),
          "visual.ln_post.weight": r(W), "visual.ln_post.bias": r(W),
          "visual.proj": r(W, E), "token_embedding.weight": r(VOCAB, TW),
          "positional_embedding": r(ctx, TW), "ln_final.weight": r(TW),
          "ln_final.bias": r(TW), "text_projection": r(TW, E),
          "logit_scale": np.asarray(2.5, np.float32)}
    if long_clip:
        sd["positional_embedding_res"] = r(ctx, TW)
    for prefix, n, w in (("visual.transformer.resblocks", VL, W),
                         ("transformer.resblocks", TL, TW)):
        for i in range(n):
            b = f"{prefix}.{i}"
            sd.update({f"{b}.ln_1.weight": r(w), f"{b}.ln_1.bias": r(w),
                       f"{b}.ln_2.weight": r(w), f"{b}.ln_2.bias": r(w),
                       f"{b}.attn.in_proj_weight": r(3 * w, w),
                       f"{b}.attn.in_proj_bias": r(3 * w),
                       f"{b}.attn.out_proj.weight": r(w, w),
                       f"{b}.attn.out_proj.bias": r(w),
                       f"{b}.mlp.c_fc.weight": r(4 * w, w), f"{b}.mlp.c_fc.bias": r(4 * w),
                       f"{b}.mlp.c_proj.weight": r(w, 4 * w), f"{b}.mlp.c_proj.bias": r(w)})
    return sd


def _decoder_sd(seed=1, depth=2, rd=16, ff=2048):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    sd = {"film_mul.weight": r(rd, E), "film_mul.bias": r(rd),
          "film_add.weight": r(rd, E), "film_add.bias": r(rd),
          "trans_conv.weight": r(rd, 1, P, P), "trans_conv.bias": r(1)}
    for i in range(depth):
        b = f"blocks.{i}"
        sd.update({f"reduces.{i}.weight": r(rd, W), f"reduces.{i}.bias": r(rd),
                   f"{b}.self_attn.in_proj_weight": r(3 * rd, rd),
                   f"{b}.self_attn.in_proj_bias": r(3 * rd),
                   f"{b}.self_attn.out_proj.weight": r(rd, rd),
                   f"{b}.self_attn.out_proj.bias": r(rd),
                   f"{b}.linear1.weight": r(ff, rd), f"{b}.linear1.bias": r(ff),
                   f"{b}.linear2.weight": r(rd, ff), f"{b}.linear2.bias": r(rd),
                   f"{b}.norm1.weight": r(rd), f"{b}.norm1.bias": r(rd),
                   f"{b}.norm2.weight": r(rd), f"{b}.norm2.bias": r(rd)})
    return sd


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("long_clip", [False, True])
def test_clip_converter_routes_agree(long_clip):
    sd = _clip_sd(long_clip=long_clip)
    cfg = convert.infer_clip_config(sd)
    assert cfg == jconvert.infer_clip_config(sd)
    assert cfg["vision_layers"] == VL and cfg["long_clip"] == long_clip
    model = CLIP(CLIPConfig(**cfg))
    direct = convert.clip_from_torch(sd, VL, TL)
    bridged = state_dict_from_flax(model, {"params": jconvert.clip_from_torch(sd, VL, TL)})
    _same(direct, bridged)
    model.load_state_dict(direct)  # strict: every parameter is covered
    # a torch tensor state dict converts the same
    _same(convert.clip_from_torch({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                                  VL, TL), direct)


def test_clipseg_decoder_routes_agree():
    sd = _decoder_sd()
    cfg = CLIPConfig(**convert.infer_clip_config(_clip_sd()))
    model = CLIPDensePredT(clip_cfg=cfg, extract_layers=(0, 1), reduce_dim=16)
    direct = convert.clipseg_decoder_from_torch(sd, depth=2)
    full = jconvert.merge_params(
        {"clip": jconvert.clip_from_torch(_clip_sd(), VL, TL)},
        jconvert.clipseg_decoder_from_torch(sd, depth=2))
    bridged = state_dict_from_flax(model, {"params": full})
    for k, v in direct.items():
        torch.testing.assert_close(v, bridged[k], rtol=0, atol=0, msg=k)
    merged = convert.merge_params(model.state_dict(), direct)
    merged = convert.merge_params(merged, convert.clip_from_torch(_clip_sd(), VL, TL),
                                  prefix="clip.")
    _same(merged, bridged)
    model.load_state_dict(merged)
    with pytest.raises(KeyError, match="no_such"):
        convert.merge_params(model.state_dict(), {"no_such.kernel": torch.zeros(1)})


@pytest.mark.parametrize("stretch", [False, True])
def test_load_clip_checkpoint(tmp_path, stretch):
    sd = _clip_sd(seed=2)
    path = tmp_path / "clip.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    cfg, state = convert.load_clip_checkpoint(str(path), stretch_to_long=stretch)
    jcfg, jparams = jconvert.load_clip_checkpoint(str(path), stretch_to_long=stretch)
    assert cfg == jcfg
    assert cfg["context_length"] == (248 if stretch else 77)
    assert cfg["long_clip"] == stretch
    model = CLIP(CLIPConfig(**cfg))
    _same(state, state_dict_from_flax(model, {"params": jparams}))
    model.load_state_dict(state)


def test_resnet_checkpoints_wait():
    """Since the RN tower landed, a tuple ``vision_layers`` takes the RN
    converter (it reads the ModifiedResNet's module names, which a ViT state
    dict lacks) and builds the RN tower; the RN conversion itself is held
    against the JAX converter in tests/test_torch_clip_resnet.py."""
    sd = _clip_sd()
    with pytest.raises(KeyError, match="visual.bn1.weight"):
        convert.clip_from_torch(sd, (1, 1, 1, 1), TL)
    assert callable(convert._rn_visual) and callable(convert._inference_bn)
    cfg = dataclasses.replace(CLIPConfig(**convert.infer_clip_config(sd)),
                              vision_layers=(1, 1, 1, 1))
    assert type(CLIP(cfg).visual).__name__ == "ModifiedResNet"
