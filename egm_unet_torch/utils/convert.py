"""Checkpoint converters: reference-format PyTorch state dicts -> the port's
``state_dict`` (port of ``egm_unet_tpu/utils/convert.py``).

Covers two of the reference's checkpoint families:
- CLIP / Long-CLIP towers (``longclip-B.pt`` or an OpenAI ``ViT-B/16``);
- the CLIPSeg decoder (``rd64-uni.pth``, loaded non-strictly over the frozen
  tower).

CLIP towers are the ViT or the ModifiedResNet (a tuple ``vision_layers``).
The GRFB/EGM-UNet ``.pth`` name map is ``utils/convert_unet.py``;
``load_converted_clip`` reads back what ``cli/convert.py --kind clip``
writes.

Layout maps: Linear weight [out, in] -> ``Dense`` kernel [in, out]
(transpose); Conv2d OIHW -> HWIO; ConvTranspose2d (in, out, kh, kw) ->
(in, kh, kw, out).  Keys are the port's dotted parameter names.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    return np.asarray(w, dtype=np.float32)


def _put(out: dict, key: str, arr: np.ndarray) -> None:
    out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def linear(out: dict, sd, src: str, dst: str) -> None:
    _put(out, f"{dst}.kernel", _t(sd[f"{src}.weight"]).T)
    if f"{src}.bias" in sd:
        _put(out, f"{dst}.bias", _t(sd[f"{src}.bias"]))


def conv_oihw(out: dict, sd, src: str, dst: str) -> None:
    _put(out, f"{dst}.kernel", _t(sd[f"{src}.weight"]).transpose(2, 3, 1, 0))
    if f"{src}.bias" in sd:
        _put(out, f"{dst}.bias", _t(sd[f"{src}.bias"]))


def layernorm(out: dict, sd, src: str, dst: str) -> None:
    _put(out, f"{dst}.scale", _t(sd[f"{src}.weight"]))
    _put(out, f"{dst}.bias", _t(sd[f"{src}.bias"]))


def _resblock(out: dict, sd, src: str, dst: str) -> None:
    layernorm(out, sd, f"{src}.ln_1", f"{dst}.ln_1")
    layernorm(out, sd, f"{src}.ln_2", f"{dst}.ln_2")
    _put(out, f"{dst}.in_proj.kernel", _t(sd[f"{src}.attn.in_proj_weight"]).T)
    _put(out, f"{dst}.in_proj.bias", _t(sd[f"{src}.attn.in_proj_bias"]))
    linear(out, sd, f"{src}.attn.out_proj", f"{dst}.out_proj")
    linear(out, sd, f"{src}.mlp.c_fc", f"{dst}.c_fc")
    linear(out, sd, f"{src}.mlp.c_proj", f"{dst}.c_proj")


def infer_clip_config(sd: Mapping) -> dict:
    """``CLIPConfig`` kwargs from the shapes of a reference CLIP state dict.
    ``visual.proj`` present means a ViT tower; otherwise ``vision_layers`` is
    the ModifiedResNet's tuple of per-stage block counts."""
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len([k for k in sd
                             if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")])
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_w = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_patch_size = 0
        image_resolution = out_w * 32
    return dict(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
        long_clip="positional_embedding_res" in sd,
    )


def _inference_bn(out: dict, sd, src: str, dst: str) -> None:
    """torch ``BatchNorm2d`` weights and running statistics -> an
    ``InferenceBatchNorm`` (``models/clip/resnet.py``)."""
    _put(out, f"{dst}.scale", _t(sd[f"{src}.weight"]))
    _put(out, f"{dst}.bias", _t(sd[f"{src}.bias"]))
    _put(out, f"{dst}.mean", _t(sd[f"{src}.running_mean"]))
    _put(out, f"{dst}.var", _t(sd[f"{src}.running_var"]))


def _rn_visual(out: dict, sd, stage_blocks) -> None:
    """The ModifiedResNet tower of a reference state dict (module names of
    ref: clip/model.py:106-157) -> ``visual.*`` of the port's CLIP."""
    for i in (1, 2, 3):
        conv_oihw(out, sd, f"visual.conv{i}", f"visual.stem_conv{i}")
        _inference_bn(out, sd, f"visual.bn{i}", f"visual.stem_bn{i}")
    for stage, blocks in enumerate(stage_blocks, start=1):
        for b in range(blocks):
            src, dst = f"visual.layer{stage}.{b}", f"visual.layer{stage}_{b}"
            for j in (1, 2, 3):
                conv_oihw(out, sd, f"{src}.conv{j}", f"{dst}.conv{j}")
                _inference_bn(out, sd, f"{src}.bn{j}", f"{dst}.bn{j}")
            if f"{src}.downsample.0.weight" in sd:
                conv_oihw(out, sd, f"{src}.downsample.0", f"{dst}.ds_conv")
                _inference_bn(out, sd, f"{src}.downsample.1", f"{dst}.ds_bn")
    _put(out, "visual.attnpool.positional_embedding",
         _t(sd["visual.attnpool.positional_embedding"]))
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        linear(out, sd, f"visual.attnpool.{name}", f"visual.attnpool.{name}")


def clip_from_torch(sd: Mapping, n_vision_layers,
                    n_text_layers: int) -> Dict[str, torch.Tensor]:
    """Reference CLIP state dict -> the ``state_dict`` of
    ``models.clip.model.CLIP``.  ``n_vision_layers``: the ViT depth, or the
    ModifiedResNet's tuple of per-stage block counts."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(n_vision_layers, (tuple, list)):
        _rn_visual(out, sd, tuple(n_vision_layers))
    else:
        conv_oihw(out, sd, "visual.conv1", "visual.conv1")
        for name in ("class_embedding", "positional_embedding", "proj"):
            _put(out, f"visual.{name}", _t(sd[f"visual.{name}"]))
        layernorm(out, sd, "visual.ln_pre", "visual.ln_pre")
        layernorm(out, sd, "visual.ln_post", "visual.ln_post")
        for i in range(n_vision_layers):
            _resblock(out, sd, f"visual.transformer.resblocks.{i}",
                      f"visual.resblock{i}")
    _put(out, "token_embedding.embedding", _t(sd["token_embedding.weight"]))
    for name in ("positional_embedding", "text_projection", "logit_scale"):
        _put(out, name, _t(sd[name]))
    if "positional_embedding_res" in sd:
        _put(out, "positional_embedding_res", _t(sd["positional_embedding_res"]))
    layernorm(out, sd, "ln_final", "ln_final")
    for i in range(n_text_layers):
        _resblock(out, sd, f"transformer.resblocks.{i}", f"text_resblock{i}")
    return out


def load_clip_checkpoint(path: str, stretch_to_long: bool = False):
    """A reference CLIP / Long-CLIP checkpoint file -> ``(CLIPConfig kwargs,
    state_dict of CLIP)``.  With ``stretch_to_long`` an OpenAI 77-context
    checkpoint gets the Long-CLIP positional stretch."""
    from egm_unet_torch.models.clip.model import stretch_positional_embedding

    with open(path, "rb") as f:
        try:
            sd = torch.jit.load(f, map_location="cpu").eval().state_dict()
        except RuntimeError:
            f.seek(0)
            sd = torch.load(f, map_location="cpu", weights_only=False)
    sd = {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    cfg = infer_clip_config(sd)
    if stretch_to_long and not cfg["long_clip"]:
        pe = stretch_positional_embedding(sd["positional_embedding"])
        sd["positional_embedding"] = pe
        sd["positional_embedding_res"] = pe.copy()
        cfg["context_length"] = pe.shape[0]
        cfg["long_clip"] = True
    return cfg, clip_from_torch(sd, cfg["vision_layers"], cfg["transformer_layers"])


def load_converted_clip(path: str):
    """The file ``cli/convert.py --kind clip`` wrote -> ``(CLIPConfig,
    state_dict of CLIP)``.  The file keeps the scalar config fields, as the
    JAX CLI does; a ModifiedResNet tower's per-stage block counts are read
    back from its parameter names."""
    from egm_unet_torch.models.clip.model import CLIPConfig

    saved = torch.load(path, map_location="cpu", weights_only=True)
    cfg, params = dict(saved["config"]), saved["params"]
    if "vision_layers" not in cfg:
        cfg["vision_layers"] = tuple(
            len({k.split(".")[1] for k in params
                 if k.startswith(f"visual.layer{s}_")}) for s in (1, 2, 3, 4))
    return CLIPConfig(**cfg), params


def _torch_encoder_layer(out: dict, sd, src: str, dst: str) -> None:
    _put(out, f"{dst}.in_proj.kernel", _t(sd[f"{src}.self_attn.in_proj_weight"]).T)
    _put(out, f"{dst}.in_proj.bias", _t(sd[f"{src}.self_attn.in_proj_bias"]))
    linear(out, sd, f"{src}.self_attn.out_proj", f"{dst}.out_proj")
    linear(out, sd, f"{src}.linear1", f"{dst}.linear1")
    linear(out, sd, f"{src}.linear2", f"{dst}.linear2")
    layernorm(out, sd, f"{src}.norm1", f"{dst}.norm1")
    layernorm(out, sd, f"{src}.norm2", f"{dst}.norm2")


def clipseg_decoder_from_torch(sd: Mapping, depth: int = 3) -> Dict[str, torch.Tensor]:
    """``rd64-uni.pth`` decoder weights -> a partial ``state_dict`` of
    ``CLIPDensePredT`` (merge it over the model's own with ``merge_params``,
    like the reference's non-strict load)."""
    out: Dict[str, torch.Tensor] = {}
    linear(out, sd, "film_mul", "film_mul")
    linear(out, sd, "film_add", "film_add")
    for i in range(depth):
        linear(out, sd, f"reduces.{i}", f"reduce{i}")
        _torch_encoder_layer(out, sd, f"blocks.{i}", f"block{i}")
    if "trans_conv.weight" in sd:  # (in, out, kh, kw) -> (in, kh, kw, out)
        _put(out, "trans_conv_kernel", _t(sd["trans_conv.weight"]).transpose(0, 2, 3, 1))
        _put(out, "trans_conv_bias", _t(sd["trans_conv.bias"]))
    return out


def merge_params(base: Mapping, override: Mapping, prefix: str = "") -> dict:
    """Non-strict merge of a partial state dict over a full one: every key of
    ``override`` (under ``prefix``) replaces ``base``'s; a key that ``base``
    does not have raises."""
    out = dict(base)
    for k, v in override.items():
        key = prefix + k
        if key not in out:
            raise KeyError(f"{key!r} is not a parameter of the model")
        out[key] = v
    return out
