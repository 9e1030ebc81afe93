"""GRFB/EGM-UNet checkpoint converter (port of
``egm_unet_tpu/utils/convert_unet.py``): the reference's torch ``.pth`` state
dicts (saved by its train.py as ``{'model': state_dict, ...}``, or bare) ->
the port's ``state_dict``.

Reference module tree (names as produced by src/EGM-UNet.py):
  in_conv.{0,1,3,4}                 DoubleConv: conv/bn/relu x2
  down{k}.1.{0,1,4,5}               DoubleConv1 conv/bn (Sequential idx)
  down{k}.1.3.(h_cw|w_hc|c_hw)      MCALayer gates (conv, weight)
  down{k}.1.7.*                     EdgeEnhancedGRFB
  attn1.*                           RecursiveGatedAttention
  up{k}.conv.{0,1,3,4}              decoder DoubleConv
  out_conv.0                        1x1 conv

Without the MCALayer (the ``egm_unet_ab`` "yuan" layout, ``use_mca=False``)
the Sequential reads conv, bn, relu, conv, bn, relu, block: indices 3, 4, 6.

The keys map first onto the flax-shaped tree of the JAX package
(``egm_unet_from_torch``: conv OIHW -> HWIO, the MCA gates' conv1d
(1, 1, 1, k) -> (k,)), then through ``utils/from_flax.py`` onto
``create_model(name, fold_bn=...)``: the training graph takes the BatchNorm
statistics as buffers, the folded graph has them folded in.  Keys the map
does not read (``num_batches_tracked``, or blocks a variant does not have)
are ignored, as the JAX converter ignores them.  The variants are those of
the JAX converter: ``block`` ``"edge"`` or None, ``use_rga`` and ``use_mca``
on or off; ``grfb_unet`` and ``unet`` are not covered.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from egm_unet_torch.models.registry import MODEL_CONFIGS, create_model
from egm_unet_torch.utils.from_flax import state_dict_from_flax


def _t(w):
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def _conv(sd, key):
    out = {"Conv_0": {"kernel": _t(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}}
    if f"{key}.bias" in sd:
        out["Conv_0"]["bias"] = _t(sd[f"{key}.bias"])
    return out


def _bn_params(sd, key):
    return {"BatchNorm_0": {"scale": _t(sd[f"{key}.weight"]),
                            "bias": _t(sd[f"{key}.bias"])}}


def _bn_stats(sd, key):
    return {"BatchNorm_0": {"mean": _t(sd[f"{key}.running_mean"]),
                            "var": _t(sd[f"{key}.running_var"])}}


def _convbnrelu(sd, conv_key, bn_key):
    p = {"Conv_0": _conv(sd, conv_key), "BatchNorm_0": _bn_params(sd, bn_key)}
    s = {"BatchNorm_0": _bn_stats(sd, bn_key)}
    return p, s


def _double_conv(sd, prefix):
    p1, s1 = _convbnrelu(sd, f"{prefix}.0", f"{prefix}.1")
    p2, s2 = _convbnrelu(sd, f"{prefix}.3", f"{prefix}.4")
    return ({"ConvBNReLU_0": p1, "ConvBNReLU_1": p2},
            {"ConvBNReLU_0": s1, "ConvBNReLU_1": s2})


def _edge_aware(sd, prefix):
    p = {"Conv_0": _conv(sd, f"{prefix}.weight_generator.0"),
         "BatchNorm_0": _bn_params(sd, f"{prefix}.weight_generator.1")}
    s = {"BatchNorm_0": _bn_stats(sd, f"{prefix}.weight_generator.1")}
    return p, s


def _mcagate(sd, prefix):
    # torch conv (1, 1, 1, k) -> (k,)
    return {"conv": _t(sd[f"{prefix}.conv.weight"]).reshape(-1),
            "weight": _t(sd[f"{prefix}.weight"])}


def _mca(sd, prefix):
    return {name: _mcagate(sd, f"{prefix}.{name}") for name in ("h_cw", "w_hc", "c_hw")}


def _fusion(sd, prefix):
    def raw(key):
        return _t(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)

    out = {}
    for ours, theirs in (("down", "down"), ("conv3", "conv_3x3"),
                         ("conv5", "conv_5x5"), ("conv7", "conv_7x7")):
        out[f"{ours}_kernel"] = raw(f"{prefix}.{theirs}")
        out[f"{ours}_bias"] = _t(sd[f"{prefix}.{theirs}.bias"])
    out["spatial"] = {"Conv_0": _conv(sd, f"{prefix}.spatial_attention.conv1")}
    out["channel"] = {"fc_down": _conv(sd, f"{prefix}.channel_attention.fc.0"),
                      "fc_up": _conv(sd, f"{prefix}.channel_attention.fc.2")}
    out["up"] = _conv(sd, f"{prefix}.up")
    return out


# EdgeEnhancedGRFB branches: the port's (and flax's) name -> the reference's
_EGRFB_BRANCHES = {
    "dir0": "branch_dir.0", "dir1": "branch_dir.1", "dir2": "branch_dir.2",
    "edge0": "branch_edge.0", "edge1": "branch_edge.2", "edge2": "branch_edge.3",
    "edge3": "branch_edge.4",
    "ctx0": "branch_ctx.0", "ctx1": "branch_ctx.1", "ctx2": "branch_ctx.2",
    "ctx3": "branch_ctx.3", "shortcut": "shortcut",
}


def _egrfb(sd, prefix):
    p: Dict = {}
    s: Dict = {}
    p["edge_enhancer"], s["edge_enhancer"] = _edge_aware(sd, f"{prefix}.edge_enhancer")
    for ours, theirs in _EGRFB_BRANCHES.items():
        p[ours], s[ours] = _convbnrelu(sd, f"{prefix}.{theirs}.conv",
                                       f"{prefix}.{theirs}.bn")
    p["edge_eafe"], s["edge_eafe"] = _edge_aware(sd, f"{prefix}.branch_edge.1")
    p["fusion"] = _fusion(sd, f"{prefix}.fusion_conv")
    p["target_enhancer"] = _conv(sd, f"{prefix}.target_enhancer.0")
    return p, s


def _rga(sd, prefix, order: int = 2):
    p = {"proj_in": _conv(sd, f"{prefix}.proj_in"),
         "dwconv": _conv(sd, f"{prefix}.dwconv"),
         "proj_out": _conv(sd, f"{prefix}.proj_out"),
         # the reference's scale is a 0-d tensor; (1,) exports load too
         "scale": _t(sd[f"{prefix}.scale"]).reshape(())}
    for i in range(order):
        p[f"gate{i}_down"] = _conv(sd, f"{prefix}.gate_convs.{i}.0")
        p[f"gate{i}_up"] = _conv(sd, f"{prefix}.gate_convs.{i}.2")
        if i < order - 1:
            p[f"transform{i}"] = _conv(sd, f"{prefix}.transform_convs.{i}")
    return p


def egm_unet_from_torch(sd, block: Optional[str] = "edge", use_rga: bool = True,
                        use_mca: bool = True):
    """A reference GRFBUNet state dict (numpy arrays or tensors) ->
    ``(params, batch_stats)``, the flax-shaped tree of numpy arrays that
    ``utils/from_flax.py`` bridges."""
    params: Dict = {}
    stats: Dict = {}
    params["in_conv"], stats["in_conv"] = _double_conv(sd, "in_conv")
    # (second conv, its bn, the block) in the Sequential, with and without MCA
    idx_c2, idx_b2, idx_block = (4, 5, 7) if use_mca else (3, 4, 6)
    for k in range(1, 5):
        prefix = f"down{k}.1"
        p1, s1 = _convbnrelu(sd, f"{prefix}.0", f"{prefix}.1")
        p2, s2 = _convbnrelu(sd, f"{prefix}.{idx_c2}", f"{prefix}.{idx_b2}")
        dp = {"conv1": p1, "conv2": p2}
        ds = {"conv1": s1, "conv2": s2}
        if use_mca:
            dp["mca"] = _mca(sd, f"{prefix}.3")
        if block == "edge":
            dp["egrfb"], ds["egrfb"] = _egrfb(sd, f"{prefix}.{idx_block}")
        params[f"down{k}"] = dp
        stats[f"down{k}"] = ds
    if use_rga:
        params["attn1"] = _rga(sd, "attn1")
    for k in range(1, 5):
        p, s = _double_conv(sd, f"up{k}.conv")
        params[f"up{k}"] = {"DoubleConv_0": p}
        stats[f"up{k}"] = {"DoubleConv_0": s}
    params["out_conv"] = _conv(sd, "out_conv.0")
    return params, stats


def read_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a reference ``.pth``: a train.py checkpoint dict
    (``{'model': state_dict, ...}``) or a bare state dict, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_egm_checkpoint(path: str, **kwargs):
    """A reference ``.pth`` -> ``(params, batch_stats)``, as the JAX
    package's ``load_egm_checkpoint`` returns them."""
    return egm_unet_from_torch(read_reference_state_dict(path), **kwargs)


def variant_of(model_name: str) -> dict:
    """``egm_unet_from_torch``'s keyword arguments for a registry name."""
    cfg = MODEL_CONFIGS.get(model_name)
    if cfg is None or cfg["block"] not in ("edge", None):
        raise ValueError(f"the reference converter covers the EGM-UNet variants "
                         f"with block 'edge' or None, not {model_name!r}")
    return dict(cfg)


def egm_state_dict(sd, model_name: str = "egm_unet", num_classes: int = 2,
                   base_c: int = 32, fold_bn: bool = False) -> Dict[str, torch.Tensor]:
    """A reference state dict -> the ``state_dict`` of
    ``create_model(model_name, num_classes=..., base_c=..., fold_bn=...)``,
    which it loads with ``strict=True``."""
    params, stats = egm_unet_from_torch(sd, **variant_of(model_name))
    model = create_model(model_name, num_classes=num_classes, base_c=base_c,
                         fold_bn=fold_bn)
    return state_dict_from_flax(model, {"params": params, "batch_stats": stats})
