"""ModifiedResNet CLIP vision tower (port of
``egm_unet_tpu/models/clip/resnet.py``; ref: clip/model.py:14-157).

It differs from the torchvision ResNet as the reference says: a 3-conv stem
with an average pool, anti-aliased strided convs (an average pool after
conv2, and before the downsample conv), and a QKV attention pool instead of
the final average pool.  Activations are NHWC; the attention pool is the
plain ``ops.attention.multi_head_attention`` (standard attention, not CSA:
it reaches no kernel, as in the JAX package).

The BatchNorms are eval-mode with all four of scale, bias, mean and var as
parameters, as the JAX package keeps them in ``params``, so that the names
bridge to the flax tree (``utils/from_flax.py``) like every other parameter.
The tower serves ``encode_image`` from an RN checkpoint and is fine-tuned by
the Long-CLIP step (``engine/longclip_train.py``), which leaves the running
statistics as loaded (``InferenceBatchNorm.frozen_leaves``): they take no
gradient, no AdamW moment and no decay, where the JAX package's fine-tune
would move them.  With ``recompute`` (``CLIPConfig.recompute``, which
``RN50X64`` sets) every Bottleneck keeps only its input for backward and
runs again there (``models.clip.model.recomputed``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.models.clip.model import normal_, recomputed
from egm_unet_torch.nn.layers import CoreConv, Dense
from egm_unet_torch.ops.attention import multi_head_attention
from egm_unet_torch.ops.pooling import avg_pool2d


class InferenceBatchNorm(nn.Module):
    """Eval-mode BatchNorm2d over the last axis (eps 1e-5), in float32,
    returned in the input's dtype.  ``mean`` and ``var`` are the running
    statistics, which a fine-tune leaves as loaded (``frozen_leaves``)."""

    frozen_leaves = ("mean", "var")

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = torch.promote_types(x.dtype, torch.float32)
        inv = self.scale / torch.sqrt(self.var + self.eps)
        return (x.to(acc) * inv + (self.bias - self.mean * inv)).to(x.dtype)


def _conv(in_ch: int, features: int, kernel: int, stride: int = 1) -> CoreConv:
    return CoreConv(in_ch, features, kernel, stride=stride, padding=(kernel - 1) // 2,
                    use_bias=False)


class Bottleneck(nn.Module):
    """ref: clip/model.py:14-57.  Every conv has stride 1; a stride > 1 is an
    average pool after conv2, mirrored on the downsample path."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        out = planes * self.expansion
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), InferenceBatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), InferenceBatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), InferenceBatchNorm(out)
        self.has_ds = stride > 1 or inplanes != out
        if self.has_ds:
            self.ds_conv, self.ds_bn = _conv(inplanes, out, 1), InferenceBatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = avg_pool2d(out, self.stride, self.stride, 0)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.has_ds:
            if self.stride > 1:
                identity = avg_pool2d(x, self.stride, self.stride, 0)
            identity = self.ds_bn(self.ds_conv(identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pool (ref: clip/model.py:60-103): the spatial mean
    prepended as a query token, learned positional embeddings, one
    multi-head attention with separate q, k, v projections; returns the
    first token (or all of them)."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int = 0):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = Dense(embed_dim, embed_dim)
        self.k_proj = Dense(embed_dim, embed_dim)
        self.v_proj = Dense(embed_dim, embed_dim)
        self.c_proj = Dense(embed_dim, output_dim or embed_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.positional_embedding, self.embed_dim ** -0.5, generator)

    def forward(self, x: torch.Tensor, return_all_tokens: bool = False) -> torch.Tensor:
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)[None]
        out = multi_head_attention(self.q_proj(tokens), self.k_proj(tokens),
                                   self.v_proj(tokens), self.num_heads)
        out = self.c_proj(out)
        return out if return_all_tokens else out[:, 0]


class ModifiedResNet(nn.Module):
    """ref: clip/model.py:106-157.  ``layers``: the Bottleneck count per
    stage, e.g. (3, 4, 6, 3) for RN50.  ``recompute``: each Bottleneck is
    run again in backward from its input (``models.clip.model.recomputed``)."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64, recompute: bool = False):
        super().__init__()
        self.layers = tuple(layers)
        self.recompute = recompute
        w = width
        for i, (cin, feats, stride) in enumerate(
                [(3, w // 2, 2), (w // 2, w // 2, 1), (w // 2, w, 1)]):
            setattr(self, f"stem_conv{i + 1}", _conv(cin, feats, 3, stride))
            setattr(self, f"stem_bn{i + 1}", InferenceBatchNorm(feats))
        inplanes = w
        for stage, (planes, blocks, stride) in enumerate(
                [(w, self.layers[0], 1), (w * 2, self.layers[1], 2),
                 (w * 4, self.layers[2], 2), (w * 8, self.layers[3], 2)]):
            for blk in range(blocks):
                setattr(self, f"layer{stage + 1}_{blk}",
                        Bottleneck(inplanes, planes, stride if blk == 0 else 1))
                inplanes = planes * Bottleneck.expansion
        self.attnpool = AttentionPool2d(input_resolution // 32, w * 32, heads, output_dim)

    def forward(self, x: torch.Tensor, csa: bool = True, return_all: bool = False,
                **_) -> torch.Tensor:
        """``x``: NHWC image.  ``csa`` is accepted for the vision towers' common
        signature and ignored: the RN tower has no CSA path."""
        del csa
        x = x.to(self.stem_conv1.kernel.dtype)
        for i in (1, 2, 3):
            bn = getattr(self, f"stem_bn{i}")
            x = F.relu(bn(getattr(self, f"stem_conv{i}")(x)))
        x = avg_pool2d(x, 2, 2, 0)
        for stage, blocks in enumerate(self.layers):
            for blk in range(blocks):
                block = getattr(self, f"layer{stage + 1}_{blk}")
                x = recomputed(block, x) if self.recompute else block(x)
        return self.attnpool(x, return_all_tokens=return_all)

