"""VITDensePredT: the CLIPSeg decoder over a plain (timm-style) ViT backbone
instead of CLIP's visual tower (port of ``egm_unet_tpu/models/vitseg.py``;
the reference's models/vitseg.py, referenced only by
experiments/phrasecut.yaml's vit64-uni configurations).

What differs from the CLIP ViT, as in the JAX package: exact GELU (not
QuickGELU), a patch-embed conv with a bias, no ``ln_pre`` (the final norm
comes at the end), inputs resized to the backbone's resolution (384 for
ViT-B/16) by an align_corners bilinear resize.  The text conditioning is a
[B, cond_dim] embedding (precomputed prompt vectors or a CLIP text
encoding).  Attention is the plain ``ops.attention.multi_head_attention``:
no hand-written kernel runs here, as no Pallas kernel does in the JAX
module.  Names mirror the flax tree (``vit.block3.qkv.kernel``,
``vit.norm.LayerNorm_0.scale``, ``reduce0``, ``film_mul``,
``trans_conv_kernel``, ...), so ``utils/from_flax.py`` bridges the weights.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.models.clip.model import LayerNormF32, normal_
from egm_unet_torch.models.clipseg import TorchEncoderLayer
from egm_unet_torch.nn.layers import CoreConv, Dense, torch_kernel_init
from egm_unet_torch.ops.attention import multi_head_attention
from egm_unet_torch.ops.conv import conv_transpose2d_nonoverlap
from egm_unet_torch.ops.resize import resize_bilinear


class ViTBlock(nn.Module):
    """timm-style pre-norm block with exact GELU."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNormF32(width)
        self.qkv = Dense(width, 3 * width)
        self.proj = Dense(width, width)
        self.norm2 = LayerNormF32(width)
        self.fc1 = Dense(width, 4 * width)
        self.fc2 = Dense(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        x = x + self.proj(multi_head_attention(q, k, v, self.heads))
        h = F.gelu(self.fc1(self.norm2(x)), approximate="none")
        return x + self.fc2(h)


class PlainViT(nn.Module):
    """vit_base_patch16_384-shaped backbone that returns the tokens after the
    final norm and the activations after the blocks in ``extract_layers``."""

    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12,
                 patch: int = 16, resolution: int = 384):
        super().__init__()
        self.width, self.layers = width, layers
        self.patch_embed = CoreConv(3, width, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros((resolution // patch) ** 2 + 1, width))
        for i in range(layers):
            setattr(self, f"block{i}", ViTBlock(width, heads))
        self.norm = LayerNormF32(width)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The flax initialisers: a zero class token, positions N(0, 0.02)."""
        with torch.no_grad():
            self.cls_token.zero_()
        normal_(self.pos_embed, 0.02, generator)

    def forward(self, x: torch.Tensor, extract_layers: Sequence[int] = ()):
        b = x.shape[0]
        tokens = self.patch_embed(x.to(self.patch_embed.kernel.dtype))
        tokens = tokens.reshape(b, -1, self.width)
        cls = self.cls_token.to(tokens.dtype).expand(b, 1, self.width)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.pos_embed.to(tokens.dtype)[None, :tokens.shape[1]]
        acts = []
        for i in range(self.layers):
            tokens = getattr(self, f"block{i}")(tokens)
            if i in extract_layers:
                acts.append(tokens)
        return self.norm(tokens), acts


class VITDensePredT(nn.Module):
    """The FiLM decoder of ``CLIPDensePredT`` over ``PlainViT``'s
    activations: each (last first) reduced to ``reduce_dim`` and summed in,
    FiLM-conditioned on ``cond`` after reduction ``cond_layer``, refined by a
    torch-style encoder layer, the class token dropped, and the token grid
    upsampled to pixels by the 16x16 stride-16 transposed conv.  The backbone
    is frozen: it runs under ``torch.no_grad()``."""

    def __init__(self, extract_layers: Tuple[int, ...] = (3, 6, 9), cond_layer: int = 0,
                 reduce_dim: int = 64, n_heads: int = 4, cond_dim: int = 512,
                 vit_width: int = 768, vit_layers: int = 12, vit_heads: int = 12,
                 resolution: int = 384):
        super().__init__()
        self.extract_layers = tuple(extract_layers)
        self.cond_layer = cond_layer
        self.resolution = resolution
        self.vit = PlainViT(vit_width, vit_layers, vit_heads, resolution=resolution)
        depth = sum(1 for i in range(vit_layers) if i in self.extract_layers)
        for i in range(depth):
            setattr(self, f"reduce{i}", Dense(vit_width, reduce_dim))
            setattr(self, f"block{i}", TorchEncoderLayer(reduce_dim, n_heads))
        self.film_mul = Dense(cond_dim, reduce_dim)
        self.film_add = Dense(cond_dim, reduce_dim)
        self.trans_conv_kernel = nn.Parameter(torch.zeros(reduce_dim, 16, 16, 1))
        self.trans_conv_bias = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_kernel_init(self.trans_conv_kernel, generator)
        with torch.no_grad():
            self.trans_conv_bias.zero_()

    def forward(self, image: torch.Tensor, cond: torch.Tensor,
                return_features: bool = False):
        """``image`` [B, H, W, 3], ``cond`` [B, cond_dim] -> ``(logits,)``,
        float32 [B, resolution, resolution, 1].  ``return_features`` is
        accepted for the reference's signature and returns the same tuple,
        as the JAX module does."""
        res = self.resolution
        if tuple(image.shape[1:3]) != (res, res):
            image = resize_bilinear(image, (res, res), align_corners=True)
        with torch.no_grad():
            _, activations = self.vit(image, self.extract_layers)

        a = None
        for i, act in enumerate(activations[::-1]):
            red = getattr(self, f"reduce{i}")(act)
            a = red if a is None else red + a
            if i == self.cond_layer:
                a = (self.film_mul(cond)[:, None, :] * a
                     + self.film_add(cond)[:, None, :])
            a = getattr(self, f"block{i}")(a)

        a = a[:, 1:, :]  # strip the class token
        bs, n_tok, d = a.shape
        size = int(math.sqrt(n_tok))
        a = a.reshape(bs, size, size, d)
        a = conv_transpose2d_nonoverlap(a, self.trans_conv_kernel) + self.trans_conv_bias
        return (a.float(),)
