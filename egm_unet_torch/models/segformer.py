"""SegFormer (Xie et al., "SegFormer: Simple and Efficient Design for Semantic
Segmentation with Transformers", arXiv:2105.15203): the Mix Transformer
encoder (MiT) and the all-MLP decode head, NHWC in, ``{"out": logits NHWC}``
at the input's size, as the UNets of ``models/registry.py`` return them.
The JAX package has no SegFormer; ``port_bench/reference/segformer.py`` is
the plain float32 reference the tests hold this module to.

Per stage i, on an H x W grid of C = ``hidden_sizes[i]`` channels:

- OverlapPatchEmbed: ``Conv(k, stride s, pad k // 2)``, then LayerNorm;
- ``depths[i]`` Blocks: ``x = x + Attn(LN1(x))``, ``x = x + MixFFN(LN2(x))``;
- Attn, spatial reduction: ``q = Wq x``; where ``sr > 1``
  ``x' = LN(Conv_{sr x sr, stride sr}(x))`` on the grid, else ``x' = x``;
  ``k, v = Wkv x'``; ``softmax(q k^T / sqrt(64)) v`` per head
  (``ops/attention.py::sdpa_attention``), then ``Wo``;
- MixFFN: ``fc2(GELU(DWConv3x3(fc1(x))))``, fc1 C -> 4C, the depthwise 3x3
  with a bias and padding 1, the exact (erf) GELU;
- the stage's LayerNorm, then back to a map.

The head: ``Linear(C_i -> 768)`` per stage, each resized bilinearly to the
stage-1 grid (``align_corners=False``), concatenated as [c4, c3, c2, c1],
``linear_fuse`` (a 1x1 conv from 3072 to 768 without bias, BatchNorm, ReLU:
a ``BasicConv``, whose BatchNorm the port's folding folds, so that the
folded graph's fuse is a 1x1 conv with bias and ReLU that may take
``conv1x1_gemm``), then ``linear_pred`` (1x1 conv to the classes); the
logits are resized bilinearly to the input's size, as mmseg's
``EncoderDecoder`` does.  Dropout and drop-path do nothing at inference.

Layers are the port's: ``Conv`` (patch embeds, reduction convs, depthwise
convs, the head's 1x1 convs), ``Dense`` (the Linears), ``LayerNormF32``
(float32 statistics and parameters, the result in the input's dtype).
``fold_bn=False`` is the graph with the head's BatchNorm (in eval mode);
``fold_bn=True`` (default) the folded graph.  ``serving_cast``, which
``serving.Predictor`` calls, casts the convs and Linears to bfloat16
(``nn.layers.cast_weights``); the LayerNorms keep float32.  LayerNorm eps is
``layer_norm_eps`` (1e-6) in the blocks and at each stage's end, and
``PLAIN_EPS`` (1e-5) in the patch embeds and the reductions, as mmseg
builds them.  ``int8_serving`` is False: the Predictor refuses ``quant``.

Spans (``utils/profiling.py``): ``segformer.stage1`` .. ``segformer.stage4``
and ``segformer.head``; counters ``segformer.forwards`` (one a forward) and
``segformer.attention_calls`` (one a spatial-reduction attention call, 52
a SegFormer-B5 forward).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.nn.layers import BasicConv, Conv, Dense, LayerNormF32, cast_weights
from egm_unet_torch.ops.attention import sdpa_attention
from egm_unet_torch.utils.profiling import count, span


@dataclasses.dataclass(frozen=True)
class SegFormerConfig:
    """The published lists of a MiT encoder and its head (the Hugging Face
    ``SegformerConfig`` names)."""
    hidden_sizes: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 6, 40, 3)
    num_attention_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    mlp_ratio: int = 4
    decoder_hidden_size: int = 768
    layer_norm_eps: float = 1e-6
    num_labels: int = 2


# nvidia/segformer-b5-finetuned-cityscapes-1024-1024 (mit_b5), 2 classes
SEGFORMER_B5 = SegFormerConfig()
PRESETS = {"segformer_b5": SEGFORMER_B5}

# mmseg builds the patch embeds' and the reduction's norms as a plain
# nn.LayerNorm(dim); the blocks' and the stages' take layer_norm_eps
PLAIN_EPS = 1e-5


def resize_map(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """NHWC bilinear resize with half-pixel centres (``align_corners=False``)
    on the channels-last NCHW view; ``x`` itself where it has that size."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_ch: int, width: int, patch: int, stride: int):
        super().__init__()
        self.proj = Conv(in_ch, width, patch, stride=stride, padding=patch // 2)
        self.norm = LayerNormF32(width, PLAIN_EPS)

    def forward(self, x: torch.Tensor) -> tuple:
        """NHWC map -> (tokens [B, H W, C], (H, W))."""
        y = self.proj(x)
        b, h, w, c = y.shape
        return self.norm(y.reshape(b, h * w, c)), (h, w)


class SpatialReductionAttention(nn.Module):
    def __init__(self, width: int, heads: int, ratio: int):
        super().__init__()
        self.heads, self.ratio = heads, ratio
        self.q = Dense(width, width)
        self.kv = Dense(width, 2 * width)
        if ratio > 1:
            self.sr = Conv(width, width, ratio, stride=ratio)
            self.norm = LayerNormF32(width, PLAIN_EPS)
        self.proj = Dense(width, width)

    def forward(self, x: torch.Tensor, hw: tuple) -> torch.Tensor:
        b, n, c = x.shape
        q = self.q(x)
        if self.ratio > 1:
            x = self.norm(self.sr(x.reshape(b, hw[0], hw[1], c)).reshape(b, -1, c))
        k, v = self.kv(x).chunk(2, dim=-1)
        count("segformer.attention_calls", 1)
        return self.proj(sdpa_attention(q, k, v, self.heads))


class MixFFN(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(width, hidden)
        self.dwconv = Conv(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = Dense(hidden, width)

    def forward(self, x: torch.Tensor, hw: tuple) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.dwconv(self.fc1(x).reshape(b, hw[0], hw[1], -1))
        return self.fc2(F.gelu(h.reshape(b, n, -1)))


class Block(nn.Module):
    def __init__(self, width: int, heads: int, ratio: int, mlp_ratio: int, eps: float):
        super().__init__()
        self.norm1 = LayerNormF32(width, eps)
        self.attn = SpatialReductionAttention(width, heads, ratio)
        self.norm2 = LayerNormF32(width, eps)
        self.mlp = MixFFN(width, mlp_ratio * width)

    def forward(self, x: torch.Tensor, hw: tuple) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp(self.norm2(x), hw)


class SegFormerHead(nn.Module):
    def __init__(self, widths: Sequence[int], dim: int, num_labels: int, fold_bn: bool):
        super().__init__()
        self.linear_c = nn.ModuleList(Dense(c, dim) for c in widths)
        self.linear_fuse = BasicConv(len(widths) * dim, dim, 1, fold_bn=fold_bn)
        self.linear_pred = Conv(dim, num_labels, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Stage maps NHWC, finest first -> logits NHWC on the finest grid."""
        hw = feats[0].shape[1:3]
        fused = torch.cat([resize_map(lin(f), hw)
                           for lin, f in reversed(list(zip(self.linear_c, feats)))], dim=-1)
        return self.linear_pred(self.linear_fuse(fused))


class SegFormer(nn.Module):
    """The encoder's stages as ``patch_embed{i}``, ``block{i}``, ``norm{i}``
    (i = 1..4, mmseg's names) and ``head``."""

    int8_serving = False  # serving.Predictor's quant modes cover the UNets only

    def __init__(self, config: SegFormerConfig = SEGFORMER_B5, fold_bn: bool = True):
        super().__init__()
        self.config = cfg = config
        eps, cin = cfg.layer_norm_eps, 3
        for i, c in enumerate(cfg.hidden_sizes, start=1):
            setattr(self, f"patch_embed{i}", OverlapPatchEmbed(
                cin, c, cfg.patch_sizes[i - 1], cfg.strides[i - 1]))
            setattr(self, f"block{i}", nn.ModuleList(
                Block(c, cfg.num_attention_heads[i - 1], cfg.sr_ratios[i - 1], cfg.mlp_ratio, eps)
                for _ in range(cfg.depths[i - 1])))
            setattr(self, f"norm{i}", LayerNormF32(c, eps))
            cin = c
        self.head = SegFormerHead(cfg.hidden_sizes, cfg.decoder_hidden_size, cfg.num_labels,
                                  fold_bn)

    def serving_cast(self, dtype: torch.dtype) -> "SegFormer":
        """The convs and Linears in ``dtype`` (``cast_weights``); the
        LayerNorms and the head's BatchNorm keep float32."""
        return cast_weights(self, dtype)

    def forward(self, x: torch.Tensor) -> dict:
        count("segformer.forwards", 1)
        feats, y = [], x
        for i in range(1, len(self.config.hidden_sizes) + 1):
            with span(f"segformer.stage{i}"):
                t, hw = getattr(self, f"patch_embed{i}")(y)
                for blk in getattr(self, f"block{i}"):
                    t = blk(t, hw)
                y = getattr(self, f"norm{i}")(t).reshape(t.shape[0], hw[0], hw[1], -1)
                feats.append(y)
        with span("segformer.head"):
            out = resize_map(self.head(feats), x.shape[1:3])
        return {"out": out}
