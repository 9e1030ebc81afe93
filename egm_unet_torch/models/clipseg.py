"""CLIPSeg dense prediction head, port of ``egm_unet_tpu/models/clipseg.py``.

``CLIPDensePredT``: the frozen CLIP ViT run densely with CSA attention,
activations extracted at layers (3, 6, 9), reduced 768 -> ``reduce_dim``,
accumulated in reverse, FiLM-conditioned on the text embedding at layer 0,
refined by torch-style TransformerEncoderLayers, and upsampled to pixels by a
transposed conv whose stride equals its kernel (a per-token matmul and a
pixel shuffle, ``ops.conv.conv_transpose2d_nonoverlap``).

The CLIP tower runs under ``torch.no_grad()``: it is frozen.  The decoder
needs block 0 and the extracted layers only, so without ``return_features``
the dense pass stops after the last extracted block (the JAX package gets the
same from dead-code elimination under ``jit``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.models.clip.model import CLIP, VIT_B16, CLIPConfig
from egm_unet_torch.nn.layers import CoreConv, Dense, LayerNorm, uniform_
from egm_unet_torch.ops.attention import multi_head_attention
from egm_unet_torch.ops.conv import conv_transpose2d_nonoverlap


def sample_prompts(words, prompt_list, rng=None):
    """A random template per word."""
    rng = rng or np.random.default_rng()
    idx = rng.integers(0, len(prompt_list), size=len(words))
    return [prompt_list[i].format(w) for i, w in zip(idx, words)]


def get_prompt_list(prompt: str):
    if prompt == "plain":
        return ["{}"]
    if prompt == "fixed":
        return ["a photo of a {}."]
    if prompt == "shuffle":
        return ["a photo of a {}.", "a photograph of a {}.", "an image of a {}.", "{}."]
    if prompt == "shuffle+":
        return ["a photo of a {}.", "a photograph of a {}.", "an image of a {}.", "{}.",
                "a cropped photo of a {}.", "a good photo of a {}.",
                "a photo of one {}.", "a bad photo of a {}.", "a photo of the {}."]
    raise ValueError(f"unknown prompt mode {prompt!r}")


class TorchEncoderLayer(nn.Module):
    """``torch.nn.TransformerEncoderLayer`` defaults (post-norm, ReLU,
    ``dim_feedforward=2048``, no dropout at inference) written from ``Dense``
    layers so that the names match the flax tree."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048):
        super().__init__()
        self.nhead = nhead
        self.in_proj = Dense(d_model, 3 * d_model)
        self.out_proj = Dense(d_model, d_model)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.in_proj(x).chunk(3, dim=-1)
        attn = self.out_proj(multi_head_attention(q, k, v, self.nhead))
        x = self.norm1(x + attn)
        h = self.linear2(F.relu(self.linear1(x)))
        return self.norm2(x + h)


def _is_tokens(cond: torch.Tensor) -> bool:
    return not cond.is_floating_point()


class CLIPDensePredT(nn.Module):
    """FiLM-conditioned dense decoder over a frozen CLIP ViT."""

    def __init__(self, clip_cfg: CLIPConfig = VIT_B16,
                 extract_layers: Tuple[int, ...] = (3, 6, 9), cond_layer: int = 0,
                 reduce_dim: int = 64, n_heads: int = 4, prompt: str = "fixed",
                 extra_blocks: int = 0, rev_activations: bool = False,
                 complex_trans_conv: bool = False):
        super().__init__()
        self.clip_cfg = clip_cfg
        self.extract_layers = tuple(extract_layers)
        self.cond_layer = cond_layer
        self.reduce_dim = reduce_dim
        self.prompt = prompt
        self.extra_blocks = extra_blocks
        self.rev_activations = rev_activations
        self.complex_trans_conv = complex_trans_conv
        self.clip = CLIP(clip_cfg)
        depth = len(self.extract_layers)
        for i in range(depth):
            setattr(self, f"reduce{i}", Dense(clip_cfg.vision_width, reduce_dim))
            setattr(self, f"block{i}", TorchEncoderLayer(reduce_dim, n_heads))
        for i in range(extra_blocks):
            setattr(self, f"extra{i}", TorchEncoderLayer(reduce_dim, n_heads))
        self.film_mul = Dense(clip_cfg.embed_dim, reduce_dim)
        self.film_add = Dense(clip_cfg.embed_dim, reduce_dim)
        ks = {32: 32, 16: 16}[clip_cfg.vision_patch_size]
        if not complex_trans_conv:
            self.trans_conv_kernel = nn.Parameter(torch.zeros(reduce_dim, ks, ks, 1))
            self.trans_conv_bias = nn.Parameter(torch.zeros(1))
        else:
            tk = ks // 4
            self.tc_conv = CoreConv(reduce_dim, reduce_dim, 3, padding=1)
            self.tc_k1 = nn.Parameter(torch.zeros(reduce_dim, tk, tk, reduce_dim // 2))
            self.tc_b1 = nn.Parameter(torch.zeros(reduce_dim // 2))
            self.tc_k2 = nn.Parameter(torch.zeros(reduce_dim // 2, tk, tk, 1))
            self.tc_b2 = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        names = (("tc_k1", "tc_k2") if self.complex_trans_conv
                 else ("trans_conv_kernel",))
        for name in names:
            p = getattr(self, name)
            uniform_(p, 1.0 / math.sqrt(p.shape[0]), generator)

    def compute_conditional(self, tokens: torch.Tensor) -> torch.Tensor:
        """Text conditioning: Long-CLIP ``encode_text`` on pre-tokenized
        [N, context_length] ids (tokenization is host code, see
        ``models.clip.tokenizer.tokenize``)."""
        with torch.no_grad():
            return self.clip.encode_text(tokens)

    def _head(self, a: torch.Tensor) -> torch.Tensor:
        """[B, 1 + n, d] decoder tokens -> float32 logits [B, H, W, 1]."""
        a = a[:, 1:, :]  # strip CLS
        bs, n_tok, d = a.shape
        size = int(math.sqrt(n_tok))
        a = a.reshape(bs, size, size, d)
        if not self.complex_trans_conv:
            a = conv_transpose2d_nonoverlap(a, self.trans_conv_kernel) + self.trans_conv_bias
        else:
            a = F.relu(self.tc_conv(a.to(self.tc_conv.kernel.dtype)))
            a = F.relu(conv_transpose2d_nonoverlap(a, self.tc_k1) + self.tc_b1)
            a = conv_transpose2d_nonoverlap(a, self.tc_k2) + self.tc_b2
        return a.float()

    def forward(self, image: torch.Tensor, cond: torch.Tensor,
                return_features: bool = False):
        """``image``: [B, H, W, 3] (CLIP-normalized); ``cond``: [B, embed_dim]
        embeddings or [B, context_length] integer tokens."""
        if _is_tokens(cond):
            cond = self.compute_conditional(cond)

        with torch.no_grad():
            visual_q, activations = self.clip.visual_forward_dense(
                image, extract_layers=[0] + list(self.extract_layers),
                pooled=return_features)
        activation1, activations = activations[0], activations[1:]
        ordered = activations if self.rev_activations else activations[::-1]

        a = None
        for i, act in enumerate(ordered):
            r = getattr(self, f"reduce{i}")(act)
            a = r if a is None else r + a
            if i == self.cond_layer:
                a = (self.film_mul(cond)[:, None, :] * a
                     + self.film_add(cond)[:, None, :])
            a = getattr(self, f"block{i}")(a)
        for i in range(self.extra_blocks):
            a = a + getattr(self, f"extra{i}")(a)

        logits = self._head(a)
        if return_features:
            return logits, visual_q, cond, [activation1] + activations
        return (logits,)

    def visual_forward_masked(self, img_s, seg_s):
        """Pooled embedding of a support image under a visual-prompt attention
        mask (type ``'cls_token'``, applied in every block)."""
        with torch.no_grad():
            return self.clip.visual(img_s, csa=True, dense=True,
                                    mask=("cls_token", seg_s))


class CLIPDensePredTMasked(CLIPDensePredT):
    """One-shot variant: the conditioning comes from a masked support image
    instead of text."""

    def forward(self, img_q, cond_or_img_s, seg_s=None, return_features=False):
        if seg_s is not None:
            cond = self.visual_forward_masked(cond_or_img_s, seg_s)
        else:
            cond = cond_or_img_s
        return super().forward(img_q, cond, return_features=return_features)


class CLIPDenseBaseline(nn.Module):
    """Single-extract-layer baseline: reduce -> FiLM -> reduce2 MLP ->
    trans_conv, no transformer decoder blocks."""

    def __init__(self, clip_cfg: CLIPConfig = VIT_B16, extract_layer: int = 9,
                 reduce_dim: int = 128, reduce2_dim: int = 64):
        super().__init__()
        self.clip_cfg = clip_cfg
        self.extract_layer = extract_layer
        self.clip = CLIP(clip_cfg)
        self.reduce = Dense(clip_cfg.vision_width, reduce_dim)
        self.reduce2a = Dense(reduce_dim, reduce2_dim)
        self.reduce2b = Dense(reduce2_dim, reduce_dim)
        self.film_mul = Dense(clip_cfg.embed_dim, reduce_dim)
        self.film_add = Dense(clip_cfg.embed_dim, reduce_dim)
        ks = {32: 32, 16: 16}[clip_cfg.vision_patch_size]
        self.trans_conv_kernel = nn.Parameter(torch.zeros(reduce_dim, ks, ks, 1))
        self.trans_conv_bias = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        p = self.trans_conv_kernel
        uniform_(p, 1.0 / math.sqrt(p.shape[0]), generator)

    def forward(self, image, cond, return_features: bool = False):
        with torch.no_grad():
            if _is_tokens(cond):
                cond = self.clip.encode_text(cond)
            visual_q, activations = self.clip.visual_forward_dense(
                image, extract_layers=[self.extract_layer], pooled=return_features)
        a = self.reduce(activations[0])
        a = self.film_mul(cond)[:, None, :] * a + self.film_add(cond)[:, None, :]
        a = self.reduce2b(F.relu(self.reduce2a(a)))
        a = a[:, 1:, :]
        bs, n_tok, d = a.shape
        size = int(math.sqrt(n_tok))
        a = a.reshape(bs, size, size, d)
        logits = (conv_transpose2d_nonoverlap(a, self.trans_conv_kernel)
                  + self.trans_conv_bias).float()
        if return_features:
            return logits, visual_q, cond, activations
        return (logits,)


# Pascal-VOC classes
PASCAL_VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def clipseg_multilabel(model: CLIPDensePredT, image: torch.Tensor,
                       class_conds: torch.Tensor,
                       background_factor: float = 3.0) -> torch.Tensor:
    """Pascal-VOC multi-class wrapper: per-class sigmoid maps on a -10 base,
    the background scaled by ``background_factor``.

    ``class_conds``: [21, embed_dim] class-name embeddings (or [21, ctx]
    tokens).  Returns [B, H, W, 21]."""
    bs = image.shape[0]
    maps = []
    for class_id in range(class_conds.shape[0]):
        cond = class_conds[class_id][None].expand(bs, class_conds.shape[1])
        (logits,) = model(image, cond)
        fac = background_factor if class_id == 0 else 1.0
        maps.append(torch.sigmoid(logits[..., 0]) * fac)
    return torch.stack(maps, dim=-1) - 10.0
