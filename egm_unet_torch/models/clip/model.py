"""CLIP (Long-CLIP text tower; ViT with CSA, or the ModifiedResNet of
``models/clip/resnet.py`` for a tuple ``vision_layers``), port of
``egm_unet_tpu/models/clip/model.py``.

Activations are [B, S, D] and images NHWC, as in the JAX package.  Module and
parameter names mirror the flax tree (``resblock3.in_proj.kernel``,
``ln_1.scale``, ...) so ``utils/from_flax.py`` maps one onto the other.

Compute dtype: the ``Dense`` and patch-conv weights carry it
(``nn.layers.cast_weights``).  LayerNorm runs in float32 with float32
parameters whatever the compute dtype, and the embeddings, positional tables
and the two output projections stay float32 and are applied in float32 or
cast where they are used, as the JAX modules do.  ``model.to(torch.bfloat16)``
would round those parameters too; ``LayerNormF32`` raises on it.

CSA attention goes through ``ops.cuda.csa.csa_attention``: the CUDA kernel for
CUDA tensors, its plain version for CPU tensors.  Attention that returns its
weights or carries a multiplicative mask goes through
``ops.attention.multi_head_attention``.

Recomputation (``CLIPConfig.recompute``, set by ``RN50X64`` alone): the
ModifiedResNet's Bottlenecks and the text tower's blocks keep only their
inputs for backward and run again there (``recomputed``); each re-run is
the span ``longclip.recompute`` and counts one
``longclip.recomputed_blocks`` (``utils/profiling``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from egm_unet_torch.nn.layers import CoreConv, Dense, LayerNormF32, remat
from egm_unet_torch.ops.attention import multi_head_attention
from egm_unet_torch.ops.cuda.csa import csa_attention
from egm_unet_torch.ops.resize import resize_bicubic, resize_nearest
from egm_unet_torch.utils.profiling import count, span

KEEP_LEN = 20  # Long-CLIP keeps the first 20 positions verbatim


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12  # or per-stage block counts: the RN tower
    vision_width: int = 768
    vision_patch_size: int = 16
    context_length: int = 248  # Long-CLIP default
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    long_clip: bool = True  # dual positional embeddings
    # the ModifiedResNet's Bottlenecks and the text blocks run again in
    # backward from their inputs (``recomputed``); set by RN50X64 alone
    recompute: bool = False

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64


def is_resnet(cfg: CLIPConfig) -> bool:
    """A tuple ``vision_layers`` (per-stage block counts) means the
    ModifiedResNet tower."""
    return isinstance(cfg.vision_layers, (tuple, list))


VIT_B16 = CLIPConfig()
VIT_B32 = dataclasses.replace(VIT_B16, vision_patch_size=32)
# Long-CLIP-L (Zhang et al., arXiv:2403.15378; checkpoint LongCLIP-L): ViT-L/14
# at 224 px (24 blocks of width 1024, 16 heads of 64) and a text tower of 12
# blocks of width 768 (12 heads) over 248 positions, embed_dim 768
LONGCLIP_L14 = CLIPConfig(embed_dim=768, image_resolution=224, vision_layers=24,
                          vision_width=1024, vision_patch_size=14, context_length=248,
                          vocab_size=49408, transformer_width=768, transformer_heads=12,
                          transformer_layers=12, long_clip=True)
# OpenAI CLIP RN50x64 (Radford et al., arXiv:2103.00020; clip/model.py
# ModifiedResNet) at 448 px: Bottlenecks (3, 15, 36, 10) at width 128, an
# attention pool of 64 heads over 14^2 + 1 tokens of width 4096; a text tower
# of 12 blocks of width 1024 (16 heads) stretched to Long-CLIP's 248
# positions; embed_dim 1024.  Both towers' blocks are recomputed: 48 triples
# a step peak at 50.8 GB on an 80 GB H100 (73.9 with the Bottlenecks alone,
# where the allocator runs at the card's edge and the rate spreads; ~173 GB
# of saved activations with neither)
RN50X64 = CLIPConfig(embed_dim=1024, image_resolution=448, vision_layers=(3, 15, 36, 10),
                     vision_width=128, vision_patch_size=0, context_length=248,
                     vocab_size=49408, transformer_width=1024, transformer_heads=16,
                     transformer_layers=12, long_clip=True, recompute=True)
PRESETS = {"vit_b16": VIT_B16, "longclip_l14": LONGCLIP_L14, "rn50x64": RN50X64}


def preset_of(cfg: CLIPConfig) -> CLIPConfig:
    """The preset with ``cfg``'s widths, which carries what a checkpoint's
    shapes cannot say (``recompute``); ``cfg`` itself where none has them."""
    for preset in PRESETS.values():
        if dataclasses.replace(preset, recompute=cfg.recompute) == cfg:
            return preset
    return cfg


def recomputed(block: nn.Module, *args, **kwargs):
    """``block(*args, **kwargs)`` through ``nn.layers.remat`` (non-reentrant
    ``torch.utils.checkpoint``; a plain call when autograd is off): only the
    inputs are kept, and backward runs the block again, as the span
    ``longclip.recompute``, counting one ``longclip.recomputed_blocks``."""
    runs = []

    def run(*a, **k):
        if not runs:  # the forward; a later call is the re-run in backward
            runs.append(True)
            return block(*a, **k)
        count("longclip.recomputed_blocks", 1)
        with span("longclip.recompute"):
            return block(*a, **k)

    return remat(block, run, *args, **kwargs)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with one fused ``in_proj`` split in three
    along the last axis.  ``parallel.shard_clip`` makes it tensor parallel:
    its projections become Megatron shards and ``heads`` this rank's local
    heads, whose q, k and v are the ``chunk`` views of the local
    ``in_proj`` output (CSA's kernel K6 takes them as they are)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNormF32(width)
        self.in_proj = Dense(width, 3 * width)
        self.out_proj = Dense(width, width)
        self.ln_2 = LayerNormF32(width)
        self.c_fc = Dense(width, 4 * width)
        self.c_proj = Dense(4 * width, width)
        self.gelu = QuickGELU()

    def forward(self, x, attn_bias=None, csa: bool = False,
                return_weights: bool = False, mult_mask=None):
        q, k, v = self.in_proj(self.ln_1(x)).chunk(3, dim=-1)
        weights = None
        if csa and not return_weights and mult_mask is None:
            attn = csa_attention(q, k, v, self.heads)  # views of in_proj's output
        else:
            attn = multi_head_attention(q, k, v, self.heads, csa=csa,
                                        attn_bias=attn_bias, mult_mask=mult_mask,
                                        return_weights=return_weights)
            if return_weights:
                attn, weights = attn
        x = x + self.out_proj(attn)
        x = x + self.c_proj(self.gelu(self.c_fc(self.ln_2(x))))
        if return_weights:
            return x, weights
        return x


class VisionTransformer(nn.Module):
    """ViT with CSA in the last block (encode path) or in every block (dense
    path)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.vision_width, cfg.vision_patch_size
        self.conv1 = CoreConv(3, w, p, stride=p, use_bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        n_pos = (cfg.image_resolution // p) ** 2 + 1
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, w))
        self.ln_pre = LayerNormF32(w)
        for i in range(cfg.vision_layers):
            setattr(self, f"resblock{i}", ResidualAttentionBlock(w, cfg.vision_heads))
        self.ln_post = LayerNormF32(w)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.cfg.vision_width ** -0.5
        normal_(self.class_embedding, std, generator)
        normal_(self.positional_embedding, std, generator)
        normal_(self.proj, std, generator)

    def _pos_embedding(self, n_tokens: int, grid_hw: Tuple[int, int]) -> torch.Tensor:
        """The positional table, its patch grid resampled (bicubic, half-pixel
        centres) for inputs of another resolution."""
        pos = self.positional_embedding
        n = pos.shape[0] - 1
        if n_tokens == n:
            return pos
        side = int(math.sqrt(n))
        grid = resize_bicubic(pos[1:].reshape(side, side, -1), grid_hw,
                              align_corners=False)
        return torch.cat([pos[:1], grid.reshape(-1, pos.shape[-1])], dim=0)

    def forward(self, x, *, csa: bool = True, extract_layers: Sequence[int] = (),
                return_all: bool = False, dense: bool = False, mask=None,
                return_affinities: bool = False, pooled: bool = True):
        """``x``: NHWC image.  ``mask``: ``(mask_type, seg[B, h, w])``, the
        visual-prompt attention mask.  With ``pooled=False`` (and layers to
        extract) the pass stops after the last extracted block and returns
        None for the pooled embedding."""
        cfg = self.cfg
        p = cfg.vision_patch_size
        b, h, w, _ = x.shape
        grid_hw = (h // p, w // p)
        extract_layers = tuple(extract_layers)

        patches = self.conv1(x.to(self.conv1.kernel.dtype))
        tokens = patches.reshape(b, grid_hw[0] * grid_hw[1], cfg.vision_width)
        cls = self.class_embedding.to(tokens.dtype).expand(b, 1, cfg.vision_width)
        tokens = torch.cat([cls, tokens], dim=1)
        pos = self._pos_embedding(tokens.shape[1] - 1, grid_hw)
        tokens = self.ln_pre(tokens + pos.to(tokens.dtype)[None])

        mult_mask = None
        if mask is not None:
            # the visual-prompt seg at the patch grid, nearest as torch's
            # F.interpolate default
            mask_type, seg = mask
            seg = resize_nearest(seg.float()[..., None], grid_hw, mode="torch")
            mult_mask = (mask_type, seg.reshape(b, grid_hw[0] * grid_hw[1]))

        activations, affinities = [], []
        n_layers = cfg.vision_layers
        if extract_layers and not pooled:
            n_layers = max(extract_layers) + 1
        for i in range(n_layers):
            use_csa = csa and (dense or i == cfg.vision_layers - 1)
            want_aff = return_affinities and i in extract_layers
            out = getattr(self, f"resblock{i}")(tokens, csa=use_csa,
                                                mult_mask=mult_mask,
                                                return_weights=want_aff)
            if want_aff:
                tokens, aff = out
                affinities.append(aff)  # [B, heads, S, S]
            else:
                tokens = out
            if i in extract_layers:
                activations.append(tokens)

        emb = None
        if pooled or not extract_layers:
            emb = self.ln_post(tokens if return_all else tokens[:, 0, :])
            emb = torch.matmul(emb.float(), self.proj.float()).to(tokens.dtype)

        if extract_layers and return_affinities:
            return emb, activations, affinities
        if extract_layers:
            return emb, activations
        return emb


class Embed(nn.Module):
    """Embedding table ``embedding`` [vocab, width], float32 lookups."""

    def __init__(self, vocab: int, width: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(vocab, width))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.embedding, 0.02, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding)


class CLIP(nn.Module):
    """Dual-tower CLIP with the Long-CLIP text side (two positional tables)."""

    def __init__(self, cfg: CLIPConfig = VIT_B16):
        super().__init__()
        self.cfg = cfg
        if is_resnet(cfg):
            # RN checkpoints ("RN50", ...) carry per-stage block counts
            from egm_unet_torch.models.clip.resnet import ModifiedResNet

            self.visual = ModifiedResNet(
                cfg.vision_layers, output_dim=cfg.embed_dim,
                heads=cfg.vision_width * 32 // 64,
                input_resolution=cfg.image_resolution, width=cfg.vision_width,
                recompute=cfg.recompute)
        else:
            self.visual = VisionTransformer(cfg)
        tw = cfg.transformer_width
        self.token_embedding = Embed(cfg.vocab_size, tw)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, tw))
        if cfg.long_clip:
            self.positional_embedding_res = nn.Parameter(
                torch.zeros(cfg.context_length, tw))
        for i in range(cfg.transformer_layers):
            setattr(self, f"text_resblock{i}",
                    ResidualAttentionBlock(tw, cfg.transformer_heads))
        self.ln_final = LayerNormF32(tw)
        self.text_projection = nn.Parameter(torch.zeros(tw, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.positional_embedding, 0.01, generator)
        if self.cfg.long_clip:
            normal_(self.positional_embedding_res, 0.01, generator)
        normal_(self.text_projection, self.cfg.transformer_width ** -0.5, generator)
        with torch.no_grad():
            self.logit_scale.fill_(math.log(1 / 0.07))

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype, carried by the matmul and conv weights."""
        if is_resnet(self.cfg):
            return self.visual.stem_conv1.kernel.dtype
        return self.visual.conv1.kernel.dtype

    def _text_pos(self) -> torch.Tensor:
        if not self.cfg.long_clip:
            return self.positional_embedding
        return torch.cat([self.positional_embedding[:KEEP_LEN],
                          self.positional_embedding_res[KEEP_LEN:]], dim=0)

    def _causal_bias(self, device) -> torch.Tensor:
        n = self.cfg.context_length
        return torch.triu(torch.full((n, n), float("-inf"), device=device),
                          diagonal=1)

    def encode_text(self, text: torch.Tensor, pool: bool = True) -> torch.Tensor:
        """``text``: [N, context_length] token ids."""
        dtype = self.dtype
        x = self.token_embedding(text).to(dtype)
        x = x + self._text_pos().to(dtype)[None]
        bias = self._causal_bias(x.device)
        for i in range(self.cfg.transformer_layers):
            block = getattr(self, f"text_resblock{i}")
            if self.cfg.recompute:
                x = recomputed(block, x, attn_bias=bias)
            else:
                x = block(x, attn_bias=bias)
        x = self.ln_final(x)
        if not pool:
            return x
        eot = text.argmax(dim=-1)  # EOT has the highest token id
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return torch.matmul(pooled.float(), self.text_projection.float()).to(dtype)

    def encode_image(self, image, csa: bool = True, return_all: bool = False):
        return self.visual(image, csa=csa, return_all=return_all)

    def visual_forward_dense(self, image, extract_layers: Sequence[int],
                             pooled: bool = True):
        """Dense ViT pass with per-layer activation extraction and CSA in
        every block, the CLIPSeg encoder contract."""
        if is_resnet(self.cfg):
            raise ValueError("dense extraction requires a ViT tower; the "
                             "ModifiedResNet tower has no CSA/dense path")
        return self.visual(image, csa=True, dense=True,
                           extract_layers=extract_layers, pooled=pooled)

    def forward(self, image, text):
        """Contrastive logits ``(logits_per_image, logits_per_text)``."""
        img = self.encode_image(image)
        txt = self.encode_text(text)
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
        scale = torch.exp(self.logit_scale)
        logits_per_image = scale * img @ txt.T
        return logits_per_image, logits_per_image.T


def get_attn(clip_module: CLIP, image, layer: str = "final", csa: bool = True):
    """Attention maps for visualisation: ``'final'`` returns the last block's
    (optionally CSA) attention, ``'all'`` every layer's.  Both run standard
    attention in the blocks before the last, the encode-path convention."""
    if layer not in ("final", "all"):
        raise ValueError("layer should be final or all")
    n = clip_module.cfg.vision_layers
    layers = [n - 1] if layer == "final" else list(range(n))
    _, _, affinities = clip_module.visual(image, csa=csa, dense=False,
                                          extract_layers=layers,
                                          return_affinities=True)
    return affinities if layer == "all" else affinities[0]


def stretch_positional_embedding(pe: np.ndarray, keep_len: int = KEEP_LEN) -> np.ndarray:
    """Long-CLIP's knowledge-preserving stretch 77 -> 4*77 - 3*keep_len = 248:
    keep the first ``keep_len`` positions, interpolate the rest linearly four
    times denser, extrapolate the tail linearly."""
    length, dim = pe.shape
    out = np.zeros((4 * length - 3 * keep_len, dim), pe.dtype)
    out[:keep_len] = pe[:keep_len]
    for i in range(length - 1 - keep_len):
        out[4 * i + keep_len] = pe[i + keep_len]
        out[4 * i + 1 + keep_len] = 3 * pe[i + keep_len] / 4 + pe[i + 1 + keep_len] / 4
        out[4 * i + 2 + keep_len] = 2 * pe[i + keep_len] / 4 + 2 * pe[i + 1 + keep_len] / 4
        out[4 * i + 3 + keep_len] = pe[i + keep_len] / 4 + 3 * pe[i + 1 + keep_len] / 4
    d = pe[length - 1] - pe[length - 2]
    base = 4 * length - 3 * keep_len
    for j in range(4):
        out[base - 4 + j] = pe[length - 1] + j * d / 4
    return out
