"""Plain PyTorch reference of CLIPSeg's dense prediction (Lüddecke & Ecker,
arXiv:2112.10003; the rd64 decoder) over a CLIP ViT with correlative
self-attention (CSA: ``softmax(q q^T s) + softmax(k k^T s)`` applied to v) in
every block of the dense pass, as the fusion CLIs run it.

Leaves are named as the port's ``CLIPDensePredT`` names them (kernels stored
[in, out]), so one state dict fits both.  The text tower's leaves are
declared so that the state dict is whole; the reference never runs the
tower: the prompt embeddings are inputs.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class LN(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(w))
        self.bias = nn.Parameter(torch.zeros(w))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, 1e-5)


def heads(x, n):
    b, s, d = x.shape
    return x.reshape(b, s, n, d // n).transpose(1, 2)


def merge(x):
    b, n, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, n * hd)


def attention(q, k, v, n, csa: bool):
    qh, kh, vh = heads(q, n), heads(k, n), heads(v, n)
    s = qh.shape[-1] ** -0.5
    if csa:
        w = (torch.softmax(qh @ qh.transpose(-1, -2) * s, -1)
             + torch.softmax(kh @ kh.transpose(-1, -2) * s, -1))
    else:
        w = torch.softmax(qh @ kh.transpose(-1, -2) * s, -1)
    return merge(w @ vh)


class Block(nn.Module):
    """Pre-LN CLIP block, QuickGELU MLP of width 4w."""

    def __init__(self, w, n_heads):
        super().__init__()
        self.n = n_heads
        self.ln_1, self.ln_2 = LN(w), LN(w)
        self.in_proj, self.out_proj = Linear(w, 3 * w), Linear(w, w)
        self.c_fc, self.c_proj = Linear(w, 4 * w), Linear(4 * w, w)

    def forward(self, x, csa=True):
        q, k, v = self.in_proj(self.ln_1(x)).chunk(3, dim=-1)
        x = x + self.out_proj(attention(q, k, v, self.n, csa))
        h = self.c_fc(self.ln_2(x))
        return x + self.c_proj(h * torch.sigmoid(1.702 * h))


class DecoderLayer(nn.Module):
    """``torch.nn.TransformerEncoderLayer`` at its defaults: post-norm, ReLU,
    feed-forward 2048, no dropout."""

    def __init__(self, d, n_heads, ff=2048):
        super().__init__()
        self.n = n_heads
        self.in_proj, self.out_proj = Linear(d, 3 * d), Linear(d, d)
        self.norm1, self.norm2 = LN(d), LN(d)
        self.linear1, self.linear2 = Linear(d, ff), Linear(ff, d)

    def forward(self, x):
        q, k, v = self.in_proj(x).chunk(3, dim=-1)
        x = self.norm1(x + self.out_proj(attention(q, k, v, self.n, False)))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class Visual(nn.Module):
    def __init__(self, width, layers, patch, resolution, embed_dim):
        super().__init__()
        self.width, self.patch, self.layers = width, patch, layers
        self.conv1 = nn.Module()
        self.conv1.kernel = nn.Parameter(torch.zeros(patch, patch, 3, width))
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros((resolution // patch) ** 2 + 1, width))
        self.ln_pre, self.ln_post = LN(width), LN(width)
        for i in range(layers):
            setattr(self, f"resblock{i}", Block(width, width // 64))
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    def dense(self, x, extract):
        """NHWC image -> the tokens after each block in ``extract``, CSA in
        every block, stopping after the last one asked for."""
        p, w = self.patch, self.width
        b, h, wd, _ = x.shape
        gh, gw = h // p, wd // p
        t = F.conv2d(x.permute(0, 3, 1, 2), self.conv1.kernel.permute(3, 2, 0, 1),
                     stride=p)  # [B, w, gh, gw]
        t = t.flatten(2).transpose(1, 2)
        t = torch.cat([self.class_embedding.expand(b, 1, w), t], dim=1)
        pos = self.positional_embedding
        side = int(math.sqrt(pos.shape[0] - 1))
        if (gh, gw) != (side, side):
            grid = pos[1:].reshape(side, side, w).permute(2, 0, 1)[None]
            grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False)
            pos = torch.cat([pos[:1], grid[0].permute(1, 2, 0).reshape(-1, w)], dim=0)
        t = self.ln_pre(t + pos[None])
        out = []
        for i in range(max(extract) + 1):
            t = getattr(self, f"resblock{i}")(t, csa=True)
            if i in extract:
                out.append(t)
        return out


class CLIPSegReference(nn.Module):
    """CLIPDensePredT(ViT, extract_layers, reduce_dim, 4 decoder heads,
    conditioning at layer 0, the simple transposed conv)."""

    def __init__(self, width=768, layers=12, patch=16, resolution=224, embed_dim=512,
                 text_width=512, text_layers=12, context=248, vocab=49408,
                 extract_layers=(3, 6, 9), reduce_dim=64, n_heads=4):
        super().__init__()
        self.extract = tuple(extract_layers)
        self.clip = nn.Module()
        self.clip.visual = Visual(width, layers, patch, resolution, embed_dim)
        # the text tower's leaves, never run (prompt embeddings are inputs)
        self.clip.token_embedding = nn.Module()
        self.clip.token_embedding.embedding = nn.Parameter(torch.zeros(vocab, text_width))
        self.clip.positional_embedding = nn.Parameter(torch.zeros(context, text_width))
        self.clip.positional_embedding_res = nn.Parameter(torch.zeros(context, text_width))
        for i in range(text_layers):
            setattr(self.clip, f"text_resblock{i}", Block(text_width, text_width // 64))
        self.clip.ln_final = LN(text_width)
        self.clip.text_projection = nn.Parameter(torch.zeros(text_width, embed_dim))
        self.clip.logit_scale = nn.Parameter(torch.zeros(()))
        for i in range(len(self.extract)):
            setattr(self, f"reduce{i}", Linear(width, reduce_dim))
            setattr(self, f"block{i}", DecoderLayer(reduce_dim, n_heads))
        self.film_mul = Linear(embed_dim, reduce_dim)
        self.film_add = Linear(embed_dim, reduce_dim)
        self.trans_conv_kernel = nn.Parameter(torch.zeros(reduce_dim, patch, patch, 1))
        self.trans_conv_bias = nn.Parameter(torch.zeros(1))

    def forward(self, image, cond):
        """``image`` [B, H, W, 3] CLIP-normalised, ``cond`` [B, embed_dim] ->
        logits [B, H, W]."""
        acts = self.clip.visual.dense(image, (0,) + self.extract)[1:]
        a = None
        for i, act in enumerate(acts[::-1]):
            r = getattr(self, f"reduce{i}")(act)
            a = r if a is None else r + a
            if i == 0:
                a = self.film_mul(cond)[:, None] * a + self.film_add(cond)[:, None]
            a = getattr(self, f"block{i}")(a)
        a = a[:, 1:]
        b, n, d = a.shape
        g = int(math.sqrt(n))
        k = self.trans_conv_kernel  # [d, kh, kw, 1]
        y = F.conv_transpose2d(a.transpose(1, 2).reshape(b, d, g, g),
                               k.permute(0, 3, 1, 2), stride=k.shape[1])
        return y[:, 0] + self.trans_conv_bias


def build(state=None, device=None, **kw) -> CLIPSegReference:
    with torch.device(device or "cpu"):
        model = CLIPSegReference(**kw)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model.eval()
