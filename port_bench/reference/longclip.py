"""Plain PyTorch reference of the Long-CLIP fine-tune's loss and gradients
(Zhang et al., *Long-CLIP: Unlocking the Long-Text Capability of CLIP*,
arXiv:2403.15378; github.com/beichenzbc/Long-CLIP), float32, for the
comparison that decides a fine-tune cell's ``correct``.

- Vision: a ViT (patch conv without bias, the CLS token, a learnt
  positional table, pre-LN blocks with a QuickGELU MLP of width 4w, heads of
  64) pooled at the CLS token through ``ln_post`` and ``proj``.  The last
  block attends by correlative self-attention (CSA: ``softmax(q q^T s) +
  softmax(k k^T s)`` applied to v), as the encode path of the reference
  repository's ``clip/`` runs it; the others by an explicit softmax.
- Text: token embeddings plus Long-CLIP's two positional tables, the first
  ``KEEP`` = 20 positions from ``positional_embedding`` and the rest from
  ``positional_embedding_res``; causal pre-LN blocks; ``ln_final``; the
  features of the end-of-text token (the highest id) through
  ``text_projection``.
- Loss: the features L2-normalised; the images' "short" features are the
  centred rows projected onto their top ``pca_dim`` principal directions
  and back (the batch mean added again); ``loss_long + ratio_short *
  loss_short``, each the mean of the image-to-text and text-to-image
  cross-entropies with label smoothing 0.1, scaled by ``exp(logit_scale)``.

Departures from the published description:
- the principal directions come from an SVD of the centred rows; upstream
  takes ``torch.linalg.eig`` of ``X^T X``: the same subspace;
- the loss contrasts the batch given, not a batch gathered over
  data-parallel ranks;
- no resampling of the vision positional table: the images are at the
  configuration's resolution;
- gradients by autograd through the two softmaxes of CSA, computed in
  blocks of rows (``loss_and_grads``): the features of every row without
  autograd, the loss's gradient with respect to them, then each block of
  rows run again with autograd and its features' gradient pushed back
  through it.  The gradients are those of the whole batch's loss.
- the update (``AdamW``): AdamW as Loshchilov and Hutter write it (betas
  0.9 and 0.999, epsilon 1e-8, bias correction, weight decay decoupled
  and scaled by the rate) at the schedule's rate (``schedule``: linear
  warm-up from 0, then a cosine to a hundredth of the peak), over every
  leaf but the frozen ``positional_embedding``; ``logit_scale`` clamped at
  ln 100 after each update, as upstream CLIP clamps it.

Leaves are named as the port's ``CLIP`` names them (kernels stored [in,
out], the patch kernel [p, p, 3, w]), so one state dict fits both.  Nothing
here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.clipseg import LN, Linear, heads, merge

KEEP = 20  # Long-CLIP keeps CLIP's first 20 positions


def attention(q, k, v, n: int, csa: bool = False, causal: bool = False):
    qh, kh, vh = heads(q, n), heads(k, n), heads(v, n)
    s = qh.shape[-1] ** -0.5
    if csa:
        w = (torch.softmax(qh @ qh.transpose(-1, -2) * s, -1)
             + torch.softmax(kh @ kh.transpose(-1, -2) * s, -1))
    else:
        logits = qh @ kh.transpose(-1, -2) * s
        if causal:
            t = logits.shape[-1]
            above = torch.ones(t, t, dtype=torch.bool, device=logits.device).triu(1)
            logits = logits.masked_fill(above, float("-inf"))
        w = torch.softmax(logits, -1)
    return merge(w @ vh)


class Block(nn.Module):
    """Pre-LN CLIP block, QuickGELU MLP of width 4w, heads of 64."""

    def __init__(self, w: int, n_heads: int):
        super().__init__()
        self.n = n_heads
        self.ln_1, self.ln_2 = LN(w), LN(w)
        self.in_proj, self.out_proj = Linear(w, 3 * w), Linear(w, w)
        self.c_fc, self.c_proj = Linear(w, 4 * w), Linear(4 * w, w)

    def forward(self, x, csa: bool = False, causal: bool = False):
        q, k, v = self.in_proj(self.ln_1(x)).chunk(3, dim=-1)
        x = x + self.out_proj(attention(q, k, v, self.n, csa, causal))
        h = self.c_fc(self.ln_2(x))
        return x + self.c_proj(h * torch.sigmoid(1.702 * h))


class LongCLIPReference(nn.Module):
    def __init__(self, embed_dim=768, resolution=224, vision_layers=24, vision_width=1024,
                 patch=14, context=248, vocab=49408, text_width=768, text_heads=12,
                 text_layers=12):
        super().__init__()
        v = self.visual = nn.Module()
        v.conv1 = nn.Module()
        v.conv1.kernel = nn.Parameter(torch.zeros(patch, patch, 3, vision_width))
        v.class_embedding = nn.Parameter(torch.zeros(vision_width))
        v.positional_embedding = nn.Parameter(
            torch.zeros((resolution // patch) ** 2 + 1, vision_width))
        v.ln_pre, v.ln_post = LN(vision_width), LN(vision_width)
        for i in range(vision_layers):
            setattr(v, f"resblock{i}", Block(vision_width, vision_width // 64))
        v.proj = nn.Parameter(torch.zeros(vision_width, embed_dim))
        self.token_embedding = nn.Module()
        self.token_embedding.embedding = nn.Parameter(torch.zeros(vocab, text_width))
        self.positional_embedding = nn.Parameter(torch.zeros(context, text_width))
        self.positional_embedding_res = nn.Parameter(torch.zeros(context, text_width))
        for i in range(text_layers):
            setattr(self, f"text_resblock{i}", Block(text_width, text_heads))
        self.ln_final = LN(text_width)
        self.text_projection = nn.Parameter(torch.zeros(text_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))
        self.patch, self.vision_layers, self.text_layers = patch, vision_layers, text_layers

    def encode_image(self, x):
        """``x`` [B, H, W, 3] CLIP-normalised -> [B, embed_dim]."""
        v, p = self.visual, self.patch
        t = F.conv2d(x.permute(0, 3, 1, 2), v.conv1.kernel.permute(3, 2, 0, 1), stride=p)
        t = t.flatten(2).transpose(1, 2)
        t = torch.cat([v.class_embedding.expand(t.shape[0], 1, -1), t], dim=1)
        t = v.ln_pre(t + v.positional_embedding[None])
        for i in range(self.vision_layers):
            t = getattr(v, f"resblock{i}")(t, csa=i == self.vision_layers - 1)
        return v.ln_post(t[:, 0]) @ v.proj

    def encode_text(self, ids):
        """``ids`` [B, context] token ids, EOT the highest -> [B, embed_dim]."""
        pos = torch.cat([self.positional_embedding[:KEEP],
                         self.positional_embedding_res[KEEP:]], dim=0)
        x = self.token_embedding.embedding[ids.long()] + pos[None]
        for i in range(self.text_layers):
            x = getattr(self, f"text_resblock{i}")(x, causal=True)
        x = self.ln_final(x)
        return x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)] @ self.text_projection


def pca(x, dim: int):
    """The centred rows of ``x`` on their top ``dim`` principal directions and
    back, plus the mean; and the singular values of the centred rows."""
    mean = x.mean(dim=0, keepdim=True)
    xc = x - mean
    _, sv, vh = torch.linalg.svd(xc, full_matrices=False)
    pc = vh[:dim].T
    return xc @ pc @ pc.T + mean, sv


def contrastive_loss(img, txt_long, txt_short, logit_scale, pca_dim: int = 32,
                     ratio_short: float = 0.1, smoothing: float = 0.1):
    """``(loss, singular values of the centred normalised image features)``."""
    img, txt_long, txt_short = (F.normalize(t, dim=1) for t in (img, txt_long, txt_short))
    img_short, sv = pca(img, pca_dim)
    scale = logit_scale.exp()
    target = torch.arange(img.shape[0], device=img.device)

    def both_ways(a, b):
        sim = scale * a @ b.T
        return (F.cross_entropy(sim, target, label_smoothing=smoothing)
                + F.cross_entropy(sim.T, target, label_smoothing=smoothing)) / 2

    return both_ways(img, txt_long) + ratio_short * both_ways(img_short, txt_short), sv


def features(model, image, text_long, text_short):
    return model.encode_image(image), model.encode_text(text_long), model.encode_text(text_short)


def loss_and_grads(model: LongCLIPReference, image, text_long, text_short, block: int,
                   pca_dim: int = 32, ratio_short: float = 0.1
                   ) -> Tuple[float, Dict[str, torch.Tensor], torch.Tensor]:
    """The batch's loss, every leaf's gradient (name -> tensor) and the
    singular values of the PCA's centred rows, ``block`` rows at a time."""
    rows = range(0, image.shape[0], block)
    cut = lambda t, s: t[s:s + block]  # noqa: E731
    with torch.no_grad():
        parts = [features(model, cut(image, s), cut(text_long, s), cut(text_short, s))
                 for s in rows]
    feats = [torch.cat(f).requires_grad_(True) for f in zip(*parts)]
    model.zero_grad(set_to_none=True)
    loss, sv = contrastive_loss(*feats, model.logit_scale, pca_dim, ratio_short)
    loss.backward()  # the features' gradients, and logit_scale's
    for s in rows:
        out = features(model, cut(image, s), cut(text_long, s), cut(text_short, s))
        torch.autograd.backward(out, [cut(f.grad, s) for f in feats])
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(loss.detach()), grads, sv.detach()


def schedule(step: int, lr: float, warmup_steps: int, total_steps: int) -> float:
    """The rate of update ``step`` (0 first): 0 -> ``lr`` linearly over
    ``warmup_steps``, then a cosine to ``lr / 100`` at ``total_steps``."""
    if step < warmup_steps:
        return lr * step / warmup_steps
    done = min(step - warmup_steps, total_steps - warmup_steps) / (total_steps - warmup_steps)
    return lr * (0.01 + 0.99 * 0.5 * (1 + math.cos(math.pi * done)))


class AdamW:
    """AdamW over ``params`` (name -> float32 tensor, updated in place):
    each step decays a leaf, then moves it by the rate times the
    bias-corrected first moment over the root of the second plus epsilon.
    ``moved`` holds each leaf's sum of the updates as computed, in float64,
    before they are rounded into the float32 leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.wd, self.betas, self.eps, self.t = params, weight_decay, betas, eps, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.moved = {n: torch.zeros_like(p, dtype=torch.float64) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        b1, b2 = self.betas
        self.t += 1
        for n, p in self.params.items():
            g = grads[n]
            self.m[n] = b1 * self.m[n] + (1 - b1) * g
            self.v[n] = b2 * self.v[n] + (1 - b2) * g * g
            m_hat = self.m[n] / (1 - b1 ** self.t)
            v_hat = self.v[n] / (1 - b2 ** self.t)
            decay, upd = -lr * self.wd * p, -lr * m_hat / (v_hat.sqrt() + self.eps)
            self.moved[n] += decay.double() + upd.double()
            p.mul_(1 - lr * self.wd)  # the decay, then the step: two roundings
            p += upd
            if n == "logit_scale":
                p.clamp_(max=math.log(100.0))


def build(state=None, device=None, **kw) -> LongCLIPReference:
    with torch.device(device or "cpu"):
        model = LongCLIPReference(**kw)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model
