"""Multi-head attention with optional CSA (Correlative Self-Attention), port
of ``egm_unet_tpu/ops/attention.py``.

CSA replaces ``softmax(q k^T)`` with ``softmax(q q^T * scale) +
softmax(k k^T * scale)``.  The sum of two softmaxes is deliberately not
row-stochastic.

Layout: [B, S, D] activations, heads split internally.  Scores and softmax
are float32 whatever the working dtype; the weights are cast to ``v.dtype``
before the last product, whose sums are float32.  This is plain tensor code
(the JAX package computes it outside any Pallas kernel); the fused CSA kernel
lives in ``egm_unet_torch/ops/cuda/csa.py``.
"""

from __future__ import annotations

from typing import Optional

import torch


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * hd)


def _scores(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """float32 ``a b^T * scale`` of working-dtype operands (exact products,
    float32 sums)."""
    return torch.matmul(a.float(), b.float().transpose(-1, -2)) * scale


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, *, csa: bool = False,
                         attn_bias: Optional[torch.Tensor] = None,
                         mult_mask: Optional[tuple] = None,
                         return_weights: bool = False):
    """Attention core on projected q/k/v of shape [B, S, D].

    ``attn_bias``: additive [S, S] mask (e.g. a causal -inf upper triangle)
    on the logits of the standard path; CSA is never combined with it.

    ``mult_mask``: ``(mask_type, mask[B, S-1])`` multiplied into the
    post-softmax weights, the CLIPSeg visual-prompt masking: ``'cls_token'``
    scales the CLS row's attention to the patches, ``'all'`` every other
    query's.
    """
    qh = _split_heads(q, num_heads)
    kh = _split_heads(k, num_heads)
    vh = _split_heads(v, num_heads)
    scale = (q.shape[-1] // num_heads) ** -0.5

    if csa:
        weights = (torch.softmax(_scores(qh, qh, scale), dim=-1)
                   + torch.softmax(_scores(kh, kh, scale), dim=-1))
    else:
        logits = _scores(qh, kh, scale)
        if attn_bias is not None:
            logits = logits + attn_bias
        weights = torch.softmax(logits, dim=-1)

    if mult_mask is not None:
        mask_type, mask = mult_mask  # mask: [B, S-1] over the patch tokens
        m = mask[:, None, None, :].to(weights.dtype)
        factor = torch.ones_like(weights)  # fresh, so the slice update is in place
        if mask_type == "cls_token":
            factor[:, :, 0:1, 1:] *= m
        elif mask_type == "all":
            factor[:, :, 1:, 1:] *= m
        else:
            raise ValueError(f"unknown mult_mask type {mask_type!r}")
        weights = weights * factor

    out = torch.matmul(weights.to(v.dtype), vh)  # float32 sums, v.dtype out
    out = _merge_heads(out)
    if return_weights:
        return out, weights
    return out
