"""Plain PyTorch reference of SegFormer (Xie et al., arXiv:2105.15203;
github.com/NVlabs/SegFormer ``mmseg/models/backbones/mix_transformer.py``
and ``mmseg/models/decode_heads/segformer_head.py``): the MiT encoder and
the all-MLP head, with the head's BatchNorm unfolded and applied here from
its running statistics.

Written from the published description, in the form the port's BatchNorm
graph names its leaves, so that one state dict fits both; nothing here
imports the program.  Float32 by default (the driver turns TF32 off).
``build(..., dtype=torch.bfloat16)`` is the same network computing in
bfloat16 as a deployment would: the convolutions' and Linears' weights and
the activations in bfloat16, each LayerNorm and the BatchNorm normalising in
float32 with float32 parameters and rounding its output, the attention's
scores summed in float32 and their softmax rounded before the product with
the values.  ``low_precision(dtype)`` rounds every convolution's and
Linear's input and weight to a lower dtype (float8 scaled per tensor), for
the cell's control.

Departures from mmseg:
- NHWC activations, HWIO conv kernels and [in, out] Linear kernels, under
  the port's names: ``linear_c.0`` .. ``linear_c.3`` for mmseg's
  ``linear_c1.proj`` .. ``linear_c4.proj``, ``linear_fuse.Conv_0`` and
  ``linear_fuse.BatchNorm_0`` for its ConvModule's conv and BatchNorm;
- the head's BatchNorm takes eps 1e-5 (SyncBN's default) and its running
  statistics (eval mode); dropout and drop-path are left out (inference);
- the logits are resized bilinearly to the input's size here, the step
  mmseg's ``EncoderDecoder.encode_decode`` takes after the head;
- ``num_labels`` classes (the cell: 2, for Cityscapes' 19);
- the input is whatever the caller normalised (the cell: TP statistics).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.unet import fake_quant


def conv_nhwc(x, kernel, bias=None, stride=1, padding=0, groups=1):
    """``kernel`` (kh, kw, in // groups, out), in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1),
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def linear(x, kernel, bias=None):
    """``x @ kernel + bias``, ``kernel`` [in, out], in x's dtype."""
    return F.linear(x, kernel.to(x.dtype).t(), None if bias is None else bias.to(x.dtype))


@contextlib.contextmanager
def low_precision(dtype):
    """Inside, every convolution's and Linear's input and weight are rounded
    to ``dtype`` (``fake_quant``); the sums stay in the operands' dtype."""
    global conv_nhwc, linear
    exact_conv, exact_linear = conv_nhwc, linear

    def rounded_conv(x, kernel, *a, **k):
        return exact_conv(fake_quant(x, dtype), fake_quant(kernel, dtype), *a, **k)

    def rounded_linear(x, kernel, bias=None):
        return exact_linear(fake_quant(x, dtype), fake_quant(kernel, dtype), bias)
    conv_nhwc, linear = rounded_conv, rounded_linear
    try:
        yield
    finally:
        conv_nhwc, linear = exact_conv, exact_linear


def resize(x, hw):
    """NHWC bilinear resize, half-pixel centres (``align_corners=False``)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1, bias=True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, k, cin // groups, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x):
        return conv_nhwc(x, self.kernel, self.bias, self.stride, self.padding, self.groups)


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return linear(x, self.kernel, self.bias)


# mmseg builds the patch embeds' and the reduction's norms as a plain
# nn.LayerNorm(dim); the blocks' and the stages' take layer_norm_eps
PLAIN_EPS = 1e-5


class LayerNorm(nn.Module):
    """float32 statistics and parameters, the result in x's dtype."""

    def __init__(self, c, eps):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        return ((x.float() - self.mean) * (self.scale * torch.rsqrt(self.var + self.eps))
                + self.bias).to(x.dtype)


def attention(q, k, v, heads: int):
    """softmax(q k^T / sqrt(hd)) v per head: q [B, N, C], k and v [B, M, C];
    the scores are float32 sums of the operands' exact products."""
    b, n, c = q.shape
    hd = c // heads
    split = lambda t: t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)  # noqa: E731
    qh, kh, vh = split(q), split(k), split(v)
    p = torch.softmax((qh.float() @ kh.float().transpose(-1, -2)) * hd ** -0.5, dim=-1)
    return (p.to(v.dtype) @ vh).transpose(1, 2).reshape(b, n, c)


class Attention(nn.Module):
    def __init__(self, c, heads, sr):
        super().__init__()
        self.heads, self.ratio = heads, sr
        self.q = Linear(c, c)
        self.kv = Linear(c, 2 * c)
        if sr > 1:
            self.sr = Conv(c, c, sr, stride=sr)
            self.norm = LayerNorm(c, PLAIN_EPS)
        self.proj = Linear(c, c)

    def forward(self, x, hw):
        b, n, c = x.shape
        q = self.q(x)
        if self.ratio > 1:
            x = self.norm(self.sr(x.reshape(b, hw[0], hw[1], c)).reshape(b, -1, c))
        kv = self.kv(x)
        return self.proj(attention(q, kv[..., :c], kv[..., c:], self.heads))


class MixFFN(nn.Module):
    def __init__(self, c, hidden):
        super().__init__()
        self.fc1 = Linear(c, hidden)
        self.dwconv = Conv(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = Linear(hidden, c)

    def forward(self, x, hw):
        b, n, _ = x.shape
        h = self.dwconv(self.fc1(x).reshape(b, hw[0], hw[1], -1)).reshape(b, n, -1)
        return self.fc2(F.gelu(h))


class Block(nn.Module):
    def __init__(self, c, heads, sr, mlp_ratio, eps):
        super().__init__()
        self.norm1 = LayerNorm(c, eps)
        self.attn = Attention(c, heads, sr)
        self.norm2 = LayerNorm(c, eps)
        self.mlp = MixFFN(c, mlp_ratio * c)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp(self.norm2(x), hw)


class PatchEmbed(nn.Module):
    def __init__(self, cin, c, patch, stride):
        super().__init__()
        self.proj = Conv(cin, c, patch, stride=stride, padding=patch // 2)
        self.norm = LayerNorm(c, PLAIN_EPS)

    def forward(self, x):
        y = self.proj(x)
        b, h, w, c = y.shape
        return self.norm(y.reshape(b, h * w, c)), (h, w)


class Fuse(nn.Module):
    """mmseg's ConvModule: a 1x1 conv without bias, BatchNorm, ReLU."""

    def __init__(self, cin, c):
        super().__init__()
        self.Conv_0 = Conv(cin, c, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(c)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class Head(nn.Module):
    def __init__(self, widths, dim, num_labels):
        super().__init__()
        self.linear_c = nn.ModuleList(Linear(c, dim) for c in widths)
        self.linear_fuse = Fuse(len(widths) * dim, dim)
        self.linear_pred = Conv(dim, num_labels, 1)

    def forward(self, feats):
        hw = feats[0].shape[1:3]
        ups = [resize(lin(f), hw) for lin, f in zip(self.linear_c, feats)]
        return self.linear_pred(self.linear_fuse(torch.cat(ups[::-1], dim=-1)))


class SegFormerReference(nn.Module):
    """Input NHWC; returns logits NHWC at the input's size."""

    def __init__(self, hidden_sizes: Sequence[int], depths: Sequence[int],
                 num_attention_heads: Sequence[int], sr_ratios: Sequence[int],
                 patch_sizes: Sequence[int], strides: Sequence[int], mlp_ratio: int,
                 decoder_hidden_size: int, layer_norm_eps: float, num_labels: int):
        super().__init__()
        self.stages = len(hidden_sizes)
        cin = 3
        for i, c in enumerate(hidden_sizes, start=1):
            j = i - 1
            setattr(self, f"patch_embed{i}", PatchEmbed(cin, c, patch_sizes[j], strides[j]))
            setattr(self, f"block{i}", nn.ModuleList(
                Block(c, num_attention_heads[j], sr_ratios[j], mlp_ratio, layer_norm_eps)
                for _ in range(depths[j])))
            setattr(self, f"norm{i}", LayerNorm(c, layer_norm_eps))
            cin = c
        self.head = Head(hidden_sizes, decoder_hidden_size, num_labels)

    def forward(self, x):
        feats, y = [], x
        for i in range(1, self.stages + 1):
            t, hw = getattr(self, f"patch_embed{i}")(y)
            for blk in getattr(self, f"block{i}"):
                t = blk(t, hw)
            y = getattr(self, f"norm{i}")(t).reshape(t.shape[0], hw[0], hw[1], -1)
            feats.append(y)
        return resize(self.head(feats), x.shape[1:3])


ARCH_KEYS = ("hidden_sizes", "depths", "num_attention_heads", "sr_ratios", "patch_sizes",
             "strides", "mlp_ratio", "decoder_hidden_size", "layer_norm_eps")


def build(arch: dict, num_labels: int, state: Optional[dict] = None, device=None,
          dtype: torch.dtype = torch.float32) -> SegFormerReference:
    """The reference of ``arch`` (a configuration's ``segformer`` group; its
    other keys are not read) on ``device`` with ``state`` loaded strictly,
    in eval mode; ``dtype`` below float32 casts the conv and Linear weights
    to it (the norms keep float32)."""
    with torch.device(device or "cpu"):
        model = SegFormerReference(**{k: arch[k] for k in ARCH_KEYS}, num_labels=num_labels)
    if state is not None:
        model.load_state_dict(state, strict=True)
    if dtype != torch.float32:
        for mod in model.modules():
            if isinstance(mod, (Conv, Linear)):
                mod.to(dtype)
    return model.eval()
