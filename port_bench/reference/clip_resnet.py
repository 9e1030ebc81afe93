"""Plain PyTorch reference of a CLIP with the ModifiedResNet image tower
(Radford et al., *Learning Transferable Visual Models From Natural Language
Supervision*, arXiv:2103.00020; github.com/openai/CLIP, ``clip/model.py``
lines 14-157) and Long-CLIP's text tower, float32, for the comparison that
decides an RN fine-tune cell's ``correct``.

- Stem: three 3x3 convolutions (the first of stride 2; widths w/2, w/2, w),
  each followed by a BatchNorm and a ReLU, then a 2x2 average pool.
- Four stages of Bottlenecks (planes w, 2w, 4w, 8w; output 4x planes): 1x1
  conv, BatchNorm, ReLU; 3x3 conv, BatchNorm, ReLU; a stride > 1 as an
  average pool here (anti-aliased: every convolution has stride 1); 1x1
  conv, BatchNorm; the shortcut through an average pool, a 1x1 conv and a
  BatchNorm where the stride or the width changes; the sum through a ReLU.
  The first Bottleneck of stages 2-4 has stride 2.
- Attention pool: the map's tokens with their mean prepended, plus a learnt
  positional table; one multi-head attention (heads of 64, separate q, k
  and v projections) queried by the mean token alone, through ``c_proj``.
- BatchNorm in eval mode (``F.batch_norm`` with ``training=False``): the
  running ``mean`` and ``var`` are buffers, not parameters, so they take no
  gradient and no update, as torch keeps them.
- Text, loss, gradients in blocks of rows, AdamW and its schedule:
  ``reference/longclip.py``'s (``encode_text``, ``loss_and_grads``,
  ``AdamW``, ``schedule``).

Departures from upstream:
- activations enter NHWC (the traffic's layout) and are NCHW inside; the
  convolution kernels are stored [kh, kw, in, out] and the projections'
  [in, out], under the port's leaf names, so one state dict fits both;
- the text tower is Long-CLIP's (248 positions in two tables), not CLIP's
  77, as the fine-tune's ``--stretch`` makes it;
- computed in float32 throughout (upstream may hold fp16 weights).

Nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.clipseg import LN, Linear, heads
from port_bench.reference.longclip import Block, LongCLIPReference


class Conv(nn.Module):
    """No bias; ``kernel`` [k, k, in, out]; zero padding (k - 1) / 2."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, k, cin, cout))
        self.stride = stride

    def forward(self, x):
        k = self.kernel.shape[0]
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), stride=self.stride,
                        padding=(k - 1) // 2)


class BN(nn.Module):
    """Eval-mode BatchNorm2d, eps 1e-5: ``scale`` and ``bias`` parameters,
    the running ``mean`` and ``var`` buffers."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, training=False,
                            eps=1e-5)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        out = 4 * planes
        self.stride = stride
        self.conv1, self.bn1 = Conv(inplanes, planes, 1), BN(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3), BN(planes)
        self.conv3, self.bn3 = Conv(planes, out, 1), BN(out)
        self.downsample = stride > 1 or inplanes != out
        if self.downsample:
            self.ds_conv, self.ds_bn = Conv(inplanes, out, 1), BN(out)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.ds_bn(self.ds_conv(identity))
        return F.relu(out + identity)


class AttentionPool(nn.Module):
    def __init__(self, grid: int, width: int, n_heads: int, out: int):
        super().__init__()
        self.n = n_heads
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.q_proj, self.k_proj = Linear(width, width), Linear(width, width)
        self.v_proj, self.c_proj = Linear(width, width), Linear(width, out)

    def forward(self, x):
        t = x.flatten(2).transpose(1, 2)  # [B, HW, C], rows of the map in order
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1) + self.positional_embedding[None]
        q, k, v = (heads(p(s), self.n) for p, s in ((self.q_proj, t[:, :1]), (self.k_proj, t),
                                                    (self.v_proj, t)))
        w = torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, -1)
        return self.c_proj((w @ v).transpose(1, 2).flatten(2)[:, 0])


class CLIPResNetReference(nn.Module):
    def __init__(self, embed_dim=1024, resolution=448, vision_layers=(3, 15, 36, 10),
                 vision_width=128, context=248, vocab=49408, text_width=1024, text_heads=16,
                 text_layers=12):
        super().__init__()
        w, layers = vision_width, tuple(vision_layers)
        v = self.visual = nn.Module()
        for i, (cin, cout, stride) in enumerate([(3, w // 2, 2), (w // 2, w // 2, 1),
                                                 (w // 2, w, 1)], start=1):
            setattr(v, f"stem_conv{i}", Conv(cin, cout, 3, stride))
            setattr(v, f"stem_bn{i}", BN(cout))
        inplanes, self.blocks = w, []
        for stage, (planes, n) in enumerate(zip((w, 2 * w, 4 * w, 8 * w), layers), start=1):
            for b in range(n):
                setattr(v, f"layer{stage}_{b}",
                        Bottleneck(inplanes, planes, 2 if b == 0 and stage > 1 else 1))
                self.blocks.append(f"layer{stage}_{b}")
                inplanes = 4 * planes
        v.attnpool = AttentionPool(resolution // 32, 32 * w, 32 * w // 64, embed_dim)
        self.token_embedding = nn.Module()
        self.token_embedding.embedding = nn.Parameter(torch.zeros(vocab, text_width))
        self.positional_embedding = nn.Parameter(torch.zeros(context, text_width))
        self.positional_embedding_res = nn.Parameter(torch.zeros(context, text_width))
        for i in range(text_layers):
            setattr(self, f"text_resblock{i}", Block(text_width, text_heads))
        self.ln_final = LN(text_width)
        self.text_projection = nn.Parameter(torch.zeros(text_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))
        self.text_layers = text_layers

    def encode_image(self, x):
        """``x`` [B, H, W, 3] CLIP-normalised -> [B, embed_dim]."""
        v = self.visual
        x = x.permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(v, f"stem_bn{i}")(getattr(v, f"stem_conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        for name in self.blocks:
            x = getattr(v, name)(x)
        return v.attnpool(x)

    encode_text = LongCLIPReference.encode_text


def build(state=None, device=None, **kw) -> CLIPResNetReference:
    with torch.device(device or "cpu"):
        model = CLIPResNetReference(**kw)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model
