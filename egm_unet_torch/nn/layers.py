"""Conv blocks, NHWC (port of ``egm_unet_tpu/nn/layers.py``), in two forms
chosen by ``fold_bn`` when a block is built, as in the JAX package:

- ``fold_bn=True`` (the default), the inference graph: every conv that the
  JAX graph follows with a BatchNorm carries the folded bias instead
  (``models/fold_bn.py``).  Every 3x3 / stride 1 / pad 1 / dilation 1 /
  groups 1 conv of a ConvBNReLU or BasicConv goes through the
  ``conv3x3_gemm`` kernel, at any channel count; the decoder's first conv
  (``up_pair``) goes through ``up_concat_conv``.  ``DoubleConv`` has two
  alternative routes, chosen when the model is built: ``conv_impl="pair"``
  sends both of its convs through one ``conv3x3_pair_gemm`` launch, and
  ``upsample_impl="fused"`` upsamples the decoder's low-resolution input
  with ``upsample2x_fused`` before the concat.  The EdgeAwareFeatureEnhancer
  computes its edge map with ``eafe_edge`` (kernel K8 on the card).
- ``fold_bn=False``, the training graph: conv -> ``BatchNorm`` -> ReLU in
  plain, differentiable PyTorch, no kernel.  ``module.train()`` normalises
  with the batch's statistics (the global batch's under a data group:
  sync-BN, ``parallel/``) and updates the running ones; ``module.eval()``
  normalises with the running ones.  Under a spatial group each rank holds
  rows of every map (``parallel/halo.py``): the convs and pools fetch their
  halos, the BatchNorm sums run over the data group's ranks, which then
  count the spatial ones, and the decoder's upsample takes the global
  matrix's rows (``up_to_match``).

Under int8 serving (``ops/quant.py``) every ``Conv`` records its input
while calibrating and runs ``int8_conv`` in the int8 and int8full modes,
where the folded blocks leave their kernels for ``Conv.forward``; the
outputs of ConvBNReLU and BasicConv are storage sites (``out``), and a
DoubleConv whose first ``out`` site is active runs its convs one by one.

Module, parameter and buffer names mirror the flax tree (``Conv_0``,
``BatchNorm_0``, ``ConvBNReLU_0``, ``kernel``, ``bias``, ``scale``, ``mean``,
``var``, ...) so ``utils/from_flax.py`` maps one onto the other by name.
The compute dtype is the input's: a bfloat16 input runs every conv in
bfloat16 on its float32 parameters, cast where they are used, as flax's
``dtype=bfloat16`` does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from egm_unet_torch.ops.conv import conv2d
from egm_unet_torch.ops.cuda.conv3x3 import conv3x3_gemm, conv3x3_pair_gemm
from egm_unet_torch.ops.cuda.edge import eafe_edge, eafe_edge_plain
from egm_unet_torch.ops.cuda.upconv import up_concat_conv
from egm_unet_torch.ops.quant import (INT8_CONV_MODES, convs_on_kernels,
                                      current_quantizer, qstore, site_active)
from egm_unet_torch.ops.resize import (UPSAMPLE_IMPLS, upsample2x_bilinear_align_corners,
                                       upsample2x_rows)
from egm_unet_torch.parallel.mesh import data_group, spatial, use_data_group, use_spatial

CONV_IMPLS = ("gemm", "pair")


def _pair(v):
    return (int(v[0]), int(v[1])) if isinstance(v, (tuple, list)) else (int(v), int(v))


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=generator) * 2 - 1) * bound)


def torch_kernel_init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` (a kernel with its output axis last: HWIO, or a ``Dense``
    [in, out]) uniform in +-1/sqrt(fan_in), fan_in the product of every axis
    but the last: PyTorch's default conv and linear initialisation, which
    the JAX package draws as ``variance_scaling(1/3, "fan_in", "uniform")``.
    Returns ``t``."""
    uniform_(t, 1.0 / math.sqrt(math.prod(t.shape[:-1])), generator)
    return t


def torch_bias_init(t: torch.Tensor, generator: torch.Generator,
                    fan_in: int = 1) -> torch.Tensor:
    """Fill ``t`` uniform in +-1/sqrt(fan_in), PyTorch's default bias
    initialisation.  Returns ``t``."""
    uniform_(t, 1.0 / math.sqrt(fan_in), generator)
    return t


class Conv(nn.Module):
    """Conv2d with an HWIO ``kernel`` (kh, kw, in_ch // groups, features)
    and an optional ``bias``; integer symmetric zero padding."""

    flax_child = "Conv_0"  # the flax wrapper holds one core nn.Conv
    casts_with_compute_dtype = True

    def __init__(self, in_ch: int, features: int, kernel_size=3, stride=1,
                 padding=0, dilation=1, groups: int = 1, use_bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.dilation, self.groups = _pair(dilation), groups
        self.kernel = nn.Parameter(torch.zeros(kh, kw, in_ch // groups, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def is_plain3x3(self) -> bool:
        return (tuple(self.kernel.shape[:2]) == (3, 3) and self.stride == (1, 1)
                and self.padding == (1, 1) and self.dilation == (1, 1)
                and self.groups == 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He-uniform kernel (keeps activations at scale through the ReLU
        stack of a model with random weights), small uniform bias."""
        fan_in = self.kernel[..., 0].numel()
        uniform_(self.kernel, math.sqrt(6.0 / fan_in), generator)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = current_quantizer()  # ops/quant.py: calibration, int8 convs
        if q is not None:
            if q.mode == "calibrate":
                q.record(self, "act_absmax", x)
            elif q.mode in INT8_CONV_MODES:
                return q.conv(self, x)
        return conv2d(x, self.kernel, self.bias, stride=self.stride,
                      padding=self.padding, dilation=self.dilation,
                      groups=self.groups)


class CoreConv(Conv):
    """A ``Conv`` whose flax counterpart is a bare ``nn.Conv`` (its leaves
    are ``name/kernel``, not ``name/Conv_0/kernel``)."""

    flax_child = None


class Dense(nn.Module):
    """``x @ kernel + bias`` with ``kernel`` [in, out] as flax ``nn.Dense``
    stores it.  The input is cast to the kernel's dtype, which is the
    module's compute dtype (``cast_weights``)."""

    casts_with_compute_dtype = True

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Variance 1 / fan_in, so unit-variance inputs stay at scale."""
        fan_in = self.kernel.shape[0]
        uniform_(self.kernel, math.sqrt(3.0 / fan_in), generator)
        if self.bias is not None:
            uniform_(self.bias, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.kernel.dtype), self.kernel.t(), self.bias)


class LayerNorm(nn.Module):
    """LayerNorm (eps 1e-5) in float32 with float32 parameters ``scale`` and
    ``bias`` whatever the compute dtype; the result stays float32, as flax
    ``nn.LayerNorm(dtype=float32)`` leaves it."""

    def __init__(self, width: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale.dtype != torch.float32:
            raise TypeError("LayerNorm parameters must stay float32; cast the "
                            "model with nn.layers.cast_weights, not .to(dtype)")
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, 1e-5)


def cast_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the matmul and conv weights (``Dense``, ``Conv``) to the compute
    dtype ``dtype``, in place.  Every other parameter (LayerNorm scales,
    embeddings, positional tables, output projections) stays float32 and is
    cast where it is used, as the JAX modules keep ``param_dtype=float32``
    and compute LayerNorm and the projections in float32.  Use this, not
    ``model.to(dtype)``, on the transformer models."""
    for mod in model.modules():
        if getattr(mod, "casts_with_compute_dtype", False):
            for p in mod.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for bfloat16 and float32 inputs, float64 for float64 ones, as
    flax promotes BatchNorm's statistics to at least float32."""
    return torch.promote_types(x.dtype, torch.float32)


def _global_count(n: int, shape, group) -> int:
    """The global batch's element count per channel, on the host, from
    this rank's ``n``: times the data ranks, and under a spatial group with
    the scope's global height in place of this rank's rows (the ranks hold
    unequal rows).  A count all-reduced on the device would make the
    division a device division, which rounds otherwise than the one-process
    step's division by a host integer: the data-parallel step at world 1
    would no longer equal that step bit for bit."""
    sp = spatial()
    if sp is None:
        return n * group.world
    return n // shape[1] * sp.height * (group.world // sp.group.world)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BatchNorm over all but the last axis: returns (y, batch
    mean, batch variance), the last two without gradient.  The backward is
    the closed form of the forward's derivative, ``scale * rstd * (g -
    mean(g) - xhat * mean(g * xhat))`` (the last term only where the
    variance was not clipped), rather than autograd's path through ``E[x^2]
    - E[x]^2``, whose terms cancel at the size of ``mean^2``: the gradient
    of a conv bias in front of a BatchNorm, zero in exact arithmetic, stays
    at float32 rounding of the gradient itself.

    Under a data group (sync-BN) the batch is the global one: the forward
    sums the per-channel sums and sums of squares over the ranks in one
    ``[2C]`` all-reduce, the backward ``sum(g)`` and ``sum(g * xhat)`` in
    another (``_global_count`` gives the element count).  The gradients of
    ``scale`` and ``bias`` stay this rank's own sums: the gradient
    all-reduce adds them once."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        xf = x.to(_stat_dtype(x))
        dims = tuple(range(xf.ndim - 1))
        c = xf.shape[-1]
        n = xf.numel() // c
        sums = torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims)])
        if group is not None:
            group.all_reduce(sums)
            n = _global_count(n, xf.shape, group)
        mean, sq = (sums / n).split(c)
        raw = sq - mean * mean
        var = torch.clamp(raw, min=0.0)
        rstd = torch.rsqrt(var + eps)
        y = (xf - mean) * (rstd * scale) + bias
        ctx.save_for_backward(x, mean, rstd, scale, raw > 0)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mean, rstd, scale, live = ctx.saved_tensors
        g = gy.to(mean.dtype)
        dims = tuple(range(g.ndim - 1))
        c, n = g.shape[-1], ctx.n
        xhat = (x.to(mean.dtype) - mean) * rstd
        gsum = g.sum(dim=dims)
        gxhat = (g * xhat).sum(dim=dims)
        if ctx.group is None:
            tsum, txhat = gsum, gxhat
        else:
            tsum, txhat = ctx.group.all_reduce(torch.cat([gsum, gxhat])).split(c)
        gx = (scale * rstd) * (g - tsum / n - xhat * (txhat / n * live))
        return gx.to(x.dtype), gxhat, gsum, None, None


class BatchNorm(nn.Module):
    """BatchNorm over N, H and W of an NHWC tensor with flax's semantics
    (``flax.linen.BatchNorm`` as ``egm_unet_tpu/nn/layers.py::BatchNorm``
    builds it), not ``nn.BatchNorm2d``'s:

    - batch statistics in float32 (float64 for a float64 input), the biased
      variance by the fast form
      ``E[x^2] - E[x]^2`` clipped at 0; eps 1e-5;
    - running statistics ``ra = m * ra + (1 - m) * batch`` with flax's
      momentum ``m = 1 - torch_momentum``, the biased variance included
      (``F.batch_norm`` would store the unbiased one);
    - ``y = (x - mean) * (scale * rsqrt(var + eps)) + bias`` in that dtype,
      returned in x's.

    ``scale`` and ``bias`` are parameters, ``mean`` and ``var`` buffers.
    The running statistics are left alone while ``frozen`` is non-zero: a
    checkpointed forward that the backward pass recomputes (``remat``) has
    already updated them once."""

    flax_child = "BatchNorm_0"  # the flax wrapper holds one nn.BatchNorm

    def __init__(self, features: int, torch_momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = 1.0 - torch_momentum
        self.eps = eps
        self.frozen = 0
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = torch.rsqrt(self.var + self.eps) * self.scale
            return ((x.to(_stat_dtype(x)) - self.mean) * mul + self.bias).to(x.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias, self.eps,
                                             data_group())
        if not self.frozen:
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        return y


@contextlib.contextmanager
def _recompute(owner: nn.Module, group, scope):
    """The context of a checkpointed forward's second run: the running
    statistics of the BatchNorms in ``owner`` frozen, and the data group and
    spatial scope of the first run, which the autograd thread running it
    does not inherit."""
    bns = [m for m in owner.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.frozen += 1
    try:
        with use_data_group(group), use_spatial(scope):
            yield
    finally:
        for m in bns:
            m.frozen -= 1


def remat(owner: nn.Module, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.utils.checkpoint`` (the JAX
    package's ``nn.remat``): only the inputs are saved, and the backward pass
    runs ``fn`` again.  That second run leaves the running statistics of the
    BatchNorms in ``owner`` alone, and under a data group all-reduces the
    BatchNorms' sums again (under a spatial group, fetches the halos again),
    in the same order on every rank.  A plain call when autograd is off."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    group, scope = data_group(), spatial()
    # no random op in any block, so there is no RNG state to replay
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recompute(owner, group, scope)), **kwargs)


def call_maybe_remat(on: bool, module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)``, checkpointed when ``on``."""
    if on:
        return remat(module, module, *args, **kwargs)
    return module(*args, **kwargs)


class BasicConv(nn.Module):
    """conv -> BatchNorm (torch momentum 0.01) -> ReLU of the GRFB blocks;
    ``relu=False`` drops the ReLU.  Folded (``fold_bn=True``) the conv
    carries the BN's bias and a plain 3x3 goes through ``conv3x3_gemm``."""

    def __init__(self, in_ch: int, features: int, kernel_size=3, stride=1,
                 padding=0, dilation=1, groups: int = 1, relu: bool = True,
                 fold_bn: bool = True):
        super().__init__()
        self.relu, self.fold_bn = relu, fold_bn
        self.Conv_0 = Conv(in_ch, features, kernel_size, stride, padding,
                           dilation, groups, use_bias=fold_bn)
        if not fold_bn:
            self.BatchNorm_0 = BatchNorm(features, torch_momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.Conv_0
        if self.fold_bn and conv.is_plain3x3() and convs_on_kernels():
            x = conv3x3_gemm(x.contiguous(), conv.kernel, conv.bias, relu=self.relu)
        else:
            x = conv(x)
            if not self.fold_bn:
                x = self.BatchNorm_0(x)
            if self.relu:
                x = F.relu(x)
        # int8 storage site: uint8 after the ReLU, int8 without it
        return qstore(self, x, "out", signed=not self.relu)


def pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad x1 spatially to x2's H/W, split as the reference splits."""
    dy = x2.shape[1] - x1.shape[1]
    dx = x2.shape[2] - x1.shape[2]
    if dy == 0 and dx == 0:
        return x1
    return F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


def up_to_match(x1: torch.Tensor, x2: torch.Tensor, impl: Optional[str] = None
                ) -> torch.Tensor:
    """``x1`` upsampled 2x (``upsample2x_bilinear_align_corners`` by
    ``impl``) and zero-padded to x2's H and W (``pad_to_match``).  Under a
    spatial group x2 holds this rank's rows of the scope's height H and x1
    its rows of the stage below, H // 2: the padded rows are placed in
    global coordinates (``upsample2x_rows``), so that only the rank holding
    an odd stage's last row gets its pad."""
    sp = spatial()
    if sp is None:
        return pad_to_match(upsample2x_bilinear_align_corners(x1, impl), x2)
    if impl not in (None, "matmul"):
        raise ValueError(f"a row-split upsample runs the matmul route, not {impl!r}")
    h = sp.height // 2
    y = upsample2x_rows(x1, h, sp.height, (sp.height - 2 * h) // 2)
    dx = x2.shape[2] - y.shape[2]
    return F.pad(y, (0, 0, dx // 2, dx - dx // 2))


class ConvBNReLU(nn.Module):
    """conv3x3 (pad 1) -> BatchNorm -> ReLU, one half of DoubleConv.
    ``up_pair=(x2, x1)`` is the decoder form ``relu(BN(conv3x3(concat([x2,
    up2x(x1)]))))`` with the upsample and concat inside this module, so that
    a checkpoint around it saves the small pair.  Folded, x2 must be exactly
    twice x1's size, and the stage is one ``up_concat_conv`` launch; every
    other folded call is one ``conv3x3_gemm`` launch."""

    def __init__(self, in_ch: int, features: int, fold_bn: bool = True):
        super().__init__()
        self.fold_bn = fold_bn
        self.Conv_0 = Conv(in_ch, features, 3, padding=1, use_bias=fold_bn)
        if not fold_bn:
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: Optional[torch.Tensor] = None, *,
                up_pair=None) -> torch.Tensor:
        k, b = self.Conv_0.kernel, self.Conv_0.bias
        if self.fold_bn and convs_on_kernels():
            if up_pair is not None:
                x2, x1 = up_pair
                y = up_concat_conv(x2.contiguous(), x1.contiguous(), k, b)
            else:
                y = conv3x3_gemm(x.contiguous(), k, b, relu=True)
            return qstore(self, y, "out")
        if up_pair is not None:
            x2, x1 = up_pair
            x = torch.cat([x2, up_to_match(x1, x2)], dim=-1)
        y = self.Conv_0(x)
        if not self.fold_bn:
            y = self.BatchNorm_0(y)
        return qstore(self, F.relu(y), "out")


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) x 2 with an optional mid width.  ``up_pair=(x2,
    x1)`` is the decoder form on ``concat([x2, up2x(x1)])``, x2 exactly twice
    x1's size.

    Routes of the folded graph (the parameters are the same on all of them):

    - ``conv_impl="gemm"``, ``upsample_impl="matmul"`` (default): one
      ``conv3x3_gemm`` launch per conv; with ``up_pair`` the first is one
      ``up_concat_conv`` launch.
    - ``conv_impl="pair"``: both convs in one ``conv3x3_pair_gemm`` launch;
      with ``up_pair`` the upsample (by ``upsample_impl``) and the concat
      come first, as plain tensor ops.
    - ``conv_impl="gemm"``, ``upsample_impl="fused"``: with ``up_pair``,
      ``upsample2x_fused``, concat, then two ``conv3x3_gemm`` launches.

    The training graph (``fold_bn=False``) has the default route only;
    ``fine_remat`` checkpoints each ConvBNReLU (the upsample and concat of
    ``up_pair`` inside the first)."""

    def __init__(self, in_ch: int, features: int, mid_features: Optional[int] = None,
                 conv_impl: str = "gemm", upsample_impl: str = "matmul",
                 fold_bn: bool = True, fine_remat: bool = False):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv impl {conv_impl!r}; choose from "
                             f"{list(CONV_IMPLS)}")
        if upsample_impl not in UPSAMPLE_IMPLS:
            raise ValueError(f"unknown upsample impl {upsample_impl!r}; choose "
                             f"from {list(UPSAMPLE_IMPLS)}")
        if not fold_bn and (conv_impl, upsample_impl) != ("gemm", "matmul"):
            raise ValueError("the kernel routes exist in the folded graph only; "
                             "the training graph (fold_bn=False) takes "
                             "conv_impl='gemm', upsample_impl='matmul'")
        self.conv_impl, self.upsample_impl = conv_impl, upsample_impl
        self.fine_remat = fine_remat
        mid = mid_features or features
        self.ConvBNReLU_0 = ConvBNReLU(in_ch, mid, fold_bn)
        self.ConvBNReLU_1 = ConvBNReLU(mid, features, fold_bn)

    def forward(self, x: Optional[torch.Tensor] = None, *,
                up_pair=None) -> torch.Tensor:
        if up_pair is not None and (self.conv_impl == "pair"
                                    or self.upsample_impl == "fused"):
            x2, x1 = up_pair
            up = upsample2x_bilinear_align_corners(x1, self.upsample_impl)
            x, up_pair = torch.cat([x2, up], dim=-1), None
        # one pair launch, unless the convs may not take their kernels or an
        # active int8 storage site lies between them (ops/quant.py)
        if (self.conv_impl == "pair" and convs_on_kernels()
                and not site_active(self.ConvBNReLU_0, "out")):
            c1, c2 = self.ConvBNReLU_0.Conv_0, self.ConvBNReLU_1.Conv_0
            y = conv3x3_pair_gemm(x.contiguous(), c1.kernel, c1.bias,
                                  c2.kernel, c2.bias)
            return qstore(self.ConvBNReLU_1, y, "out")
        x = call_maybe_remat(self.fine_remat, self.ConvBNReLU_0, x, up_pair=up_pair)
        return call_maybe_remat(self.fine_remat, self.ConvBNReLU_1, x)


class EdgeAwareFeatureEnhancer(nn.Module):
    """edge = x - AvgPool3x3(x); w = sigmoid(BN(conv1x1(edge)));
    out = w*x + x.  Folded, the conv carries the BN and the edge is one
    ``eafe_edge`` call (K8 on the card); the training graph and a spatial
    group take the plain composite ``eafe_edge_plain``, which autograd
    differentiates and whose pool fetches its halo rows."""

    def __init__(self, channels: int, fold_bn: bool = True):
        super().__init__()
        self.fold_bn = fold_bn
        self.Conv_0 = Conv(channels, channels, 1)
        if not fold_bn:
            self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fold_bn and spatial() is None:
            x = x.contiguous()
            edge = eafe_edge(x)
        else:
            edge = eafe_edge_plain(x)
        w = self.Conv_0(edge)
        if not self.fold_bn:
            w = self.BatchNorm_0(w)
        w = torch.sigmoid(w)
        return w * x + x
