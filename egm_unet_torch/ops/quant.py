"""int8 serving quantization (port of ``egm_unet_tpu/ops/quant.py``):
serving only, off-parity with the full-precision model, held to a mask
agreement instead.

Modes, as in the JAX package:

- ``"int8"``: every ``Conv`` runs ``int8_conv``: weights per output channel
  and the activation per tensor, symmetric int8, at a calibrated static
  scale where one exists (else a dynamic one, one abs-max per input);
  int32 accumulation, dequantized into the bias add.  The tensors between
  ops keep the working dtype.
- ``"int8df"``: int8 *dataflow*: the storage sites (``qstore``) round their
  tensor to 8 bits at a calibrated scale (``requant_store``: uint8 over
  [0, absmax] after a ReLU, symmetric int8 for signed sites) and dequantize
  it again; the convolutions stay in the working dtype, on their kernels.
- ``"int8full"``: both.
- ``"calibrate"``: a full-precision forward that records each conv input's
  and each storage site's abs-max; ``calibrate_quant_scales`` turns them
  into scales.

The mode, the scales and the active storage sites travel together in a
``Quantizer``, held around a forward (``with quantizer.active():``, or
``with quantized(mode, model, scales, sites):``) in a context variable that
the modules read when they are called.  Scales are a flat mapping from the
flax path of the JAX package's ``quant_scales`` collection (``down1/conv1/
Conv_0/act_scale``, ``down1/mca/xout_scale``, ``pool1_scale``) to a float;
they live outside the ``state_dict``, so checkpoints stay mode-agnostic
(``utils/from_flax.py`` bridges them to and from the flax collection).  A
storage site is ``<module path>:<name>`` with the flax path of its module
(``down1/mca:xout``, ``:pool1`` at the top); ``sites`` is a comma list of
substrings, a site being active where one of them occurs in it, or
``"all"``.  Serving defaults to ``SHIP_QSTORE_SITES``.

Routing (``nn/``): under ``calibrate``, ``int8`` and ``int8full`` every
conv goes through ``Conv.forward`` (so K2, K3 and K5 do not launch); under
``int8df`` the convs keep their kernels and the site is applied to the
kernel's output, except where an active site lies inside a fused kernel:
then that DoubleConv takes two ``conv3x3_gemm`` launches instead of
``conv3x3_pair_gemm``, and that MCALayer the JAX package's unfused route
instead of ``mca_fused``.

Eager PyTorch materializes every tensor, so ``requant_store`` writes the
8-bit tensor and then its dequantized copy: it saves no memory traffic
here.  The JAX package's XLA-fusion switches (``optimization_barrier``,
``site_barrier``, ``$EGM_UP_SPLIT``) have no counterpart.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterable, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

QUANT_MODES = ("int8", "int8df", "int8full")
INT8_CONV_MODES = ("int8", "int8full")
STORAGE_MODES = ("int8df", "int8full")
# the shipping storage sites of the JAX package's int8df serving: the MCA
# chains, the EGRFB gate and residual maps, the encoder pools
SHIP_QSTORE_SITES = "mca:,egrfb:,:pool"

_ACTIVE: contextvars.ContextVar[Optional["Quantizer"]] = contextvars.ContextVar(
    "egm_torch_quantizer", default=None)


def current_quantizer() -> Optional["Quantizer"]:
    return _ACTIVE.get()


def current_quant_mode() -> Optional[str]:
    q = _ACTIVE.get()
    return None if q is None else q.mode


def convs_on_kernels() -> bool:
    """Whether the folded convs may take their hand-written kernels: not
    while calibrating, nor in the int8-conv modes."""
    return current_quant_mode() not in ("calibrate",) + INT8_CONV_MODES


def requant_store(x: torch.Tensor, scale, signed: bool = False) -> torch.Tensor:
    """``x`` rounded to 8-bit storage at ``scale`` and dequantized: uint8 over
    [0, 255] (``signed=False``) or int8 over [-127, 127]; float32 math, the
    result in ``x``'s dtype.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  The error is at most ``scale / 2`` in range."""
    s = torch.clamp_min(torch.as_tensor(scale, dtype=torch.float32,
                                        device=x.device), 1e-12)
    xf = x.float() / s
    if signed:
        q = torch.clamp(torch.round(xf), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(torch.round(xf), 0, 255).to(torch.uint8)
    return (q.float() * s).to(x.dtype)


def quantize_weight_per_channel(w: torch.Tensor):
    """HWIO ``w`` -> (int8 weights, float32 scale [co]): symmetric, the
    largest magnitude of each output channel at 127."""
    wf = w.float()
    amax = wf.abs().amax(dim=(0, 1, 2))
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return wq, scale


def _out_size(n: int, k: int, s: int, p: int, d: int) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def _block_diagonal(wq: torch.Tensor, groups: int) -> torch.Tensor:
    """Grouped HWIO weights (kh, kw, ci / groups, co) as dense ones (kh, kw,
    ci, co), zero outside each group's block: the same integer sums."""
    if groups == 1:
        return wq
    kh, kw, cig, co = wq.shape
    cog = co // groups
    dense = wq.new_zeros(kh, kw, cig * groups, co)
    for g in range(groups):
        dense[:, :, g * cig:(g + 1) * cig, g * cog:(g + 1) * cog] = \
            wq[:, :, :, g * cog:(g + 1) * cog]
    return dense


def int8_conv_gemm(xq: torch.Tensor, wq: torch.Tensor, stride, padding, dilation,
                   groups: int, matmul, max_elems: int = 2 ** 28) -> torch.Tensor:
    """The int32 sums of an NHWC int8 conv as im2col GEMMs: the taps of a
    chunk of images gathered into [M, kh * kw * ci] int8 rows, grouped
    weights made block-diagonal, K and N zero-padded to multiples of 8 and M
    to at least 32, then ``matmul(A [M, K] int8, B [K, N] int8) -> int32``.
    Images go in chunks of at most ``max_elems`` elements of A."""
    b, h, w, ci = xq.shape
    kh, kw, _, co = wq.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho, wo = _out_size(h, kh, sh, ph, dh), _out_size(w, kw, sw, pw, dw)
    k = kh * kw * ci
    kp, np_ = -(-k // 8) * 8, -(-co // 8) * 8
    wmat = _block_diagonal(wq, groups).reshape(k, co)
    wmat = F.pad(wmat, (0, np_ - co, 0, kp - k))
    wmat = wmat.t().contiguous().t()  # column-major B
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
    out = torch.empty(b, ho, wo, co, dtype=torch.int32, device=xq.device)
    per = max(1, max_elems // max(1, ho * wo * kp))
    for b0 in range(0, b, per):
        xs = xp[b0:b0 + per]
        cols = [xs[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
                   j * dw:j * dw + (wo - 1) * sw + 1:sw, :]
                for i in range(kh) for j in range(kw)]
        if kp > k:
            cols.append(xs.new_zeros(*cols[0].shape[:3], kp - k))
        a = torch.cat(cols, dim=-1).reshape(-1, kp)
        m = a.shape[0]
        if m < 32:
            a = F.pad(a, (0, 0, 0, 32 - m))
        y = matmul(a, wmat)[:m, :co]
        out[b0:b0 + per] = y.reshape(-1, ho, wo, co)
    return out


def int8_conv_sums(xq: torch.Tensor, wq: torch.Tensor, stride=(1, 1),
                   padding=(0, 0), dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """int8 NHWC x int8 HWIO -> exact int32 sums.  On a CUDA device: im2col
    and cuBLASLt's int8 GEMM (``torch._int_mm``), int32 accumulation.  On
    the CPU: the convolution in float64, exact because every partial sum is
    an integer below 2^53, then int32."""
    if xq.device.type == "cuda":
        return int8_conv_gemm(xq, wq, stride, padding, dilation, groups, torch._int_mm)
    y = F.conv2d(xq.double().permute(0, 3, 1, 2), wq.double().permute(3, 2, 0, 1),
                 stride=stride, padding=padding, dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def int8_conv(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
              stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups: int = 1,
              act_scale=None, wq=None) -> torch.Tensor:
    """Quantized NHWC conv: int8 x int8 -> int32, dequantized and biased in
    float32, returned in x's dtype.  ``act_scale=None`` quantizes the
    activation dynamically (its abs-max / 127); ``wq``: the precomputed
    ``quantize_weight_per_channel(kernel)``."""
    wq, w_scale = wq if wq is not None else quantize_weight_per_channel(kernel)
    xf = x.float()
    if act_scale is None:
        sx = torch.clamp_min(xf.abs().amax(), 1e-8) / 127.0
    else:
        sx = torch.clamp_min(torch.as_tensor(act_scale, dtype=torch.float32,
                                             device=x.device), 1e-8)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    y = int8_conv_sums(xq, wq, stride, padding, dilation, groups)
    y = y.float() * (sx * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def site_matches(path: str, sites: Optional[str]) -> bool:
    """Whether the storage site ``path`` (``<module path>:<name>``) is active
    under the comma list ``sites`` (``None`` or ``"all"``: every site)."""
    if sites is None or sites == "all":
        return True
    return any(s and s in path for s in sites.split(","))


class Quantizer:
    """One model's quantization: ``mode`` (``QUANT_MODES`` or
    ``"calibrate"``), ``scales`` (flat flax path -> float, see the module
    docstring), the active storage ``sites``.  Module paths are read from
    ``model`` when it is built; the scales go to the model's device once,
    and each conv's weights are quantized once, when first used."""

    def __init__(self, model: nn.Module, mode: str,
                 scales: Optional[Mapping[str, float]] = None,
                 sites: Optional[str] = None):
        if mode not in QUANT_MODES + ("calibrate",):
            raise ValueError(f"unknown quant mode {mode!r}; choose from "
                             f"{list(QUANT_MODES)}")
        self.mode, self.sites = mode, sites
        self.paths = {id(m): name.replace(".", "/") for name, m in model.named_modules()}
        dev = next(model.parameters()).device
        self.scales = {k: torch.tensor(float(v), dtype=torch.float32, device=dev)
                       for k, v in (scales or {}).items()}
        self.stats: Dict[str, torch.Tensor] = {}
        self._weights: Dict[int, tuple] = {}

    @contextlib.contextmanager
    def active(self):
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def key(self, module: nn.Module, leaf: str) -> str:
        path = self.paths[id(module)]
        return f"{path}/{leaf}" if path else leaf

    def record(self, module: nn.Module, leaf: str, x: torch.Tensor) -> None:
        """Calibration: keep the largest |x| seen at ``leaf``."""
        amax = x.detach().float().abs().amax()
        key = self.key(module, leaf)
        prev = self.stats.get(key)
        self.stats[key] = amax if prev is None else torch.maximum(prev, amax)

    def site_active(self, module: nn.Module, name: str) -> bool:
        return (self.mode in STORAGE_MODES
                and self.key(module, f"{name}_scale") in self.scales
                and site_matches(f"{self.paths[id(module)]}:{name}", self.sites))

    def qstore(self, module: nn.Module, x: torch.Tensor, name: str,
               signed: bool = False) -> torch.Tensor:
        if self.mode == "calibrate":
            self.record(module, f"{name}_absmax" if signed else f"{name}_absmaxu", x)
            return x
        if self.site_active(module, name):
            return requant_store(x, self.scales[self.key(module, f"{name}_scale")],
                                 signed)
        return x

    def conv(self, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """``conv`` (an ``nn.layers.Conv``) as ``int8_conv``."""
        wq = self._weights.get(id(conv))
        if wq is None:
            wq = self._weights[id(conv)] = quantize_weight_per_channel(conv.kernel)
        return int8_conv(x, conv.kernel, conv.bias, conv.stride, conv.padding,
                         conv.dilation, conv.groups,
                         act_scale=self.scales.get(self.key(conv, "act_scale")), wq=wq)


@contextlib.contextmanager
def quantized(mode: str, model: nn.Module, scales: Optional[Mapping[str, float]] = None,
              sites: Optional[str] = None):
    """Hold ``Quantizer(model, mode, scales, sites)`` around the block."""
    with Quantizer(model, mode, scales, sites).active() as q:
        yield q


def qstore(module: nn.Module, x: torch.Tensor, name: str,
           signed: bool = False) -> torch.Tensor:
    """Storage site ``name`` of ``module``: ``x`` itself outside a quantized
    forward or where the site is inactive; recorded while calibrating;
    ``requant_store``d at its scale where active under int8df / int8full."""
    q = _ACTIVE.get()
    return x if q is None else q.qstore(module, x, name, signed)


def site_active(module: nn.Module, name: str) -> bool:
    q = _ACTIVE.get()
    return q is not None and q.site_active(module, name)


def calibrate_quant_scales(model: nn.Module, sample_batches: Iterable[torch.Tensor]
                           ) -> Dict[str, float]:
    """Static scales from full-precision forwards of ``model`` over
    ``sample_batches`` (NHWC, on the model's device and dtype): each conv
    input's abs-max / 127 (``.../act_scale``), each storage site's abs-max
    / 255 (unsigned, ``{name}_scale``) or / 127 (signed), floored at 1e-8
    before the division, as the JAX package's leaves are."""
    q = Quantizer(model, "calibrate")
    with torch.no_grad(), q.active():
        for x in sample_batches:
            model(x)
    scales = {}
    for key, amax in q.stats.items():
        if key.endswith("_absmaxu"):
            name, div = key[:-len("_absmaxu")] + "_scale", 255.0
        else:
            name, div = key[:-len("_absmax")] + "_scale", 127.0
        scales[name] = float(torch.tensor(max(float(amax), 1e-8) / div,
                                          dtype=torch.float32))
    return scales
