"""3x3 / stride 1 / pad 1 convolution + bias + optional ReLU (kernel K2),
and the fused pair of two such convolutions (kernel K3).

Replaces ``egm_unet_tpu/ops/pallas/conv3x3.py::conv3x3_gemm``.  The CUDA
kernel (``csrc/conv3x3.cu``) is an implicit GEMM over M = B*H*W pixels,
N = Co, K = 9*C with float32 accumulation; zero padding comes from bounds
checks, so no padded copy is written and any C works.  At the path's widths
the tensor-core rate bounds the work; this version multiplies on the CUDA
cores in float32, which leaves it far from that bound (see PERF.md).

``conv3x3_pair_gemm`` replaces
``egm_unet_tpu/ops/pallas/conv3x3.py::conv3x3_pair_gemm``: the folded
DoubleConv ``relu(conv2(relu(conv1(x) + b1)) + b2)`` in one launch
(``csrc/conv3x3_pair.cu``).  A block owns a tile of output pixels and all of
Co; conv1's output on the tile and a one-pixel halo stays in shared memory in
the working dtype, zeroed where the halo lies outside the image (conv2's zero
padding), and never reaches device memory.  ``pair_tile`` picks the tile by
Cm and dtype so that the intermediate fits the 227 KB a block may use.

``conv3x3_gemm`` and ``conv3x3_pair_gemm`` launch their kernels for CUDA
tensors and run ``conv3x3_plain`` / ``conv3x3_pair_plain`` for CPU tensors;
nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, check_activation,
                                            check_same_device, stream_handle)

launches = 0  # conv3x3_gemm kernel launches since the last reset
pair_launches = 0  # conv3x3_pair_gemm kernel launches since the last reset

# csrc/conv3x3_pair.cu: tiles (TH, TW) in order of preference, the float32
# staging of one K chunk (16 x (64 + 4 + BN)), and the shared memory a block
# may opt into on sm_90
PAIR_TILES = ((8, 16), (8, 8), (4, 4), (2, 2))
PAIR_SMEM_LIMIT = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check(x, w, b):
    check_activation("x", x)
    c = x.shape[-1]
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w must be (3, 3, {c}, Co) HWIO, got {tuple(w.shape)}")
    co = w.shape[-1]
    if b is not None and tuple(b.shape) != (co,):
        raise ValueError(f"b must be ({co},), got {tuple(b.shape)}")
    check_same_device(("x", x), ("w", w), ("b", b))


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *,
                  relu: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 products of the
    working-dtype operands, float32 bias and ReLU, one rounding at the end."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.to(x.dtype).float().permute(3, 2, 0, 1),
                 None if b is None else b.float(), padding=1)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3_gemm(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *,
                 relu: bool = False) -> torch.Tensor:
    """x (B, H, W, C) contiguous, float32 or bfloat16; w (3, 3, C, Co) HWIO,
    cast to x's dtype; b (Co,) or None, added in float32."""
    global launches
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu=relu)
    bsz, h, wd, c = x.shape
    co = w.shape[-1]
    wq = w.to(x.dtype).contiguous()
    bq = None if b is None else b.float().contiguous()
    out = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=x.device)
    lib = build.load("conv3x3")
    fn = lib.egm_conv3x3
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    err = fn(x.data_ptr(), wq.data_ptr(), None if bq is None else bq.data_ptr(),
             out.data_ptr(), bsz, h, wd, c, co, int(relu), DTYPE_CODES[x.dtype],
             stream_handle(x.device))
    build.check_launch(err, "conv3x3_gemm")
    launches += 1
    return out


def pair_tile(cm: int, co: int, itemsize: int) -> tuple:
    """``(TH, TW, BN)`` of the pair kernel for a mid width ``cm``: the
    largest tile whose ``(TH+2)(TW+2)*cm`` intermediate fits shared memory
    beside the staging buffers; ``BN`` = 32 where both convs are at most 32
    wide, else 64."""
    bn = 32 if max(cm, co) <= 32 else 64
    staging = 4 * 16 * (64 + 4 + bn)
    for th, tw in PAIR_TILES:
        if staging + (th + 2) * (tw + 2) * cm * itemsize <= PAIR_SMEM_LIMIT:
            return th, tw, bn
    raise ValueError(f"conv3x3_pair_gemm: a mid width of {cm} channels does "
                     "not fit shared memory at the smallest tile")


def pair_flops(shape, cm: int, co: int, itemsize: int) -> tuple:
    """``(needed, executed)`` FLOPs of one pair call on ``shape`` =
    (B, H, W, C): what the function needs, and what the kernel runs with
    conv1 recomputed on each tile's halo and every 64 x BN x 16 sub-tile
    padded out."""
    b, h, w, c = shape
    needed = 2.0 * b * h * w * 9 * (c * cm + cm * co)
    th, tw, bn = pair_tile(cm, co, itemsize)
    up = lambda n, m: -(-n // m) * m
    tiles = b * -(-h // th) * -(-w // tw)
    stage1 = up((th + 2) * (tw + 2), 64) * up(cm, bn) * up(9 * c, 16)
    stage2 = up(th * tw, 64) * up(co, bn) * up(9 * cm, 16)
    return needed, 2.0 * tiles * (stage1 + stage2)


def _check_pair(x, w1, b1, w2, b2):
    check_activation("x", x)
    c = x.shape[-1]
    if w1.ndim != 4 or tuple(w1.shape[:3]) != (3, 3, c):
        raise ValueError(f"w1 must be (3, 3, {c}, Cm) HWIO, got {tuple(w1.shape)}")
    cm = w1.shape[-1]
    if w2.ndim != 4 or tuple(w2.shape[:3]) != (3, 3, cm):
        raise ValueError(f"w2 must be (3, 3, {cm}, Co) HWIO, got {tuple(w2.shape)}")
    co = w2.shape[-1]
    if min(c, cm, co) < 1:
        raise ValueError(f"empty channel axis: C={c}, Cm={cm}, Co={co}")
    if x.shape[0] > 65535:  # the batch is the grid's z axis
        raise ValueError(f"batch {x.shape[0]} exceeds 65535")
    for name, b, n in (("b1", b1, cm), ("b2", b2, co)):
        if tuple(b.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(b.shape)}")
    check_same_device(("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))


def conv3x3_pair_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The pair kernel's function in plain PyTorch: conv1 in float32, bias,
    ReLU, rounded to x's dtype, then conv2 the same way."""
    return conv3x3_plain(conv3x3_plain(x, w1, b1, relu=True), w2, b2, relu=True)


def conv3x3_pair_gemm(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) contiguous, float32 or bfloat16; w1 (3, 3, C, Cm) and
    w2 (3, 3, Cm, Co) HWIO, cast to x's dtype; b1 (Cm,) and b2 (Co,), added in
    float32.  Returns (B, H, W, Co) in x's dtype."""
    global pair_launches
    _check_pair(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return conv3x3_pair_plain(x, w1, b1, w2, b2)
    bsz, h, wd, c = x.shape
    cm, co = w1.shape[-1], w2.shape[-1]
    th, tw, bn = pair_tile(cm, co, x.element_size())
    w1q, w2q = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    b1q, b2q = b1.float().contiguous(), b2.float().contiguous()
    out = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("conv3x3_pair")
    fn = lib.egm_conv3x3_pair
    fn.argtypes = [_P] * 6 + [_I] * 10 + [_P]
    fn.restype = _I
    err = fn(x.data_ptr(), w1q.data_ptr(), b1q.data_ptr(), w2q.data_ptr(),
             b2q.data_ptr(), out.data_ptr(), bsz, h, wd, c, cm, co, th, tw, bn,
             DTYPE_CODES[x.dtype], stream_handle(x.device))
    build.check_launch(err, "conv3x3_pair_gemm")
    pair_launches += 1
    return out
