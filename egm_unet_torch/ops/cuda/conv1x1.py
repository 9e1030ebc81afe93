"""1x1 / stride 1 / pad 0 convolution + bias + optional ReLU as one GEMM
(kernel K9), bfloat16.

Replaces no TPU kernel: the JAX package leaves its 1x1 convolutions to XLA.
On the card the library route (``ops/conv.py::conv2d``, cuDNN) adds the bias
to cuDNN's output in one more pass over the map and a ReLU in a third; the
kernel (``csrc/conv1x1.cu``) computes

    out[m, n] = act(sum_k x[m, k] * w[k, n] + bias[n])

over the pixels m of the NHWC map, adds the bias and applies the ReLU to the
float32 accumulator in its epilogue and rounds once to bfloat16.  Persistent
blocks walk tiles of BM pixels for one slice of BN output columns, the
slice's weights resident in shared memory, the map streaming through a ring
of BM x KC stages; ``conv1x1_tile`` picks (BM, BN, KC) and
``conv1x1_smem_bytes`` repeats the kernel's shared memory for the host-side
tests.

``conv1x1_suits`` says where that design beats the library route: where
the slice its N asks for fits beside the ring, which the dispatch of the
folded graph (``nn/layers.py::takes_conv1x1``) requires.

``conv1x1_gemm`` launches the kernel for CUDA tensors and runs
``conv1x1_plain``, the float32 product, bias and ReLU rounded once, for CPU
tensors.  The folded graph's blocks (``nn/layers.py``, ``nn/grfb.py``) send
their bfloat16 1x1 convolutions here; float32 keeps ``conv2d``.
"""

from __future__ import annotations

from typing import Optional

import torch

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, SMEM_LIMIT, check_activation,
                                            check_no_autograd, check_same_device,
                                            stream_handle)

_GEMM = build.Entry("conv1x1_gemm", "conv1x1", "egm_conv1x1", "ppppl" + "i" * 7 + "p")

RING = 4  # stages of the map's ring (csrc/conv1x1.cu R)
STAGE_ELEMS = 8192  # BM x KC: elements a stage holds
ACC_ELEMS = 16384  # BM x BN: 64 float32 accumulators a thread of 256
CHUNKS = (16, 32, 64)  # KC, the channels of a pipeline step
SLICES = (16, 32, 64, 128)  # BN, the output columns of a block
SMALL_M = 128  # BM of a map of at most this many pixels


def _check(x, w, b):
    check_activation("x", x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv1x1_gemm takes bfloat16 maps, got {x.dtype}")
    k = x.shape[-1]
    if w.ndim != 4 or tuple(w.shape[:3]) != (1, 1, k):
        raise ValueError(f"w must be (1, 1, {k}, N) HWIO, got {tuple(w.shape)}")
    n = w.shape[-1]
    if k % 8 or n % 8 or k < 8 or n < 8:
        raise ValueError(f"K = {k} and N = {n} must be positive multiples of 8")
    if b is not None:
        if tuple(b.shape) != (n,):
            raise ValueError(f"b must be ({n},), got {tuple(b.shape)}")
        if b.dtype not in DTYPE_CODES:
            raise TypeError(f"b must be float32 or bfloat16, got {b.dtype}")
    check_same_device(("x", x), ("w", w), ("b", b))


def conv1x1_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                  relu: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the float32 product of the
    working-dtype operands, the float32 bias and ReLU, one rounding at the
    end."""
    k, n = w.shape[2], w.shape[3]
    y = x.reshape(-1, k).float() @ w.reshape(k, n).to(x.dtype).float()
    if b is not None:
        y = y + b.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).reshape(*x.shape[:-1], n)


def _warps_n(bn: int) -> int:
    """Warps along N of the eight (csrc/conv1x1.cu WN)."""
    return 1 if bn <= 32 else 2


def conv1x1_smem_bytes(tile: tuple, k: int) -> int:
    """Dynamic shared memory of one block at ``tile`` = (BM, BN, KC) for K
    input channels: ``RING`` stages of BM rows of KC + 8, the resident
    weights (K rounded up to KC rows of BN + 8) and each warp's staging rows
    (its BM x WN / 8 rows of BN / WN + 8), in bfloat16."""
    bm, bn, kc = tile
    wn = _warps_n(bn)
    kp = -(-k // kc) * kc
    return 2 * (RING * bm * (kc + 8) + kp * (bn + 8) + 8 * (bm * wn // 8) * (bn // wn + 8))


def slice_for(n: int) -> int:
    """The narrowest of ``SLICES`` that covers N (128 above)."""
    return next((s for s in SLICES if n <= s), SLICES[-1])


def conv1x1_tile(k: int, n: int, m: int) -> tuple:
    """``(BM, BN, KC)`` for K -> N on M pixels: KC the narrowest of
    ``CHUNKS`` that covers K (64 above), BN the narrowest of ``SLICES`` that
    covers N (128 above: N in slices of 128), halved while the block's shared
    memory passes ``SMEM_LIMIT``, and BM the most that keeps a stage at
    ``STAGE_ELEMS`` and a thread at 64 accumulators, or ``SMALL_M`` where M
    is at most that (a larger tile would only multiply zeros)."""
    kc = next((c for c in CHUNKS if k <= c), CHUNKS[-1])
    bn = slice_for(n)
    while True:
        bm = SMALL_M if m <= SMALL_M else min(STAGE_ELEMS // kc, ACC_ELEMS // bn)
        tile = (bm, bn, kc)
        if conv1x1_smem_bytes(tile, k) <= SMEM_LIMIT:
            return tile
        if bn == SLICES[0]:
            raise ValueError(f"conv1x1_gemm: K = {k} does not fit shared memory")
        bn //= 2


def conv1x1_suits(k: int, n: int, m: int) -> bool:
    """Whether K9's resident-weight design suits K -> N on M pixels: the
    slice ``conv1x1_tile`` keeps in shared memory is the one N asks for
    (``slice_for``).  Where K is too wide for it, the tile halves the slice
    and each of the N / BN slices streams the map again; there cuDNN's conv
    with its bias and ReLU passes is as fast or faster.  At batch 32 of the
    576x768 bucket (H100 80GB HBM3, 700 W; PERF.md) K9 took 0.41x cuDNN's
    time at 256
    -> 768 on the 144x192 grid (BN 128), 1.06x at 512 -> 768 (BN 64), 2.9x
    at 1024 -> 768 (BN 32) and 2.8x at SegFormer's 3072 -> 768 head fuse
    (BN 16); every EGM-UNet site keeps its slice."""
    try:
        bn = conv1x1_tile(k, n, m)[1]
    except ValueError:  # no slice of K rows fits shared memory
        return False
    return bn == slice_for(n)


def conv1x1_flops(m: int, k: int, n: int) -> tuple:
    """``(needed, executed)`` FLOPs of one call on M pixels: what the function
    needs, and what the kernel runs with M padded to BM, N to BN and K to 16
    (the steps past K are skipped)."""
    bm, bn, _ = conv1x1_tile(k, n, m)
    up = lambda v, q: -(-v // q) * q
    return 2.0 * m * k * n, 2.0 * up(m, bm) * up(n, bn) * up(k, 16)


def conv1x1_gemm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                 relu: bool = False) -> torch.Tensor:
    """x (B, H, W, K) contiguous bfloat16; w (1, 1, K, N) HWIO, cast to
    bfloat16; b (N,) float32 or bfloat16, or None, added in float32; K and N
    multiples of 8.  Returns (B, H, W, N) bfloat16."""
    _check(x, w, b)
    check_no_autograd("conv1x1_gemm", x, w, b)
    if x.device.type == "cpu":
        return conv1x1_plain(x, w, b, relu=relu)
    k, n = w.shape[2], w.shape[3]
    wq = w.to(x.dtype).contiguous()
    bq = None if b is None else b.contiguous()
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("conv1x1_gemm takes x and w on 16-byte boundaries")
    m = x.numel() // k
    bm, bn, kc = conv1x1_tile(k, n, m)
    _GEMM(x.data_ptr(), wq.data_ptr(), None if bq is None else bq.data_ptr(), out.data_ptr(),
          m, k, n, int(relu), -1 if bq is None else DTYPE_CODES[bq.dtype],
          bm, bn, kc, stream_handle(x.device))
    return out
