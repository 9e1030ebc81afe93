"""3x3 / stride 1 / pad 1 convolution + bias + optional ReLU (kernel K2),
and the fused pair of two such convolutions (kernel K3).

``conv3x3_gemm`` replaces ``egm_unet_tpu/ops/pallas/conv3x3.py::conv3x3_gemm``
(``csrc/conv3x3.cu``): an implicit GEMM over M = B*H*W pixels, N = Co,
K = 9*C with float32 accumulation; zero padding comes from the loads, so no
padded copy is written and any C works.  ``conv3x3_variant`` names the kernel
a dtype gets:

- ``"mma_bf16"`` (bfloat16): the tensor-core implicit-GEMM stage of
  ``csrc/igemm_mma.cuh`` (``mma.sync`` fed by ``ldmatrix`` from bf16 tiles
  that the TMA unit or ``cp.async`` fills), a block owning a pixel tile and a
  chunk of output columns; ``conv3x3_tile`` picks the tile: resident weights
  and persistent blocks at the narrow sites, the TMA unit's tiles at the wide
  aligned ones, ``cp.async`` / scalar loads otherwise.
- ``"cuda_cores_f32"`` (float32): the CUDA-core implicit GEMM of
  ``csrc/common.cuh``, which holds 1e-4 relative.

``conv3x3_pair_gemm`` replaces
``egm_unet_tpu/ops/pallas/conv3x3.py::conv3x3_pair_gemm``: the folded
DoubleConv ``relu(conv2(relu(conv1(x) + b1)) + b2)`` in one launch
(``csrc/conv3x3_pair.cu``).  A block owns a tile of output pixels and all of
Co; conv1's output on the tile and a one-pixel halo stays in shared memory in
the working dtype, zeroed where the halo lies outside the image (conv2's zero
padding), and never reaches device memory.  ``pair_variant`` names the kernel
a dtype gets: bfloat16 multiplies both GEMMs on the tensor cores (the same
stage as K2); float32 stays on the CUDA cores, which hold 1e-4 relative.
``pair_tile`` picks the tile by Cm and dtype so that the intermediate and the
variant's staging buffers fit the 227 KB a block may use.

``conv3x3_gemm`` and ``conv3x3_pair_gemm`` launch their kernels for CUDA
tensors and run ``conv3x3_plain`` / ``conv3x3_pair_plain`` for CPU tensors;
nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, SMEM_LIMIT, check_activation,
                                            check_no_autograd,
                                            check_same_device, stream_handle)

_GEMM = build.Entry("conv3x3_gemm", "conv3x3", "egm_conv3x3", "p" * 4 + "i" * 11 + "p")
_PAIR = build.Entry("conv3x3_pair_gemm", "conv3x3_pair", "egm_conv3x3_pair",
                    "p" * 6 + "i" * 12 + "p")

# csrc/conv3x3_pair.cu: tiles (TH, TW) in order of preference.  The
# tensor-core kernel keeps a ring of slots, each 16 channels (PAIR_CC) of the
# input halo and the nine taps' weight tile for them, ``ring_depth(wider
# column chunk)`` deep.  Where all weight
# tiles fit beside the intermediate and a ring of two input-halo chunks in
# half an SM's shared memory (PAIR_RESIDENT_LIMIT), they stay resident, a
# block walks many 8x16 tiles, and the column chunks (BN1, BN2) are the
# narrowest of PAIR_RESIDENT_CHUNKS that cover Cm and Co.  Without resident
# weights the two largest tiles are filled by the TMA unit (dense swizzled
# slots), the smaller ones by cp.async (padded slots).  The CUDA-core kernel
# stages one K chunk of 16 as float32 (16 x (64 + 4 + BN)).
PAIR_TILES = ((16, 16), (8, 16), (8, 8), (4, 4), (2, 2))
PAIR_TMA_TILES = ((16, 16), (8, 16))  # without resident weights: filled by the TMA unit
PAIR_RESIDENT_LIMIT = 233472 // 2 - 1024  # two blocks per SM, 1 KB reserved each
PAIR_CC = 16
PAIR_RESIDENT_CHUNKS = ((32, 32), (64, 32), (64, 64))

# csrc/conv3x3.cu (K2), bfloat16: how a tile's ring is filled (the C entry
# point's mode codes); the column chunks whose weights may stay resident (16
# and 32 narrow enough for Co = 8 .. 32 without padding to 64); and the TMA
# unit's tiles (TH, TW, BN, mode), the first whose BN covers Co, 128-column
# chunks above 64.
CONV_MODES = {"async": 0, "resident": 1, "tma": 2, "cuda_cores": -1}
CONV_RESIDENT_CHUNKS = (16, 32, 64)
CONV_TMA_TILES = ((8, 16, 32, "tma"), (16, 16, 64, "tma"), (8, 16, 128, "tma"))



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
    _check(x, w, b)
    check_no_autograd("conv3x3_gemm", x, w, b)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu=relu)
    bsz, h, wd, c = x.shape
    co = w.shape[-1]
    wq = w.to(x.dtype).contiguous()
    bq = None if b is None else b.float().contiguous()
    out = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    th, tw, bn, mode = conv3x3_tile(
        c, co, x.element_size(),
        aligned=all(t.data_ptr() % 16 == 0 for t in (x, wq)))
    _GEMM(x.data_ptr(), wq.data_ptr(), None if bq is None else bq.data_ptr(),
          out.data_ptr(), bsz, h, wd, c, co, int(relu), th, tw, bn,
          CONV_MODES[mode], DTYPE_CODES[x.dtype], stream_handle(x.device))
    return out


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv3x3_variant(dtype: torch.dtype) -> str:
    """The kernel ``conv3x3_gemm`` launches for CUDA tensors of ``dtype``:
    ``"mma_bf16"`` (tensor cores) or ``"cuda_cores_f32"``."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    return "mma_bf16" if dtype == torch.bfloat16 else "cuda_cores_f32"


def cuda_core_tile(co: int) -> tuple:
    """The float32 CUDA-core kernel's tile (``common.cuh::launch_igemm3x3``,
    shared by K2 and K5): ``(1, BM, BN, "cuda_cores")``, a run of BM pixels by
    BN output columns, picked by Co."""
    bm, bn = (128, 16) if co <= 16 else (128, 32) if co <= 32 else (64, 64)
    return (1, bm, bn, "cuda_cores")


def ring_depth(bn: int) -> int:
    """Slots of the tensor-core stage's ring for BN-column chunks
    (``csrc/igemm_mma.cuh::ring_depth``)."""
    return 4 if bn <= 32 else 3 if bn <= 64 else 2


def ring_slot(th: int, tw: int, bn: int, mode: str) -> tuple:
    """``(elements of a ring slot's halo chunk, of its weight tile, ring
    depth)`` of the tensor-core stage (``csrc/igemm_mma.cuh::Slots``) for a
    TH x TW pixel tile with BN-column chunks: by the TMA unit dense swizzled
    tiles, the chunk in 512-element units, the weights one [9*16, 64] box per
    64 columns; pitched tiles otherwise; with resident weights the slots hold
    the halo chunk only, two deep."""
    halo = (th + 2) * (tw + 2)
    if mode == "tma":
        return _up(halo * PAIR_CC, 512), -(-bn // 64) * 9 * PAIR_CC * 64, ring_depth(bn)
    xbuf = halo * (PAIR_CC + 8)
    if mode == "resident":
        return xbuf, 0, 2
    return xbuf, 9 * PAIR_CC * (bn + 8), ring_depth(bn)


def resident_weights(chunks: int, co: int, bn: int) -> int:
    """Elements of the resident weight tiles: ``chunks`` 16-channel steps x
    the BN-column chunks of Co, each a padded [9*16, BN + 8] tile."""
    return -(-co // bn) * chunks * 9 * PAIR_CC * (bn + 8)


def conv3x3_smem_bytes(tile: tuple, c: int, co: int, itemsize: int) -> int:
    """Shared memory of one block of K2 at ``tile`` = (TH, TW, BN, mode), as
    ``csrc/conv3x3.cu`` lays it out (float32: the CUDA-core kernel's static
    staging of one K chunk of 16)."""
    th, tw, bn, mode = tile
    if itemsize == 4:
        return 4 * 16 * (tw + 4 + bn)
    xbuf, wtile, ring = ring_slot(th, tw, bn, mode)
    n = ring * (xbuf + wtile)
    if mode == "resident":
        n += resident_weights(-(-c // PAIR_CC), co, bn)
    return 2 * n + (1024 if mode == "tma" else 0)


def conv3x3_tile(c: int, co: int, itemsize: int, aligned: bool = True) -> tuple:
    """``(TH, TW, BN, mode)`` of K2 for the widths C -> Co: the pixel tile,
    the column chunk and how the ring is filled.  bfloat16 (tensor cores):
    8x16 with all weights resident in shared memory (``"resident"``) where
    they fit ``PAIR_RESIDENT_LIMIT`` in the narrowest chunk of
    ``CONV_RESIDENT_CHUNKS`` that covers Co; else the TMA unit's tiles
    (``"tma"``; they need C and Co multiples of 8 and x, w on 16-byte
    boundaries, ``aligned``): 8x16 with 32 columns where Co <= 32, 16x16 with
    64 where Co <= 64, else 8x16 with 128, the chunks of Co on the grid; else
    8x16 with 64 columns by ``cp.async`` or scalar loads (``"async"``).
    float32: ``cuda_core_tile``."""
    if itemsize == 4:
        return cuda_core_tile(co)
    for bn in CONV_RESIDENT_CHUNKS:
        if co <= bn:
            tile = (8, 16, bn, "resident")
            if conv3x3_smem_bytes(tile, c, co, itemsize) <= PAIR_RESIDENT_LIMIT:
                return tile
            break
    if aligned and c % 8 == 0 and co % 8 == 0:
        return next(t for t in CONV_TMA_TILES if co <= t[2] or t[2] == 128)
    return (8, 16, 64, "async")


def conv3x3_flops(shape, co: int, itemsize: int) -> tuple:
    """``(needed, executed)`` FLOPs of one K2 call on ``shape`` = (B, H, W,
    C): what the function needs, and what the kernel runs with its tiles
    padded out: whole pixel tiles, N to the column chunk and each tap's
    channels to 16 on the tensor cores; M to BM, N to BN and K = 9*C to 16
    on the CUDA cores."""
    b, h, w, c = shape
    needed = 2.0 * b * h * w * 9 * c * co
    th, tw, bn, _ = conv3x3_tile(c, co, itemsize)
    if itemsize == 4:
        return needed, 2.0 * _up(b * h * w, tw) * _up(co, bn) * _up(9 * c, 16)
    tiles = b * -(-h // th) * -(-w // tw)
    return needed, 2.0 * tiles * th * tw * _up(co, bn) * 9 * _up(c, 16)


def pair_variant(dtype: torch.dtype) -> str:
    """The kernel ``conv3x3_pair_gemm`` launches for CUDA tensors of
    ``dtype``: ``"mma_bf16"`` (tensor cores) or ``"cuda_cores_f32"``."""
    return conv3x3_variant(dtype)


def pair_smem_bytes(tile: tuple, c: int, cm: int, co: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the pair kernel at ``tile`` =
    (TH, TW, BN1, BN2, resident), as ``csrc/conv3x3_pair.cu`` lays it out:
    the intermediate, then the ring of stage 1's (TH+2) x (TW+2) positions
    (``ring_slot``) for the wider column chunk, then any resident weights."""
    th, tw, bn1, bn2, resident = tile
    halo = (th + 2) * (tw + 2)
    if itemsize == 4:  # float32 staging of one K chunk + the intermediate
        return 4 * 16 * (64 + 4 + bn1) + halo * cm * 4
    mode = "resident" if resident else "tma" if (th, tw) in PAIR_TMA_TILES else "async"
    xbuf, wtile, ring = ring_slot(th + 2, tw + 2, max(bn1, bn2), mode)
    n = halo * (_up(cm, 16) + 8) + ring * (xbuf + wtile)  # mid pitch off the 128-byte grid
    if resident:
        n += resident_weights(-(-c // PAIR_CC), cm, bn1) \
            + resident_weights(-(-cm // PAIR_CC), co, bn2)
    return 2 * n + (1024 if mode == "tma" else 0)


def pair_tile(c: int, cm: int, co: int, itemsize: int, aligned: bool = True) -> tuple:
    """``(TH, TW, BN1, BN2, resident)`` of the pair kernel for the widths
    C -> Cm -> Co: the pixel tile, the column chunk of each stage (wider
    stages walk their columns in chunks), and whether the weights stay
    resident in shared memory.  bfloat16 (tensor cores): the 8x16 tile with
    resident weights where that fits ``PAIR_RESIDENT_LIMIT``; else the largest
    tile whose shared memory fits: 16x16 (least halo work and weight traffic
    per pixel) with 64-column chunks, 8x16 with 128-column chunks, then 8x8,
    4x4, 2x2 with 64.  The first two are filled by the TMA unit alone, which
    copies 16-byte pieces: they need every channel count a multiple of 8 and
    x, w1, w2 on 16-byte boundaries (``aligned``).  float32 (CUDA cores): 8x16
    and down, 32 columns for both stages where both widths are at most 32,
    else 64."""
    tma_ok = aligned and c % 8 == 0 and cm % 8 == 0 and co % 8 == 0
    if itemsize == 2:
        for bn1, bn2 in PAIR_RESIDENT_CHUNKS:
            tile = (8, 16, bn1, bn2, True)
            if bn1 >= cm and bn2 >= co and pair_smem_bytes(
                    tile, c, cm, co, itemsize) <= PAIR_RESIDENT_LIMIT:
                return tile
    for th, tw in PAIR_TILES:
        if itemsize == 4:
            if (th, tw) == (16, 16):
                continue
            bn1 = bn2 = 32 if max(cm, co) <= 32 and (th, tw) == (8, 16) else 64
        elif (th, tw) in PAIR_TMA_TILES and not tma_ok:
            continue
        elif (th, tw) == (16, 16):
            bn1, bn2 = 64, 32 if co <= 32 else 64
        elif (th, tw) == (8, 16):
            bn1, bn2 = 128, 64 if co <= 64 else 128
        else:
            bn1 = bn2 = 64
        tile = (th, tw, bn1, bn2, False)
        if pair_smem_bytes(tile, c, cm, co, itemsize) <= SMEM_LIMIT:
            return tile
    raise ValueError(f"conv3x3_pair_gemm: a mid width of {cm} channels does "
                     "not fit shared memory at the smallest tile")


def pair_flops(shape, cm: int, co: int, itemsize: int) -> tuple:
    """``(needed, executed)`` FLOPs of one pair call on ``shape`` =
    (B, H, W, C): what the function needs, and what the kernel runs with
    conv1 recomputed on each tile's halo and every sub-tile padded out: M to
    16, N to the stage's column chunk and each tap's channels to 16 on the
    tensor cores; M to 64, N to BN and K = 9*C to 16 on the CUDA cores."""
    b, h, w, c = shape
    needed = 2.0 * b * h * w * 9 * (c * cm + cm * co)
    th, tw, bn1, bn2, _ = pair_tile(c, cm, co, itemsize)
    tiles = b * -(-h // th) * -(-w // tw)
    halo, pixels = (th + 2) * (tw + 2), th * tw
    if itemsize == 4:
        stage1 = _up(halo, 64) * _up(cm, bn1) * _up(9 * c, 16)
        stage2 = _up(pixels, 64) * _up(co, bn2) * _up(9 * cm, 16)
    else:
        stage1 = _up(halo, 16) * _up(cm, bn1) * 9 * _up(c, 16)
        stage2 = _up(pixels, 16) * _up(co, bn2) * 9 * _up(cm, 16)
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
    _check_pair(x, w1, b1, w2, b2)
    check_no_autograd("conv3x3_pair_gemm", x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return conv3x3_pair_plain(x, w1, b1, w2, b2)
    bsz, h, wd, c = x.shape
    cm, co = w1.shape[-1], w2.shape[-1]
    w1q, w2q = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
    th, tw, bn1, bn2, resident = pair_tile(
        c, cm, co, x.element_size(),
        aligned=all(t.data_ptr() % 16 == 0 for t in (x, w1q, w2q)))
    b1q, b2q = b1.float().contiguous(), b2.float().contiguous()
    out = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _PAIR(x.data_ptr(), w1q.data_ptr(), b1q.data_ptr(), w2q.data_ptr(),
          b2q.data_ptr(), out.data_ptr(), bsz, h, wd, c, cm, co, th, tw, bn1,
          bn2, int(resident), DTYPE_CODES[x.dtype], stream_handle(x.device))
    return out
