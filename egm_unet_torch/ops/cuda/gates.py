"""The MCALayer's three gate vectors (kernel K7).

Replaces no TPU kernel: the JAX package computes the gates in plain jnp
(``egm_unet_tpu/nn/attention.py::MCAGate``).  For each image and each axis of
H, W and C of an NHWC map x, in float32:

    avg = mean of x over the other two axes
    std = sqrt(mean((x - avg)^2) * n / (n - 1))          centred, two passes
    g   = sigmoid(conv1d(0.5 (avg + std) + sigmoid(w0) avg + sigmoid(w1) std,
                         k, zero padding (k - 1) // 2))

The float32 vectors g_h [B, H], g_w [B, W], g_c [B, C] are what K1
(``mca.mca_fused``) applies.  Two reads of x bound the function.  The CUDA
kernel (``csrc/mca_gates.cu``) is three launches.  Each image's rows are cut
into ``mca_gates_bands`` bands, from W * C alone; pass 1 (sums) and pass 2
(squared deviations from the means) split the batch's bands evenly over
``mca_gates_schedule``'s G blocks and leave each band's sums in scratch; in
pass 1 the block that finishes an image's last band (an integer counter an
image, which it resets) reduces them into the means; a third launch, one
block an image and axis, reduces pass 2's and computes the vectors.  Every
sum is taken in a fixed order over a fixed cut of the image, so an image's
gates are the same bits in any batch, and no float atomics are used.  A
thread owns 8 channels of a pixel (``"vec16"``: 16-byte loads) where C % 8
== 0 and x is 16-byte aligned, else one channel (``"scalar"``);
``mca_gates_lanes`` gives the lanes a pixel.  ``mca_gates_blocks``,
``mca_gates_scratch_floats`` and ``mca_gates_smem_bytes`` repeat the
kernel's split of the bands, its scratch and its shared memory for the
host-side tests.

``mca_gates`` launches the kernel for CUDA tensors and runs
``mca_gates_plain``, the gates as ``nn/attention.py::MCAGate`` computes them,
for CPU tensors.  The plain version is also the route of the training graph
and of a map split by rows over a spatial group (``parallel/halo.py``): the
reductions over H sum over the group, and the H gate's conv fetches its halo.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, SMEM_LIMIT, check_activation,
                                            check_no_autograd, check_same_device,
                                            sm_count, stream_handle)
from egm_unet_torch.parallel.halo import halo, spatial_sum
from egm_unet_torch.parallel.mesh import spatial

# one count a call (three CUDA launches)
_GATES = build.Entry("mca_gates", "mca_gates", "egm_mca_gates", "p" * 13 + "i" * 14 + "p")

NT = 256  # threads of a block
BLOCKS_PER_SM = 3  # the pass kernels' launch bounds
BAND_ELEMENTS = 65536  # elements of a band, about
RING = 16  # rows of per-warp row sums a block holds between flushes
MAX_CHANNELS = 2048  # 256 lanes x 8 channels


GateParams = Sequence[Tuple[torch.Tensor, torch.Tensor]]  # (weight [2], conv [k]) for H, W, C


def gate_stats_plain(x: torch.Tensor, axis: int) -> tuple:
    """(avg, std), float32 [B, L], of the gate along ``axis`` (1=H, 2=W, 3=C):
    over the other two axes, std centred in two passes with the Bessel
    factor n/(n-1).  Under a spatial group the reductions over H sum over
    the group."""
    reduce_axes = tuple(a for a in (1, 2, 3) if a != axis)
    sp = spatial()
    split = sp is not None and axis != 1  # a reduction over H
    n = 1
    for a in reduce_axes:
        n *= sp.height if split and a == 1 else x.shape[a]
    xf = x.float()
    keep = [x.shape[0], 1, 1, 1]
    keep[axis] = x.shape[axis]
    if split:
        avg = spatial_sum(xf.sum(dim=reduce_axes)) / n
        var = spatial_sum(((xf - avg.reshape(keep)) ** 2).sum(dim=reduce_axes)) / n
    else:
        avg = xf.mean(dim=reduce_axes)
        var = ((xf - avg.reshape(keep)) ** 2).mean(dim=reduce_axes)
    std = (var * (n / max(n - 1, 1))).sqrt()
    return avg, std


def gate_plain(x: torch.Tensor, axis: int, weight: torch.Tensor,
               conv: torch.Tensor) -> torch.Tensor:
    """One gate along ``axis``: the blend 0.5*(avg+std) + sigmoid(w0)*avg +
    sigmoid(w1)*std, the zero-padded 1-D conv, the sigmoid; float32 [B, L]."""
    avg, std = gate_stats_plain(x, axis)
    sw = torch.sigmoid(weight)
    blended = 0.5 * (avg + std) + sw[0] * avg + sw[1] * std
    k = conv.shape[0]
    pad = (k - 1) // 2
    if spatial() is not None and axis == 1:
        blended, pad = halo(blended, pad), 0
    return torch.sigmoid(F.conv1d(blended[:, None, :], conv.float()[None, None, :],
                                  padding=pad)[:, 0, :]).contiguous()


def mca_gates_plain(x: torch.Tensor, params: GateParams) -> tuple:
    """(g_h, g_w, g_c) in plain PyTorch; ``params`` the (weight, conv) pairs
    of the H, W and C gates."""
    return tuple(gate_plain(x, axis, w, k) for axis, (w, k) in zip((1, 2, 3), params))


def mca_gates_variant(dtype: torch.dtype, c: int, aligned: bool = True) -> str:
    """The kernel ``mca_gates`` runs for CUDA tensors of ``dtype`` with C
    channels: ``"vec16"`` (8 channels a thread, 16-byte loads) where C % 8
    == 0 and x lies on a 16-byte boundary (``aligned``), else ``"scalar"``."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    return "vec16" if c % 8 == 0 and aligned else "scalar"


def mca_gates_lanes(c: int, vec: int) -> tuple:
    """(L, K, PL) for C channels in chunks of ``vec`` (8 or 1): L lanes a
    pixel (a power of two, at most 256), K chunks a lane, PL = 256 / L
    pixels a step."""
    ch = c // vec
    lanes = min(NT, 1 << (ch - 1).bit_length())
    return lanes, -(-ch // lanes), NT // lanes


def mca_gates_bands(h: int, w: int, c: int) -> int:
    """P: bands an image, of about ``BAND_ELEMENTS`` elements (at least a
    row); band p holds rows [p H / P, (p + 1) H / P).  The cut depends on
    the image's shape alone, never on the batch."""
    rows = max(1, min(h, BAND_ELEMENTS // (w * c)))
    return -(-h // rows)


def mca_gates_schedule(nb: int, sms: int) -> int:
    """G: blocks of a pass over nb = B * P bands, three an SM, at most one a
    band."""
    return min(nb, BLOCKS_PER_SM * sms)


def mca_gates_blocks(j: int, nb: int, g: int) -> tuple:
    """The bands [q0, q1) that block j of g takes (band q is band q % P of
    image q // P)."""
    return j * nb // g, (j + 1) * nb // g


def mca_gates_scratch_floats(b: int, h: int, w: int, c: int, p: int) -> int:
    """Scratch of one call in floats: row sums and row deviations [B*H], the
    means [B][W+C], then the column and channel sums of both passes,
    [B][P][W] and [B][P][C]."""
    return 2 * b * h + b * (w + c) + 2 * b * p * (w + c)


def mca_gates_smem_bytes(w: int, c: int, vec: int, dev: bool) -> int:
    """Dynamic shared memory of a pass block (``csrc/mca_gates.cu::
    pass_smem_floats``): the column sums [W][max(1, L/32)], the pixel lanes'
    channel sums [PL][C], the ring of row sums [RING][8 warps] and its rows,
    and in pass 2 the means [W] and [C]."""
    lanes, _, pl = mca_gates_lanes(c, vec)
    floats = w * max(1, lanes // 32) + pl * c + RING * (NT // 32) + RING
    return 4 * (floats + (w + c if dev else 0))


_counters = {}  # (device, stream) -> int32 counters, zero between calls


def _image_counters(device: torch.device, stream: int, b: int) -> torch.Tensor:
    """Pass 1's counters of finished bands, one an image: zeroed once, left
    zero by every call, one buffer a stream so that concurrent streams
    never share one."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < b:
        buf = _counters[key] = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
    return buf


def _check(x: torch.Tensor, params: GateParams) -> list:
    check_activation("x", x)
    if len(params) != 3:
        raise ValueError(f"params must hold the H, W and C gates' (weight, conv), got "
                         f"{len(params)}")
    flat = []
    for axis, (w, k) in zip("HWC", params):
        for name, t in ((f"weight_{axis}", w), (f"conv_{axis}", k)):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{name} must be a torch.Tensor")
            if t.dtype not in DTYPE_CODES:
                raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if tuple(w.shape) != (2,):
            raise ValueError(f"weight_{axis} must be (2,), got {tuple(w.shape)}")
        if k.ndim != 1 or k.shape[0] % 2 == 0:
            raise ValueError(f"conv_{axis} must be 1-D of odd length, got {tuple(k.shape)}")
        flat += [w, k]
    if len({t.dtype for t in flat}) > 1:
        raise TypeError("the gates' parameters must share one dtype")
    check_same_device(("x", x), *((f"param{i}", t) for i, t in enumerate(flat)))
    return flat


def mca_gates(x: torch.Tensor, params: GateParams, stats: bool = False):
    """x (B, H, W, C) contiguous, float32 or bfloat16; ``params`` the (weight
    [2], conv [k]) pairs of the H, W and C gates, one dtype.  Returns the
    float32 gates (g_h, g_w, g_c); with ``stats``, also the (avg, std) pair of
    each axis, float32 [B, L], which the kernel leaves beside them."""
    flat = _check(x, params)
    check_no_autograd("mca_gates", x, *flat)
    if x.device.type == "cpu":
        gates = mca_gates_plain(x, params)
        if not stats:
            return gates
        return gates, tuple(gate_stats_plain(x, axis) for axis in (1, 2, 3))
    if spatial() is not None:
        raise ValueError("mca_gates takes whole images; under a spatial group the "
                         "gates take the plain route (mca_gates_plain)")
    b, h, w, c = x.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"the kernel takes at most {MAX_CHANNELS} channels, got {c}")
    if b * h >= 2 ** 31 or w * c >= 2 ** 31:
        raise ValueError(f"x of shape {tuple(x.shape)}: the kernel indexes rows and a "
                         "row's elements with 32-bit integers")
    vec = 8 if mca_gates_variant(x.dtype, c, x.data_ptr() % 16 == 0) == "vec16" else 1
    if mca_gates_smem_bytes(w, c, vec, True) > SMEM_LIMIT:
        raise ValueError(f"W = {w} needs more shared memory than a block has")
    lanes, k, _ = mca_gates_lanes(c, vec)
    p = mca_gates_bands(h, w, c)
    g = mca_gates_schedule(b * p, sm_count(x.device))
    f32 = dict(device=x.device, dtype=torch.float32)
    scratch = torch.empty(mca_gates_scratch_floats(b, h, w, c, p), **f32)
    out = [torch.empty(b, m, **f32) for m in (h, w, c)]
    st = torch.empty(b, 2, h + w + c, **f32) if stats else None
    stream = stream_handle(x.device)
    count = _image_counters(x.device, stream, b)
    _GATES(x.data_ptr(), *(t.data_ptr() for t in flat), *(o.data_ptr() for o in out),
           None if st is None else st.data_ptr(), scratch.data_ptr(), count.data_ptr(),
           b, h, w, c, *(int(t.shape[0]) for t in flat[1::2]), vec, lanes, k, p, g,
           DTYPE_CODES[x.dtype], DTYPE_CODES[flat[0].dtype], stream)
    gates = tuple(out)
    if not stats:
        return gates
    return gates, tuple((st[:, 0, lo:hi], st[:, 1, lo:hi])
                        for lo, hi in ((0, h), (h, h + w), (h + w, h + w + c)))
