"""Host-side choices of the tensor-core kernels K2 (``conv3x3_gemm``) and K5
(``up_concat_conv``): the variant a dtype gets, the tile each width picks and
its shared memory (counted by hand here from the layouts of
``csrc/conv3x3.cu`` and ``csrc/up_concat_conv.cu``), the FLOP counts, and
K5's producer step (the x1 patch a tile stages and the blend that forms the
upsampled half of the A tile from it), emulated in PyTorch against the
upsample the plain version runs.  All of it runs on the CPU in milliseconds;
the kernels themselves are held against their plain versions on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from egm_unet_torch.ops.cuda import conv3x3, upconv
from egm_unet_torch.ops.resize import (upsample2x_bilinear_align_corners,
                                       upsample2x_taps)

RESIDENT_LIMIT = conv3x3.PAIR_RESIDENT_LIMIT  # two blocks per SM
SMEM_LIMIT = conv3x3.SMEM_LIMIT               # what one block may opt into


def _cdiv(a, b):
    return -(-a // b)


def _hand_smem(tile, chunks, co, abuf):
    """Bytes of a bf16 K2 / K5 block: R ring slots (a 16-channel halo chunk,
    and the [9*16, BN] weight tile unless the weights are resident), K5's
    blended A grid, the resident weight tiles; TMA tiles dense in 1 KB units
    plus 1 KB of alignment."""
    th, tw, bn, mode = tile
    halo = (th + 2) * (tw + 2)
    ring = 4 if bn <= 32 else 3 if bn <= 64 else 2
    if mode == "tma":
        xbuf = _cdiv(halo * 16 * 2, 1024) * 1024
        return ring * (xbuf + _cdiv(bn, 64) * 9 * 16 * 64 * 2) + (xbuf if abuf else 0) + 1024
    xbuf = halo * 24 * 2  # 16 channels at a pitch of 24
    wtile = 9 * 16 * (bn + 8) * 2
    if mode == "resident":
        return 2 * xbuf + (xbuf if abuf else 0) + _cdiv(co, bn) * chunks * wtile
    return ring * (xbuf + wtile) + (xbuf if abuf else 0)


RES16, RES32, RES64 = ((8, 16, bn, "resident") for bn in (16, 32, 64))
TMA32, TMA64, TMA128 = (8, 16, 32, "tma"), (16, 16, 64, "tma"), (8, 16, 128, "tma")

# K2: the widths of its 16 path shapes (the 576x768 32 -> 32 conv and the
# 72x96 / 36x48 256 -> 256 and 256 -> 32 convs share a width pair), then the
# edge shapes of chip_smoke.py::phase_edges
K2_TILES = [
    (3, 32, RES32), (32, 32, RES32),                      # in_conv, up4's second conv
    (32, 64, RES64), (64, 64, RES64), (64, 8, RES16),     # down1 + EGRFB ctx0
    (64, 128, TMA128), (128, 128, TMA128), (128, 16, RES16),  # down2
    (128, 256, TMA128), (256, 256, TMA128), (256, 32, TMA32),  # down3, down4
    (256, 128, TMA128), (128, 64, TMA64), (64, 32, RES32),     # up1..up3 second convs
    (3, 7, RES16), (5, 20, RES32), (33, 70, (8, 16, 64, "async")), (8, 5, RES16),
    (16, 24, RES32), (24, 40, RES64), (64, 136, TMA128),
    (256, 16, TMA32),  # 16 columns that do not fit resident: padded to 32, not 64
]

# K5: its four path sites, then the edge shapes of phase_edges
K5_TILES = [
    (256, 256, 256, TMA128), (128, 128, 128, TMA128), (64, 64, 64, (8, 16, 64, "tma")),
    (32, 32, 32, RES32),
    (10, 6, 9, RES16), (24, 40, 33, (8, 16, 64, "async")), (24, 16, 40, RES64),
    (8, 8, 16, RES16), (16, 16, 16, RES16), (48, 32, 136, TMA128), (24, 40, 72, TMA128),
]


@pytest.mark.parametrize("fn", [conv3x3.conv3x3_variant, upconv.upconv_variant])
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "mma_bf16"),
                                           (torch.float32, "cuda_cores_f32")])
def test_variants_are_functions_of_dtype(fn, dtype, variant):
    assert fn(dtype) == variant


@pytest.mark.parametrize("fn", [conv3x3.conv3x3_variant, upconv.upconv_variant])
def test_variants_reject_other_dtypes(fn):
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError):
            fn(dtype)


@pytest.mark.parametrize("c,co,tile", K2_TILES)
def test_conv3x3_tile_fits_shared_memory(c, co, tile):
    assert conv3x3.conv3x3_tile(c, co, 2) == tile
    need = conv3x3.conv3x3_smem_bytes(tile, c, co, 2)
    assert need == _hand_smem(tile, _cdiv(c, 16), co, abuf=False)
    assert need <= (RESIDENT_LIMIT if tile[3] == "resident" else SMEM_LIMIT)
    if tile[3] == "resident":  # one column chunk, no wider than needed
        assert co <= tile[2] and (tile[2] == 16 or co > tile[2] // 2)
    assert tile[0] * tile[1] % 16 == 0  # whole 16-row m-blocks


@pytest.mark.parametrize("c2,c1,co,tile", K5_TILES)
def test_upconv_tile_fits_shared_memory(c2, c1, co, tile):
    assert upconv.upconv_tile(c2, c1, co, 2) == tile
    need = upconv.upconv_smem_bytes(tile, c2, c1, co, 2)
    # each half pads its own last 16-channel chunk
    assert need == _hand_smem(tile, _cdiv(c2, 16) + _cdiv(c1, 16), co, abuf=True)
    assert need <= (RESIDENT_LIMIT if tile[3] == "resident" else SMEM_LIMIT)
    # the x1 patch of an 8x16 tile fits the ring slot of a halo chunk
    assert upconv.upconv_patch(tile[0]) * upconv.upconv_patch(tile[1]) \
        <= (tile[0] + 2) * (tile[1] + 2)


def test_float32_stays_on_the_cuda_cores():
    for co, tile in ((8, (1, 128, 16)), (32, (1, 128, 32)), (256, (1, 64, 64))):
        assert conv3x3.conv3x3_tile(64, co, 4) == (*tile, "cuda_cores")
        assert upconv.upconv_tile(64, 64, co, 4) == (*tile, "cuda_cores")
        assert conv3x3.conv3x3_smem_bytes((*tile, "cuda_cores"), 64, co, 4) \
            == 4 * 16 * (tile[1] + 4 + tile[2])


def test_tma_tiles_only_for_aligned_multiples_of_8():
    """The TMA unit copies 16-byte pieces of tensors whose rows are 16-byte
    multiples: its tiles go to aligned tensors whose channel counts are
    multiples of 8, everything else to cp.async / scalar loads."""
    widths = [(c, co) for c in (3, 8, 12, 16, 20, 64, 100, 256, 260)
              for co in (8, 12, 64, 70, 128, 136, 256)]
    for c, co in widths:
        for aligned in (True, False):
            mode = conv3x3.conv3x3_tile(c, co, 2, aligned=aligned)[3]
            if mode == "tma":
                assert aligned and c % 8 == 0 and co % 8 == 0, (c, co)
            elif mode != "resident":
                assert not (aligned and c % 8 == 0 and co % 8 == 0), (c, co)
            for c1 in (8, 20, 256):
                mode = upconv.upconv_tile(c, c1, co, 2, aligned=aligned)[3]
                ok = aligned and c % 8 == 0 and c1 % 8 == 0 and co % 8 == 0
                assert (mode == "tma") == (ok and mode != "resident"), (c, c1, co)
    assert conv3x3.conv3x3_tile(256, 256, 2, aligned=False) == (8, 16, 64, "async")
    assert upconv.upconv_tile(256, 256, 256, 2, aligned=False) == (8, 16, 128, "async")
    assert conv3x3.conv3x3_tile(64, 32, 2, aligned=False) == RES32  # cp.async either way


@pytest.mark.parametrize("shape,co,itemsize,hand", [
    # the stem: 8x16 tiles, C = 3 padded to 16 per tap, Co = 32 in one chunk
    ((8, 576, 768, 3), 32, 2, 2.0 * 8 * 72 * 48 * 128 * 32 * 9 * 16),
    # EGRFB ctx0: Co = 8 in a 16-column chunk
    ((8, 288, 384, 64), 8, 2, 2.0 * 8 * 36 * 24 * 128 * 16 * 9 * 64),
    # down4 at 36x48: 8x16 tiles, 36 rows = 4.5 tiles counted whole
    ((8, 36, 48, 256), 256, 2, 2.0 * 8 * 5 * 3 * 128 * 256 * 9 * 256),
    # up2's second conv: 16x16 tiles
    ((8, 144, 192, 128), 64, 2, 2.0 * 8 * 9 * 12 * 256 * 64 * 9 * 128),
    # float32: M to 64, N to 64, K = 9*C to 16
    ((1, 9, 11, 33), 70, 4, 2.0 * 128 * 128 * 304),
])
def test_conv3x3_flops_hand_counts(shape, co, itemsize, hand):
    needed, executed = conv3x3.conv3x3_flops(shape, co, itemsize)
    b, h, w, c = shape
    assert needed == 2.0 * b * h * w * 9 * c * co
    assert executed == hand and executed >= needed


@pytest.mark.parametrize("x2_shape,c1,co,itemsize,hand", [
    # up1: 72x96, 256 + 256 channels, two 128-column chunks
    ((8, 72, 96, 256), 256, 256, 2, 2.0 * 8 * 9 * 6 * 128 * 256 * 9 * 512),
    # up4: 576x768, 32 + 32, resident 32 columns
    ((8, 576, 768, 32), 32, 32, 2, 2.0 * 8 * 72 * 48 * 128 * 32 * 9 * 64),
    # C2 = 24 and C1 = 40 pad to 32 and 48; Co = 33 to 64
    ((1, 6, 8, 24), 40, 33, 2, 2.0 * 1 * 1 * 128 * 64 * 9 * 80),
    # float32: M = 48 to 64, N to 64, K = 9*64
    ((1, 6, 8, 24), 40, 33, 4, 2.0 * 64 * 64 * 576),
])
def test_upconv_flops_hand_counts(x2_shape, c1, co, itemsize, hand):
    needed, executed = upconv.upconv_flops(x2_shape, c1, co, itemsize)
    b, h, w, c2 = x2_shape
    assert needed == 2.0 * b * h * w * 9 * (c2 + c1) * co
    assert executed == hand and executed >= needed


def _blend(x1: torch.Tensor) -> torch.Tensor:
    """K5's producer step per output pixel: the four x1 taps of
    ``upsample2x_taps`` (weights rounded to the dtype), the row pass
    rounded to the dtype, then the column pass rounded again, in float32."""
    dtype = x1.dtype
    _, h, w, _ = x1.shape
    rlo, rhi, rwl, rwh = upsample2x_taps(h, dtype, x1.device)
    clo, chi, cwl, cwh = upsample2x_taps(w, dtype, x1.device)
    v = x1.float()
    rows = lambda r: v[:, r.long()]                   # (B, 2h, w, C)
    cols = lambda t, c: t[:, :, c.long()]             # (B, 2h, 2w, C)
    a0, a1 = rwl[None, :, None, None], rwh[None, :, None, None]
    t_lo = lambda c: (a0 * cols(rows(rlo), c) + a1 * cols(rows(rhi), c)).to(dtype).float()
    out = cwl[None, None, :, None] * t_lo(clo) + cwh[None, None, :, None] * t_lo(chi)
    return out.to(dtype)


@pytest.mark.parametrize("b,h,w,c", [(2, 5, 7, 6), (1, 1, 6, 4), (1, 5, 1, 3),
                                     (1, 1, 1, 8), (2, 9, 13, 5), (1, 36, 48, 2)])
def test_upconv_blend_matches_the_plain_upsample(b, h, w, c):
    rng = np.random.default_rng(h * 100 + w)
    x = torch.from_numpy((rng.standard_normal((b, h, w, c)) * 3).astype(np.float32))
    got, ref = _blend(x), upsample2x_bilinear_align_corners(x)
    assert got.shape == ref.shape == (b, 2 * h, 2 * w, c)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-6 * scale  # float32: 1e-6 relative
    xb = x.to(torch.bfloat16)
    got, ref = _blend(xb).float(), upsample2x_bilinear_align_corners(xb).float()
    # bf16: within one bf16 step (2**-8 relative to the larger magnitude) of
    # each output; both round the same float32 blends
    step = torch.maximum(got.abs(), ref.abs()) * 2.0 ** -8
    assert bool(((got - ref).abs() <= step + 1e-30).all())
    if h == 1 or w == 1:  # one input row or column: every weight on one tap
        axis = 1 if h == 1 else 2
        assert bool((ref == ref.narrow(axis, 0, 1)).all())


@pytest.mark.parametrize("n", [36, 48, 72, 96, 144, 192, 288, 384])
def test_upconv_patch_covers_every_tap_at_the_path_sizes(n):
    """The x1 patch a tile stages (``upconv_patch`` pixels from the taps of
    the tile's first halo row inside the image) holds both taps of every
    halo row inside the image, for 8- and 16-pixel tiles, at the four decoder
    stages' x1 heights and widths."""
    _check_patch(n)


def test_upconv_patch_covers_every_tap_at_odd_sizes():
    for n in list(range(1, 41)) + [47, 63, 101]:
        _check_patch(n)


def _check_patch(n):
    lo, hi = (t.numpy() for t in upsample2x_taps(n, torch.float32, torch.device("cpu"))[:2])
    for tile in (8, 16):
        extent = upconv.upconv_patch(tile)
        for y0 in range(0, 2 * n, tile):
            rows = [y for y in range(y0 - 1, y0 + tile + 1) if 0 <= y < 2 * n]
            r0 = lo[max(y0 - 1, 0)]
            assert r0 == lo[rows].min()
            assert hi[rows].max() - r0 < extent, (n, tile, y0)
