"""Host-side choices of K1 (``mca_fused``) and K4 (``upsample2x_fused``): the
variant a call gets, K1's tile walk and halo, its four-run shuffle gather,
K4's band and strip mapping onto the input patch it stages, each block's
shared memory against a hand count, and the correctly rounded division by 3
and 9 that K1 computes with a reciprocal and one fused correction.  All of it
runs on the CPU in seconds; the kernels themselves are held against their
plain versions on the card by ``chip_smoke.py``."""

import fractions

import numpy as np
import pytest
import torch

from egm_unet_torch.ops.cuda import mca, resize2x
from egm_unet_torch.ops.resize import linear_taps
from egm_unet_torch.ops.shuffle import channel_shuffle

SMEM_LIMIT = 232448  # what one block may opt into on an H100
SM_LIMIT = 228 * 1024  # shared memory of one SM
STATIC_LIMIT = 48 * 1024  # without the opt-in

# K1: the four MCALayer inputs of the EGM-UNet forward at the serving bucket
# (batch cut to 1: the walk repeats per image), then odd sizes
K1_PATH = [(1, 288, 384, 64), (1, 144, 192, 128), (1, 72, 96, 256), (1, 36, 48, 256)]
K1_ODD = [(1, 1, 1, 32), (2, 1, 7, 64), (1, 9, 1, 32), (2, 17, 33, 96), (1, 5, 5, 20),
          (3, 16, 16, 32), (1, 31, 47, 40)]
# K4: the four decoder inputs (h, w, C) of the fused route, then odd sizes
K4_PATH = [(36, 48, 256), (72, 96, 128), (144, 192, 64), (288, 384, 32)]
K4_ODD = [(1, 1, 8), (1, 4, 8), (3, 1, 40), (5, 7, 3), (9, 13, 16), (6, 5, 16),
          (17, 33, 24), (37, 11, 300)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mca_variant_is_a_function_of_dtype_shape_and_alignment(dtype):
    for c in (64, 128, 256, 32, 96):
        assert mca.mca_variant(dtype, c, 4, True) == "tile_tma"
        assert mca.mca_variant(dtype, c, 4, False) == "tile_scalar"
    for c, groups in ((40, 4), (20, 4), (3, 1), (64, 2), (64, 8), (48, 4)):
        assert mca.mca_variant(dtype, c, groups, True) == "tile_scalar"
    for dtype_bad in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError):
            mca.mca_variant(dtype_bad, 64)


@pytest.mark.parametrize("dtype,vec", [(torch.bfloat16, 8), (torch.float32, 4)])
def test_upsample_variant_is_a_function_of_dtype_shape_and_alignment(dtype, vec):
    for c in (256, 128, 64, 32, vec, 3 * vec):
        assert resize2x.upsample_variant(dtype, c, True) == "band_cp_async"
        assert resize2x.upsample_variant(dtype, c, False) == "band_scalar"
    for c in (3, vec + 2, 2 * vec - 1):
        assert resize2x.upsample_variant(dtype, c, True) == "band_scalar"
    for dtype_bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            resize2x.upsample_variant(dtype_bad, 64)


@pytest.mark.parametrize("shape", K1_PATH + K1_ODD)
def test_mca_tiles_cover_every_output_once_and_their_halo_every_window(shape):
    b, h, w, c = shape
    th, tw, cc = mca.MCA_TILE
    hits = np.zeros((b, h, w, c), np.int16)
    n = mca.mca_tile_count(shape)
    origins = {mca.mca_tile_origin(t, shape) for t in range(n)}
    assert len(origins) == n  # no tile twice
    for bi, y0, x0, c0 in origins:
        assert 0 <= bi < b and 0 <= y0 < h and 0 <= x0 < w and 0 <= c0 < c
        hits[bi, y0:y0 + th, x0:x0 + tw, c0:c0 + cc] += 1
        # the (TH+4) x (TW+4) halo holds the 5 x 5 neighbourhood (3x3 mean of
        # a 3x3 window) of every output pixel of the tile
        ys = np.arange(y0, min(y0 + th, h))
        xs = np.arange(x0, min(x0 + tw, w))
        assert ys.min() - 2 >= y0 - 2 and ys.max() + 2 < y0 - 2 + th + 4
        assert xs.min() - 2 >= x0 - 2 and xs.max() + 2 < x0 - 2 + tw + 4
    assert (hits == 1).all()


@pytest.mark.parametrize("c", [64, 128, 256, 32, 96])
def test_mca_four_runs_of_eight_give_the_channel_shuffle(c):
    x = torch.arange(c, dtype=torch.float32).view(1, 1, 1, c)
    want = channel_shuffle(x, 4).flatten()
    got = torch.empty(c)
    for c0 in range(0, c, 32):
        runs = mca.mca_shuffle_runs(c, c0)
        assert len(runs) == 4
        for k, start in enumerate(runs):
            # one 16-byte load in bf16, two in float32: 8 channels on the 8-grid
            assert start % 8 == 0 and start + 8 <= c
            for i in range(8):
                got[c0 + 4 * i + k] = x.flatten()[start + i]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("c,groups", [(40, 4), (20, 4), (64, 2), (64, 8), (48, 4), (12, 3)])
def test_mca_gather_shuffle_off_the_runs(c, groups):
    """Where the runs do not apply, the scalar variant gathers channel
    (j % g) * (C / g) + j / g, which is the channel shuffle too."""
    assert mca.mca_shuffle_runs(c, 0, groups) is None
    x = torch.arange(c, dtype=torch.float32).view(1, 1, 1, c)
    src = [(j % groups) * (c // groups) + j // groups for j in range(c)]
    torch.testing.assert_close(x.flatten()[src], channel_shuffle(x, groups).flatten(),
                               rtol=0, atol=0)


def test_mca_shared_memory_by_hand():
    # bf16: the stage (20*18*32*2 halo + 16*14*32*2 runs + 102*4 gates + 16
    # origin = 37800, padded to 128: 37888), a float32 18*16*32 d2
    bf16 = 37888 + 36864
    # float32: 46080 + 28672 + 408 + 16 = 75176, padded: 75264
    f32 = 75264 + 36864
    assert mca.mca_smem_bytes(2) == bf16 == 74752
    assert mca.mca_smem_bytes(4) == f32 == 112128
    # three bf16 blocks, two float32 ones, each with its 8-byte mbarrier and
    # the 1 KB the card reserves per block, in an SM's 228 KB
    assert 3 * (bf16 + 8 + 1024) <= SM_LIMIT and 2 * (f32 + 8 + 1024) <= SM_LIMIT


def _bands(n_out, size):
    return [(s, min(size, n_out - s)) for s in range(0, n_out, size)]


@pytest.mark.parametrize("h,w,c", K4_PATH + K4_ODD)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_upsample_bands_read_only_their_staged_patch(h, w, c, itemsize):
    br, bq, vec = resize2x.upsample_tile(c, itemsize)
    assert br == resize2x.UP_BAND_ROWS and c % vec == 0
    assert bq * (c // vec) <= max(resize2x.UP_THREADS, c // vec)
    for n_in, size in ((h, br), (w, bq)):
        lo, hi, _, w_hi = linear_taps(n_in, 2 * n_in, True)
        for start, count in _bands(2 * n_in, size):
            first, rows = resize2x.upsample_patch(n_in, start, count)
            assert rows <= resize2x.patch_max(size)
            sl = slice(start, start + count)
            assert lo[sl].min() >= first and hi[sl].max() < first + rows
            assert 0 <= first and first + rows <= n_in
            # rows only move forward, so a walk down the band blends each
            # staged row once (the kernel keeps the last two)
            assert (np.diff(lo[sl]) >= 0).all() and (hi[sl] - lo[sl] <= 1).all()


def _band_walk(lo, hi, w_hi):
    """The kernel's walk down one band: which input rows it blends, given
    that it keeps the blends of rows lo and lo + 1."""
    ra = rb = -1
    blended = []
    for l, h_, a1 in zip(lo, hi, w_hi):
        if ra != l:
            if rb != l:
                blended.append(l)
            ra, rb = l, -1
        if a1 != 0:
            if rb != h_:
                blended.append(h_)
                rb = h_
            assert (ra, rb) == (l, h_)
        assert ra == l
    return blended


@pytest.mark.parametrize("n_in", [1, 2, 3, 5, 9, 36, 72, 144, 288])
def test_upsample_band_walk_blends_each_input_row_once(n_in):
    lo, hi, _, w_hi = linear_taps(n_in, 2 * n_in, True)
    for start, count in _bands(2 * n_in, resize2x.UP_BAND_ROWS):
        sl = slice(start, start + count)
        blended = _band_walk(lo[sl], hi[sl], w_hi[sl])
        assert len(blended) == len(set(blended))
        used = set(lo[sl]) | {int(x) for x, a in zip(hi[sl], w_hi[sl]) if a != 0}
        assert set(blended) == used


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_upsample_band_emulation_matches_the_plain_version(dtype):
    """K4's arithmetic per band: column blends of the staged patch rows,
    rounded to T, then the row blend, written band by band."""
    gen = torch.Generator().manual_seed(0)
    for b, h, w, c in ((2, 9, 13, 16), (1, 1, 4, 8), (1, 3, 1, 40), (1, 18, 5, 8)):
        x = torch.randn(b, h, w, c, generator=gen).to(dtype)
        rlo, rhi, rwl, rwh = linear_taps(h, 2 * h, True)
        clo, chi, cwl, cwh = linear_taps(w, 2 * w, True)
        rwl = torch.from_numpy(rwl).to(dtype).float()
        rwh = torch.from_numpy(rwh).to(dtype).float()
        cwl, cwh = torch.from_numpy(cwl), torch.from_numpy(cwh)
        out = torch.empty(b, 2 * h, 2 * w, c, dtype=dtype)
        for p0, npr in _bands(2 * h, resize2x.UP_BAND_ROWS):
            first, rows = resize2x.upsample_patch(h, p0, npr)
            patch = x[:, first:first + rows].float()
            second = patch[:, :, chi] * cwh.view(1, 1, -1, 1)
            t = patch[:, :, clo] * cwl.view(1, 1, -1, 1) + torch.where(
                cwh.view(1, 1, -1, 1) != 0, second, torch.zeros(()))
            t = t.to(dtype).float()
            for p in range(p0, p0 + npr):
                lo, hi = rlo[p] - first, rhi[p] - first
                row = t[:, lo] * rwl[p]
                if rwh[p] != 0:
                    row = row + t[:, hi] * rwh[p]
                out[:, p] = row.to(dtype)
        torch.testing.assert_close(out, resize2x.upsample2x_plain(x), rtol=0, atol=0)


@pytest.mark.parametrize("h,w,c", K4_PATH + K4_ODD)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_upsample_shared_memory_by_hand(h, w, c, itemsize):
    tile = resize2x.upsample_tile(c, itemsize)
    br, bq, vec = tile
    rows = (br - 1) // 2 + 3
    cols = (bq - 1) // 2 + 3
    hand = 16 * br + 16 * bq + rows * cols * c * itemsize
    assert resize2x.upsample_smem_bytes(tile, c, itemsize) == hand
    # the path widths fit without the opt-in, every width here within the limit
    assert hand <= (STATIC_LIMIT if (h, w, c) in K4_PATH else SMEM_LIMIT)


def _rn32_of_exact(q, r, inv):
    """RN32(q + r * inv) for float32 arrays, exactly: r * inv is exact in
    float64; where the float64 sum lies within two of its ulps of a float32
    midpoint, the sum is redone in rationals."""
    v = q.astype(np.float64) + r.astype(np.float64) * np.float64(inv)
    out = v.astype(np.float32)
    up = np.nextafter(out, np.float32(np.inf)).astype(np.float64)
    down = np.nextafter(out, np.float32(-np.inf)).astype(np.float64)
    o64 = out.astype(np.float64)
    mid = np.where(v >= o64, (o64 + up) / 2, (o64 + down) / 2)
    near = np.abs(v - mid) <= 2 * np.spacing(np.abs(v))
    for i in np.flatnonzero(near):
        exact = fractions.Fraction(float(q[i])) + fractions.Fraction(float(r[i])) * \
            fractions.Fraction(float(inv))
        cand = [np.float32(float(exact))]
        cand += [np.nextafter(cand[0], np.float32(np.inf)),
                 np.nextafter(cand[0], np.float32(-np.inf))]
        errs = [abs(fractions.Fraction(float(cc)) - exact) for cc in cand]
        best = min(errs)
        ties = [cc for cc, e in zip(cand, errs) if e == best]
        out[i] = ties[0] if len(ties) == 1 else next(
            cc for cc in ties if int(cc.view(np.uint32)) % 2 == 0)
    return out


@pytest.mark.parametrize("y", [3.0, 9.0])
def test_division_by_reciprocal_and_one_correction_is_correctly_rounded(y):
    """csrc/mca_fused.cu::div_const: q = x * RN(1/y), r = x - q*y (exact in
    one FMA), RN(q + r * RN(1/y)).  Every significand in [1, 2) (the result
    scales exactly with x's exponent for normal numbers), then random finite
    x across exponents, both signs."""
    inv = np.float32(1.0 / y)
    sig = (np.arange(1 << 23, dtype=np.uint32) | np.uint32(127 << 23)).view(np.float32)
    rng = np.random.default_rng(0)
    wide = (rng.standard_normal(1 << 18) * np.exp2(rng.integers(-100, 100, 1 << 18))).astype(
        np.float32)
    for x in (sig, wide, -sig[::97]):
        q = (x * inv).astype(np.float32)
        r64 = x.astype(np.float64) - q.astype(np.float64) * y
        r = r64.astype(np.float32)
        assert (r.astype(np.float64) == r64).all()  # the residual is exact
        got = _rn32_of_exact(q, r, inv)
        want = (x.astype(np.float64) / y).astype(np.float32)
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (x[bad[:5]], got[bad[:5]], want[bad[:5]])
