"""K8 ``eafe_edge`` on the CPU: its plain version against the library
composite bit for bit, an emulation of the kernel's band and tile split (its
halos, zero fill and float32 summation order) against the plain version, the
host-side choices of variant, unit, tile and band, the wrapper's CPU route,
argument checks and launch counter, and the EdgeAwareFeatureEnhancer's two
routes.  The kernel itself is held against the plain version on the card by
``chip_smoke.py`` (``eafe``)."""

import copy

import pytest
import torch
import torch.nn.functional as F

from egm_unet_torch.nn import layers
from egm_unet_torch.nn.layers import EdgeAwareFeatureEnhancer
from egm_unet_torch.ops.cuda import build, edge, launch_counts, reset_launch_counts
from egm_unet_torch.ops.pooling import avg_pool2d

# the eight EAFE inputs of the EGM-UNet forward at the serving bucket, per
# image: each EGRFB's edge_enhancer (C) and edge_eafe (C / 8)
PATH = [(288, 384, 64), (288, 384, 8), (144, 192, 128), (144, 192, 16),
        (72, 96, 256), (72, 96, 32), (36, 48, 256), (36, 48, 32)]
H100_SMS = 132


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _map(shape, dtype, seed):
    """Signed data over several binades, with runs of +0 and -0."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=gen) * torch.rand(*shape, generator=gen).mul(8).exp2()
    x[..., ::5] = 0.0
    x[..., 1::7] = -0.0
    return x.to(dtype)


def _library(x):
    """The composite as the EAFE computed it before K8, on an NCHW copy."""
    pooled = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, 1, 1,
                          count_include_pad=True)
    return x - pooled.permute(0, 2, 3, 1)


def _emulate(x, sms):
    """The kernel's function block by block: each block's staged rows (tile
    plus halo columns, zero outside the image), its window summed in float32
    row by row and left to right from 0, the mean rounded, the edge rounded.
    Every output pixel must be written by exactly one block."""
    b, h, w, c = x.shape
    variant = edge.eafe_edge_variant(x.dtype, c, True)
    cv = c // edge.eafe_edge_unit(x.dtype, variant)
    tw, tiles = edge.eafe_edge_tile(w, cv)
    r, bands = edge.eafe_edge_bands(h, tiles, b, sms)
    out = torch.zeros_like(x)
    written = torch.zeros(b, h, w, dtype=torch.int32)
    for z in range(b):
        for by in range(bands):
            y0 = by * r
            rows = min(r, h - y0)
            for bx in range(tiles):
                x0 = bx * tw
                n = min(tw, w - x0)
                staged = torch.zeros(rows + 2, n + 2, c, dtype=x.dtype)
                lo, hi = max(x0 - 1, 0), min(x0 + n + 1, w)
                for j in range(rows + 2):
                    if 0 <= y0 - 1 + j < h:
                        staged[j, lo - x0 + 1:hi - x0 + 1] = x[z, y0 - 1 + j, lo:hi]
                s = torch.zeros(rows, n, c)
                for dy in range(3):
                    for dx in range(3):
                        s = s + staged[dy:dy + rows, dx:dx + n].float()
                avg = (s / 9.0).to(x.dtype).float()
                ctr = staged[1:rows + 1, 1:n + 1].float()
                out[z, y0:y0 + rows, x0:x0 + n] = (ctr - avg).to(x.dtype)
                written[z, y0:y0 + rows, x0:x0 + n] += 1
    assert bool((written == 1).all())
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hwc", PATH)
def test_plain_equals_the_library_composite_bit_for_bit(hwc, dtype):
    h, w, c = hwc
    for shape in ((2, h // 12 + 1, w // 12 + 2, c), (1, 7, 5, c), (3, 1, 9, c)):
        x = _map(shape, dtype, seed=c + shape[1])
        got = edge.eafe_edge_plain(x)
        assert got.dtype == dtype and got.shape == x.shape
        assert torch.equal(_bits(got), _bits(_library(x)))
        assert torch.equal(_bits(got), _bits(x - avg_pool2d(x, 3, 1, 1)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,sms", [
    ((2, 37, 29, 64), 4),     # ragged last band
    ((1, 19, 37, 256), 1),    # several tiles, ragged last tile, one band
    ((3, 70, 9, 32), 2),      # six bands
    ((2, 11, 13, 3), 1),      # scalar units
    ((1, 9, 6, 20), 1),       # scalar units, C off the 8-grid
    ((1, 1, 7, 16), 1),       # H = 1: both halo rows padding
    ((2, 9, 1, 8), 1),        # W = 1: both halo columns padding
    ((1, 21, 70, 64), 3),     # 4480 units a row in bf16: ten tiles
])
def test_band_and_tile_emulation_gives_the_plain_bits(shape, sms, dtype):
    x = _map(shape, dtype, seed=sum(shape))
    assert torch.equal(_bits(_emulate(x, sms)), _bits(edge.eafe_edge_plain(x)))


@pytest.mark.parametrize("hwc", PATH)
def test_emulation_at_the_path_widths(hwc):
    h, w, c = hwc
    x = _map((2, h // 8 + 3, w // 8 + 1, c), torch.bfloat16, seed=h + c)
    assert torch.equal(_bits(_emulate(x, 2)), _bits(edge.eafe_edge_plain(x)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_variant_is_a_function_of_dtype_channels_and_alignment(dtype):
    for c in (8, 16, 24, 64, 256, 2048):
        assert edge.eafe_edge_variant(dtype, c, True) == "vec16"
        assert edge.eafe_edge_variant(dtype, c, False) == "scalar"
    for c in (3, 4, 20, 300):
        assert edge.eafe_edge_variant(dtype, c, True) == "scalar"
    with pytest.raises(TypeError):
        edge.eafe_edge_variant(torch.float16, 64)
    assert edge.eafe_edge_unit(dtype, "vec16") == (8 if dtype == torch.bfloat16 else 4)
    assert edge.eafe_edge_unit(dtype, "scalar") == 1


def test_tiles_and_bands_at_the_path():
    got = []
    for h, w, c in PATH:
        tw, tiles = edge.eafe_edge_tile(w, c // 8)
        r, bands = edge.eafe_edge_bands(h, tiles, 32, H100_SMS)
        got.append((tw, tiles, r, bands))
        assert tw * (c // 8) <= edge.TILE_UNITS and (tiles - 1) * tw < w <= tiles * tw
        assert (bands - 1) * r < h <= bands * r
        assert edge.BAND_MIN <= r <= edge.BAND_MAX
        assert edge.eafe_edge_smem_bytes(tw, c, 2) <= 48 * 1024
    assert got == [(64, 6, 32, 9), (384, 1, 9, 32), (32, 6, 24, 6), (192, 1, 8, 18),
                   (16, 6, 12, 6), (96, 1, 8, 9), (16, 3, 8, 5), (48, 1, 8, 5)]
    # the two largest maps re-read at most a tenth of their rows as halos
    for (h, w, c), (_, _, r, _) in zip(PATH[::2], got[::2]):
        if h * w * c >= 72 * 96 * 256 * 2:
            assert (r + 2) / r <= 1.1


@pytest.mark.parametrize("w,cv", [(1, 1), (1, 512), (7, 300), (513, 1), (1000, 8),
                                  (48, 32), (2049, 3)])
def test_tile_covers_the_row_once(w, cv):
    tw, tiles = edge.eafe_edge_tile(w, cv)
    assert tw >= 1 and (tiles - 1) * tw < w <= tiles * tw
    assert tw * cv <= max(edge.TILE_UNITS, cv)


@pytest.mark.parametrize("h,tiles,b,sms", [(1, 1, 1, 132), (7, 1, 1, 132), (9, 1, 1, 132),
                                           (288, 6, 32, 132), (288, 1, 1, 132),
                                           (1000, 2, 64, 132), (5, 3, 2, 1)])
def test_bands_cover_the_rows_once(h, tiles, b, sms):
    r, bands = edge.eafe_edge_bands(h, tiles, b, sms)
    assert 1 <= r and (bands - 1) * r < h <= bands * r
    assert r <= edge.BAND_MAX and 2 * r >= min(edge.BAND_MIN, h)


def test_wrapper_takes_the_plain_path_on_cpu():
    reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        x = _map((2, 9, 7, 64), dtype, seed=4)
        with torch.no_grad():
            got = edge.eafe_edge(x)
        assert torch.equal(_bits(got), _bits(edge.eafe_edge_plain(x)))
    assert not any(launch_counts().values())


@pytest.mark.parametrize("bad,error", [
    (lambda x: x[0], ValueError),  # not 4-D
    (lambda x: x.double(), TypeError),
    (lambda x: x.half(), TypeError),
    (lambda x: x.to(torch.int32), TypeError),
    (lambda x: x.permute(0, 2, 1, 3), ValueError),  # not contiguous
    (lambda x: [x], TypeError),
])
def test_wrapper_rejects_bad_arguments(bad, error):
    with pytest.raises(error):
        edge.eafe_edge(bad(torch.zeros(1, 4, 5, 8)))


def test_wrapper_refuses_autograd():
    x = torch.zeros(1, 4, 5, 8)
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="forward-only"):
            edge.eafe_edge(x.requires_grad_(True))
    with torch.no_grad():
        edge.eafe_edge(x)  # under no_grad the input may require grad


def test_launch_counter_resets_by_name():
    build.LAUNCHES["eafe_edge"] = 5
    assert launch_counts()["eafe_edge"] == 5
    reset_launch_counts()
    assert build.LAUNCHES["eafe_edge"] == 0 and not any(launch_counts().values())


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return module


def _old_forward(m, x):
    """EdgeAwareFeatureEnhancer.forward as it stood before K8, verbatim."""
    edge_map = x - avg_pool2d(x, 3, 1, 1)
    w = m.Conv_0(edge_map)
    if not m.fold_bn:
        w = m.BatchNorm_0(w)
    w = torch.sigmoid(w)
    return w * x + x


def test_training_graph_differentiates_the_composite():
    with torch.enable_grad():
        new = _seeded(EdgeAwareFeatureEnhancer(16, fold_bn=False), 3).train()
        old = copy.deepcopy(new)
        x = _map((2, 11, 9, 16), torch.float32, seed=5)
        xs = [x.clone().requires_grad_(True) for _ in range(2)]
        outs = [new(xs[0]), _old_forward(old, xs[1])]
        gy = torch.randn(outs[0].shape, generator=torch.Generator().manual_seed(6))
        for o in outs:
            o.backward(gy)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(xs[0].grad, xs[1].grad)
    for (name, p), q in zip(new.named_parameters(), old.parameters()):
        assert p.grad is not None and torch.equal(p.grad, q.grad), name
    assert torch.equal(new.BatchNorm_0.mean, old.BatchNorm_0.mean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_layer_takes_the_wrapper(dtype, monkeypatch):
    m = _seeded(EdgeAwareFeatureEnhancer(32), 7).to(dtype)
    x = _map((2, 10, 12, 32), dtype, seed=8)
    calls = []
    wrapped = edge.eafe_edge
    monkeypatch.setattr(layers, "eafe_edge", lambda t: calls.append(t.shape) or wrapped(t))
    with torch.no_grad():
        got = m(x)
        ref = _old_forward(m, x)
        # non-contiguous input: the layer hands the wrapper a contiguous copy
        got_t = m(x.transpose(1, 2).contiguous().transpose(1, 2))
    assert calls == [x.shape, x.shape]
    assert torch.equal(_bits(got), _bits(ref)) and torch.equal(_bits(got_t), _bits(ref))


def test_spatial_group_takes_the_composite(monkeypatch):
    m = _seeded(EdgeAwareFeatureEnhancer(8), 9)
    x = _map((1, 6, 5, 8), torch.float32, seed=10)

    def refuse(t):
        raise AssertionError("the kernel wrapper under a spatial group")
    monkeypatch.setattr(layers, "eafe_edge", refuse)
    monkeypatch.setattr(layers, "spatial", lambda: object())
    with torch.no_grad():
        got = m(x)
    assert torch.equal(got, _old_forward(m, x))
