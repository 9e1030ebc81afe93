"""K7 ``mca_gates`` on the CPU: its plain version against the MCAGate maths
it was moved from, the wrapper's CPU route and argument checks, its launch
counter, and the host-side mirror of the kernel's row split, partial slots,
lanes, scratch and shared memory, with an emulation of its partial-sum
scheme in float64.  The kernel itself is held against the plain version on
the card by ``chip_smoke.py`` (``gates``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from egm_unet_torch.nn.attention import MCALayer, mca_kernel_size
from egm_unet_torch.ops.cuda import build, gates, launch_counts, mca, reset_launch_counts

# the four MCALayer inputs of the EGM-UNet forward at the serving bucket
PATH = [(288, 384, 64), (144, 192, 128), (72, 96, 256), (36, 48, 256)]
H100_SMS = 132


def _old_gate(x, axis, weight, conv):
    """MCAGate.forward as it stood before K7 (no spatial group), verbatim."""
    reduce_axes = tuple(a for a in (1, 2, 3) if a != axis)
    n = 1
    for a in reduce_axes:
        n *= x.shape[a]
    xf = x.float()
    keep = [x.shape[0], 1, 1, 1]
    keep[axis] = x.shape[axis]
    avg = xf.mean(dim=reduce_axes)
    var = ((xf - avg.reshape(keep)) ** 2).mean(dim=reduce_axes)
    std = (var * (n / max(n - 1, 1))).sqrt()
    sw = torch.sigmoid(weight)
    blended = 0.5 * (avg + std) + sw[0] * avg + sw[1] * std
    k = conv.shape[0]
    pad = (k - 1) // 2
    return torch.sigmoid(F.conv1d(blended[:, None, :], conv.float()[None, None, :],
                                  padding=pad)[:, 0, :]).contiguous()


def _layer(c, seed, dtype=torch.float32):
    layer = MCALayer(c)
    gen = torch.Generator().manual_seed(seed)
    for g in (layer.h_cw, layer.w_hc, layer.c_hw):
        g.reset_parameters(gen)
    return layer.to(dtype)


def _params(layer):
    return [(g.weight, g.conv) for g in (layer.h_cw, layer.w_hc, layer.c_hw)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 9, 64), (1, 5, 11, 128), (2, 9, 3, 256),
                                   (3, 1, 5, 64), (1, 13, 1, 128)])
def test_gates_plain_equal_the_mca_gate_maths_bit_for_bit(shape, dtype):
    b, h, w, c = shape
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(c + h)).relu().to(dtype)
    layer = _layer(c, seed=h * w, dtype=dtype)
    got = gates.mca_gates_plain(x, _params(layer))
    with torch.no_grad():
        modules = [g(x) for g in (layer.h_cw, layer.w_hc, layer.c_hw)]
    for axis, g, m, (weight, conv) in zip((1, 2, 3), got, modules, _params(layer)):
        old = _old_gate(x, axis, weight, conv)
        assert g.dtype == torch.float32 and g.shape == (b, shape[axis])
        assert torch.equal(g, old) and torch.equal(m, old)


def test_gate_stats_plain_are_the_blends_inputs():
    x = torch.rand(2, 6, 10, 32, generator=torch.Generator().manual_seed(1))
    for axis in (1, 2, 3):
        avg, std = gates.gate_stats_plain(x, axis)
        dims = tuple(a for a in (1, 2, 3) if a != axis)
        xd = x.double()
        torch.testing.assert_close(avg.double(), xd.mean(dim=dims), rtol=1e-6, atol=0)
        torch.testing.assert_close(std.double(), xd.std(dim=dims, unbiased=True),
                                   rtol=1e-5, atol=0)


def test_wrapper_takes_the_plain_path_on_cpu():
    reset_launch_counts()
    layer = _layer(64, seed=3)
    x = torch.rand(2, 9, 7, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = gates.mca_gates(x, _params(layer))
        (got2, stats) = gates.mca_gates(x, _params(layer), stats=True)
        ref = gates.mca_gates_plain(x, _params(layer))
        out = layer(x)
        old = mca.mca_fused(x, *(g(x) for g in (layer.h_cw, layer.w_hc, layer.c_hw)))
    for a, b_, r in zip(got, got2, ref):
        assert torch.equal(a, r) and torch.equal(b_, r)
    for axis, (avg, std) in zip((1, 2, 3), stats):
        ra, rs = gates.gate_stats_plain(x, axis)
        assert torch.equal(avg, ra) and torch.equal(std, rs)
    assert torch.equal(out, old)  # the fused layer on the CPU is unchanged
    assert not any(launch_counts().values())


def _good():
    x = torch.zeros(1, 4, 5, 8)
    params = [(torch.zeros(2), torch.zeros(3)), (torch.zeros(2), torch.zeros(3)),
              (torch.zeros(2), torch.zeros(1))]
    return x, params


@pytest.mark.parametrize("bad,error", [
    (lambda x, p: (x[0], p), ValueError),  # not 4-D
    (lambda x, p: (x.double(), p), TypeError),
    (lambda x, p: (x.half(), p), TypeError),
    (lambda x, p: (x.permute(0, 2, 1, 3), p), ValueError),  # not contiguous
    (lambda x, p: (x, p[:2]), ValueError),  # two gates
    (lambda x, p: (x, [(torch.zeros(3), p[0][1])] + p[1:]), ValueError),  # weight (3,)
    (lambda x, p: (x, [(p[0][0], torch.zeros(4))] + p[1:]), ValueError),  # even conv
    (lambda x, p: (x, [(p[0][0], torch.zeros(1, 3))] + p[1:]), ValueError),  # 2-D conv
    (lambda x, p: (x, [(p[0][0].double(), p[0][1])] + p[1:]), TypeError),
    (lambda x, p: (x, [(p[0][0].bfloat16(), p[0][1])] + p[1:]), TypeError),  # mixed dtypes
    (lambda x, p: (x, [(torch.zeros(4)[::2], p[0][1])] + p[1:]), ValueError),  # strided
])
def test_wrapper_rejects_bad_arguments(bad, error):
    x, params = bad(*_good())
    with pytest.raises(error):
        gates.mca_gates(x, params)


def test_wrapper_refuses_autograd():
    x, params = _good()
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="forward-only"):
            gates.mca_gates(x.requires_grad_(True), params)
        x.requires_grad_(False)
        params[2] = (params[2][0].requires_grad_(True), params[2][1])
        with pytest.raises(RuntimeError, match="forward-only"):
            gates.mca_gates(x, params)
    with torch.no_grad():
        gates.mca_gates(x, params)  # under no_grad the parameters may require grad


def test_launch_counter_resets_by_name():
    build.LAUNCHES["mca_gates"] = 5
    assert launch_counts()["mca_gates"] == 5
    reset_launch_counts()
    assert build.LAUNCHES["mca_gates"] == 0 and not any(launch_counts().values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gates_variant_is_a_function_of_dtype_channels_and_alignment(dtype):
    for c in (8, 24, 64, 128, 256, 2048):
        assert gates.mca_gates_variant(dtype, c, True) == "vec16"
        assert gates.mca_gates_variant(dtype, c, False) == "scalar"
    for c in (3, 20, 300):
        assert gates.mca_gates_variant(dtype, c, True) == "scalar"
    with pytest.raises(TypeError):
        gates.mca_gates_variant(torch.float16, 64)


def test_lanes_at_the_path_and_odd_widths():
    # 8 channels a lane: C = 64 / 128 / 256 take 8 / 16 / 32 lanes, one chunk each
    assert [gates.mca_gates_lanes(c, 8) for _, _, c in PATH] == [
        (8, 1, 32), (16, 1, 16), (32, 1, 8), (32, 1, 8)]
    assert gates.mca_gates_lanes(24, 8) == (4, 1, 64)  # 3 chunks in 4 lanes
    assert gates.mca_gates_lanes(2048, 8) == (256, 1, 1)
    assert gates.mca_gates_lanes(3, 1) == (4, 1, 64)
    assert gates.mca_gates_lanes(300, 1) == (256, 2, 1)
    assert gates.mca_gates_lanes(2048, 1) == (256, 8, 1)
    for c, vec in ((8, 8), (96, 8), (512, 8), (1, 1), (20, 1), (257, 1), (2047, 1)):
        lanes, k, pl = gates.mca_gates_lanes(c, vec)
        ch = c // vec
        assert lanes & (lanes - 1) == 0 and lanes * pl == 256
        assert (k - 1) * lanes < ch <= k * lanes <= 8 * 256 // vec  # every chunk once


@pytest.mark.parametrize("h,w,c", PATH + [(1, 1, 8), (7, 5, 3), (1000, 9, 64),
                                          (3, 2048, 64), (40, 3, 24)])
def test_bands_cut_each_image_alone(h, w, c):
    p = gates.mca_gates_bands(h, w, c)
    bounds = [(q * h // p, (q + 1) * h // p) for q in range(p)]
    rows = [hi - lo for lo, hi in bounds]
    assert 1 <= p <= h and bounds[0][0] == 0 and bounds[-1][1] == h
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))  # contiguous
    assert min(rows) >= 1 and max(rows) - min(rows) <= 1  # even, to one row
    assert max(rows) == 1 or (max(rows) - 1) * w * c < gates.BAND_ELEMENTS


def test_bands_at_the_path():
    # two rows (48K elements) a band at the first three stages, 4-5 at the last
    assert [gates.mca_gates_bands(h, w, c) for h, w, c in PATH] == [144, 72, 36, 8]


@pytest.mark.parametrize("b,p", [(32, 144), (32, 8), (8, 8), (1, 8), (1, 1), (3, 1),
                                 (5, 7), (2, 1000)])
@pytest.mark.parametrize("sms", [H100_SMS, 1, 7])
def test_schedule_covers_every_band_once(b, p, sms):
    nb = b * p
    g = gates.mca_gates_schedule(nb, sms)
    assert 1 <= g <= min(nb, gates.BLOCKS_PER_SM * sms)
    seen = np.zeros(nb, np.int64)
    sizes = []
    for j in range(g):
        q0, q1 = gates.mca_gates_blocks(j, nb, g)
        assert q1 > q0  # no block idles
        seen[q0:q1] += 1
        sizes.append(q1 - q0)
    assert (seen == 1).all() and max(sizes) - min(sizes) <= 1


def test_schedule_at_the_path_fills_the_card():
    for h, w, c in PATH[:3]:
        nb = 32 * gates.mca_gates_bands(h, w, c)
        assert gates.mca_gates_schedule(nb, H100_SMS) == 3 * H100_SMS  # three an SM
    assert gates.mca_gates_schedule(32 * 8, H100_SMS) == 256  # the last stage: one band each


def test_scratch_and_shared_memory_against_a_hand_count():
    # stage 1 at batch 32: 144 bands an image
    assert gates.mca_gates_scratch_floats(32, 288, 384, 64, 144) == (
        2 * 32 * 288 + 32 * (384 + 64) + 2 * 32 * 144 * 384 + 2 * 32 * 144 * 64)
    # pass 1 at C = 64: column sums 384 x 1, pixel lanes 32 x 64 channels, the
    # ring 16 x 8 warps and its 16 rows; pass 2 adds the means 384 + 64
    p1 = 4 * (384 + 32 * 64 + 16 * 8 + 16)
    assert gates.mca_gates_smem_bytes(384, 64, 8, False) == p1
    assert gates.mca_gates_smem_bytes(384, 64, 8, True) == p1 + 4 * (384 + 64)
    # C = 512: 64 lanes a pixel span two warps, two column slots
    assert gates.mca_gates_smem_bytes(10, 512, 8, False) == 4 * (20 + 4 * 512 + 144)
    for h, w, c in PATH:
        assert gates.mca_gates_smem_bytes(w, c, 8, True) <= 48 * 1024  # no opt-in needed
        assert 3 * gates.mca_gates_smem_bytes(w, c, 8, True) <= 228 * 1024  # 3 an SM


def _band_sums(xd, b, h, p):
    """Each band's column and channel sums of the images in xd (float64):
    one fixed cut of an image, whatever batch it is in."""
    sw, sc = [], []
    for img in range(b):
        for q in range(p):
            rows = xd[img, q * h // p:(q + 1) * h // p]
            sw.append(rows.sum((0, 2)))
            sc.append(rows.sum((0, 1)))
    return torch.stack(sw).view(b, p, -1), torch.stack(sc).view(b, p, -1)


def _emulate(x, params):
    """The kernel's scheme in float64: band sums, the means from them in band
    order, pass 2's band sums of squared deviations, the finish."""
    b, h, w, c = x.shape
    p = gates.mca_gates_bands(h, w, c)
    xd = x.double()
    sw, sc = _band_sums(xd, b, h, p)
    avg = {1: xd.sum((2, 3)) / (w * c), 2: sw.sum(1) / (h * c), 3: sc.sum(1) / (h * w)}
    dev_h = ((xd - avg[1][:, :, None, None]) ** 2).sum((2, 3))
    dw = _band_sums((xd - avg[2][:, None, :, None]) ** 2, b, h, p)[0].sum(1)
    dc = _band_sums((xd - avg[3][:, None, None, :]) ** 2, b, h, p)[1].sum(1)
    out = []
    for axis, dev, (weight, conv) in zip((1, 2, 3), (dev_h, dw, dc), params):
        n = h * w * c // x.shape[axis]
        std = (dev / n * (n / max(n - 1, 1))).sqrt()
        sig = torch.sigmoid(weight.double())
        bl = 0.5 * (avg[axis] + std) + sig[0] * avg[axis] + sig[1] * std
        k = conv.shape[0]
        out.append(torch.sigmoid(F.conv1d(bl[:, None], conv.double()[None, None],
                                          padding=(k - 1) // 2)[:, 0]))
    return out


@pytest.mark.parametrize("shape", [(3, 5, 7, 16), (2, 9, 4, 24), (4, 3, 6, 8),
                                   (2, 40, 30, 64), (1, 300, 16, 32)])  # 1, 1, 1, 2, 3 bands
def test_band_scheme_gives_the_gates(shape):
    c = shape[-1]
    x = torch.rand(*shape, generator=torch.Generator().manual_seed(sum(shape)))
    layer = _layer(c, seed=c)
    with torch.no_grad():
        got = _emulate(x, _params(layer))
        ref = gates.mca_gates_plain(x, _params(layer))
    assert mca_kernel_size(c) == layer.c_hw.conv.shape[0]
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.float(), r, rtol=0, atol=2e-6)
