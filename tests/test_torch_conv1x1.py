"""K9 ``conv1x1_gemm`` on the CPU: its plain version against the float32
composite it stands for, an emulation of the kernel's column slices, pixel
tiles and K chunks against the plain version, the host-side tile choice and
shared memory, the wrapper's CPU route, argument checks and autograd guard,
and the dispatch of the folded graph's 1x1 convolutions.  The tests marked
``card`` hold the kernel against the plain version on a CUDA device at every
site of the bf16 EGM-UNet forward; they skip without one.  This file imports
no JAX, so on the card it runs without the CPU tests' conftest:

    python -m pytest --noconftest tests/test_torch_conv1x1.py -m card -q

Exact operands (small integers, multiples of 1/64) make every float32 sum
exact in any order, so the kernel's order of summation cannot show: there the
kernel and every emulation must give the plain version's bits."""

import math
from collections import Counter
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from egm_unet_torch.models import create_model
from egm_unet_torch.nn import grfb, layers
from egm_unet_torch.nn.layers import BasicConv, Conv, cast_weights, takes_conv1x1
from egm_unet_torch.ops import quant as tq
from egm_unet_torch.ops.cuda import build, conv1x1, launch_counts, reset_launch_counts
from egm_unet_torch.ops.cuda.common import SMEM_LIMIT

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = (8, 16, 32, 64, 112, 128, 224, 256, 384, 448)
H100_SMS = 132
# the K9 sites of the bf16 EGM-UNet forward (base_c 32) at the serving bucket
# 576x768, per image: (H, W, K, N, bias, relu) -> sites a forward.  Each EGRFB:
# edge_enhancer.Conv_0 and shortcut C -> C, dir0 C -> C/4 and edge0 C -> C/8
# (ReLU), dir2, edge3, ctx3 C/4 -> C/4 (ReLU), edge_eafe.Conv_0 C/8 -> C/8, the
# FusionConv's down conv (C + 6 C/8) -> C/4 and up C/4 -> C; the channel
# attention's fc_down and fc_up (no bias) on 1x1 maps, twice, in stages 2-4;
# the RGA's proj_in, gate0_down, gate1_down, transform0 and proj_out.
PATH = {
    (288, 384, 64, 64, True, False): 2, (288, 384, 64, 16, True, True): 1,
    (288, 384, 16, 16, True, True): 3, (288, 384, 64, 8, True, True): 1,
    (288, 384, 8, 8, True, False): 1, (288, 384, 112, 16, True, False): 1,
    (288, 384, 16, 64, True, False): 1,
    (144, 192, 128, 128, True, False): 2, (144, 192, 128, 32, True, True): 1,
    (144, 192, 32, 32, True, True): 3, (144, 192, 128, 16, True, True): 1,
    (144, 192, 16, 16, True, False): 1, (144, 192, 224, 32, True, False): 1,
    (144, 192, 32, 128, True, False): 1,
    (1, 1, 32, 8, False, False): 2, (1, 1, 8, 32, False, False): 2,
    (72, 96, 256, 256, True, False): 2, (72, 96, 256, 64, True, True): 1,
    (72, 96, 64, 64, True, True): 3, (72, 96, 256, 32, True, True): 1,
    (72, 96, 32, 32, True, False): 1, (72, 96, 448, 64, True, False): 1,
    (72, 96, 64, 256, True, False): 1,
    (1, 1, 64, 16, False, False): 4, (1, 1, 16, 64, False, False): 4,
    (36, 48, 256, 256, True, False): 2, (36, 48, 256, 64, True, True): 1,
    (36, 48, 64, 64, True, True): 3, (36, 48, 256, 32, True, True): 1,
    (36, 48, 32, 32, True, False): 1, (36, 48, 448, 64, True, False): 1,
    (36, 48, 64, 256, True, False): 1,
    (36, 48, 256, 384, True, False): 1, (36, 48, 128, 16, True, False): 2,
    (36, 48, 128, 128, True, False): 1, (36, 48, 128, 256, True, False): 1,
}


def _bits(t):
    return t.view(torch.int16)


def _exact(shape, lo, hi, scale, gen):
    """Integers in [lo, hi) times ``scale`` (a power of two), float32."""
    return torch.randint(lo, hi, shape, generator=gen).float() * scale


def _operands(b, h, w, k, n, bias, exact, seed, bias_dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)
    if exact:
        x = _exact((b, h, w, k), 1, 9, 1.0, gen)
        wt = _exact((1, 1, k, n), -8, 9, 1 / 64, gen)
        bv = _exact((n,), -64, 65, 1 / 64, gen)
    else:
        x = torch.randn(b, h, w, k, generator=gen).relu()
        wt = torch.randn(1, 1, k, n, generator=gen) / math.sqrt(k)
        bv = torch.randn(n, generator=gen) * 0.1
    return x.bfloat16(), wt.bfloat16(), bv.to(bias_dtype) if bias else None


def _composite(x, w, b, relu):
    """The float32 convolution of the bf16 operands, its bias and ReLU,
    rounded once: the function K9 computes, through ``F.conv2d``."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 None if b is None else b.float())
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).bfloat16()


def _emulate(x, w, b, relu, sms=H100_SMS, per_sm=1):
    """The kernel's function block by block, as ``csrc/conv1x1.cu`` splits it:
    as many blocks as ``sms * per_sm`` (a multiple of the column slices, at
    most one a tile and slice), block i on slice i % slices and pixel tiles
    i // slices, + grid // slices, ...; each tile's K in chunks of KC (zero
    past K), the float32 products summed chunk after chunk, the bias added
    and the ReLU applied in float32, one rounding.  Every (pixel, column) must
    be written by exactly one block."""
    k, n = w.shape[2], w.shape[3]
    xm = x.reshape(-1, k).float()
    wm = w.reshape(k, n).bfloat16().float()
    m = xm.shape[0]
    bm, bn, kc = conv1x1.conv1x1_tile(k, n, m)
    slices, tiles = -(-n // bn), -(-m // bm)
    per_slice = min(tiles, max(1, sms * per_sm // slices))
    out = torch.zeros(m, n, dtype=torch.bfloat16)
    written = torch.zeros(m, n, dtype=torch.int32)
    for block in range(per_slice * slices):
        n0 = block % slices * bn
        cols = slice(n0, min(n0 + bn, n))
        for t in range(block // slices, tiles, per_slice):
            rows = slice(t * bm, min(t * bm + bm, m))
            acc = torch.zeros(rows.stop - rows.start, cols.stop - cols.start)
            for k0 in range(0, -(-k // kc) * kc, kc):
                acc = acc + xm[rows, k0:k0 + kc] @ wm[k0:k0 + kc, cols]
            if b is not None:
                acc = acc + b.float()[cols]
            if relu:
                acc = torch.relu(acc)
            out[rows, cols] = acc.bfloat16()
            written[rows, cols] += 1
    assert bool((written == 1).all())
    return out.reshape(*x.shape[:-1], n)


@pytest.mark.parametrize("k", WIDTHS)
def test_plain_equals_the_round_once_composite(k):
    for n in WIDTHS:
        relu, bias = n % 3 != 0, n != 16
        x, w, b = _operands(2, 3, 5, k, n, bias, True, seed=k + n)
        got = conv1x1.conv1x1_plain(x, w, b, relu=relu)
        assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 5, n)
        assert torch.equal(_bits(got), _bits(_composite(x, w, b, relu)))
        # general operands: the two float32 sums differ in order only, so
        # the results differ by at most one bf16 rounding step
        x, w, b = _operands(2, 3, 5, k, n, bias, False, seed=k * n)
        got, ref = conv1x1.conv1x1_plain(x, w, b, relu=relu), _composite(x, w, b, relu)
        step = 2.0 ** -7 * ref.float().abs().clamp_min(1e-3)
        assert bool(((got.float() - ref.float()).abs() <= step).all())


def test_plain_rounds_once_where_the_library_route_rounds_thrice():
    """The library route (bf16 conv, bf16 bias add, ReLU) rounds the sum
    before the bias; the plain version adds the bias to the float32 sum."""
    x = torch.full((1, 1, 1, 8), 1.0).bfloat16()
    w = torch.zeros(1, 1, 8, 8)
    w[0, 0, 0, 0], w[0, 0, 1, 0] = 1.0, 2.0 ** -8  # the sum halfway between 1 and 1 + 2^-7
    b = torch.full((8,), 2.0 ** -8)
    w, b = w.bfloat16(), b.bfloat16()
    got = conv1x1.conv1x1_plain(x, w, b)[0, 0, 0, 0].item()
    old = (F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)) + b.view(1, -1, 1, 1))
    assert got == 1.0 + 2.0 ** -7  # 1 + 2^-8 + 2^-8, rounded once
    assert old[0, 0, 0, 0].item() == 1.0  # the sum rounded to 1 (to even), then 1 + 2^-8 too


@pytest.mark.parametrize("k", WIDTHS)
def test_emulation_gives_the_plain_bits_at_the_path_widths(k):
    for n in WIDTHS:
        bm = conv1x1.conv1x1_tile(k, n, 10 ** 6)[0]
        relu, bias = n % 3 == 0, k != 8
        # two tiles and a ragged third, on four SMs: blocks walk several tiles
        x, w, b = _operands(1, 1, 2 * bm + 37, k, n, bias, True, seed=3 * k + n)
        got = _emulate(x, w, b, relu, sms=2)
        assert torch.equal(_bits(got), _bits(conv1x1.conv1x1_plain(x, w, b, relu=relu)))


@pytest.mark.parametrize("m,k,n,sms,per_sm", [
    (1, 8, 8, 132, 1),         # one pixel
    (512, 16, 16, 132, 1),     # exactly one tile
    (513, 16, 16, 1, 1),       # a tile and one pixel, one block
    (1000, 64, 384, 2, 1),     # three slices, fewer SMs than slices
    (4000, 448, 64, 3, 2),     # seven K chunks, many tiles a block
    (300, 256, 256, 132, 2),   # more blocks than tiles
])
def test_tiles_and_slices_cover_each_output_once(m, k, n, sms, per_sm):
    x, w, b = _operands(1, 1, m, k, n, True, True, seed=m + k)
    got = _emulate(x, w, b, False, sms=sms, per_sm=per_sm)  # asserts the cover
    assert torch.equal(_bits(got), _bits(conv1x1.conv1x1_plain(x, w, b)))


def test_float32_bias_is_added_unrounded():
    x, w, b = _operands(2, 4, 4, 32, 16, True, False, seed=9, bias_dtype=torch.float32)
    got = conv1x1.conv1x1_plain(x, w, b, relu=True)
    ref = torch.relu(x.float().reshape(-1, 32) @ w.float().reshape(32, 16) + b)
    assert torch.equal(_bits(got), _bits(ref.bfloat16().reshape(2, 4, 4, 16)))


def test_tiles_at_the_path():
    got = {(h, k, n): conv1x1.conv1x1_tile(k, n, 32 * h * w) for h, w, k, n, _, _ in PATH}
    assert got[(288, 8, 8)] == got[(288, 16, 16)] == (512, 16, 16)
    assert got[(288, 16, 64)] == (256, 64, 16)
    assert got[(144, 32, 32)] == (256, 32, 32) and got[(144, 32, 128)] == (128, 128, 32)
    assert got[(288, 64, 16)] == (128, 16, 64) and got[(72, 448, 64)] == (128, 64, 64)
    assert got[(36, 256, 384)] == got[(36, 128, 256)] == (128, 128, 64)
    # the channel attention's 32 pooled vectors: one 128-row tile
    assert got[(1, 8, 32)] == (128, 32, 16) and got[(1, 16, 64)] == (128, 64, 16)
    assert got[(1, 32, 8)] == (128, 16, 32) and got[(1, 64, 16)] == (128, 16, 64)
    for (_, k, _), tile in got.items():
        bm, bn, kc = tile
        assert bm * kc <= conv1x1.STAGE_ELEMS and bm * bn <= conv1x1.ACC_ELEMS
        assert k <= kc or kc == 64
        assert conv1x1.conv1x1_smem_bytes(tile, k) <= SMEM_LIMIT


@pytest.mark.parametrize("k,n,tile", [
    (448, 256, (128, 128, 64)),    # 448 rows of 128 columns: all of the 227 KB
    (512, 256, (128, 64, 64)),     # ... 512 do not fit
    (1024, 128, (128, 32, 64)),
    (2048, 128, (128, 16, 64)),
    (8, 1024, (128, 128, 16)),
])
def test_tile_halves_the_slice_to_fit_shared_memory(k, n, tile):
    assert conv1x1.conv1x1_tile(k, n, 10 ** 6) == tile
    assert conv1x1.conv1x1_smem_bytes(tile, k) <= SMEM_LIMIT
    if tile[1] < 128:
        wider = (min(8192 // tile[2], 16384 // (2 * tile[1])), 2 * tile[1], tile[2])
        assert conv1x1.conv1x1_smem_bytes(wider, k) > SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        conv1x1.conv1x1_tile(8192, 16, 10 ** 6)


def test_flops_count_the_padding():
    needed, executed = conv1x1.conv1x1_flops(1000, 8, 8)
    assert needed == 2.0 * 1000 * 8 * 8
    assert executed == 2.0 * 1024 * 16 * 16  # M to 512, N to 16, K to 16


def test_wrapper_takes_the_plain_path_on_cpu():
    reset_launch_counts()
    for bias_dtype in (torch.bfloat16, torch.float32):
        x, w, b = _operands(2, 5, 7, 64, 32, True, False, seed=4, bias_dtype=bias_dtype)
        with torch.no_grad():
            got = conv1x1.conv1x1_gemm(x, w, b, relu=True)
            bare = conv1x1.conv1x1_gemm(x, w)
        assert torch.equal(_bits(got), _bits(conv1x1.conv1x1_plain(x, w, b, relu=True)))
        assert torch.equal(_bits(bare), _bits(conv1x1.conv1x1_plain(x, w)))
    # a float32 kernel is cast to bf16, as the card's wrapper casts it
    x, w, _ = _operands(1, 3, 3, 16, 8, False, False, seed=5)
    w32 = w.float() + 1e-4
    assert torch.equal(conv1x1.conv1x1_gemm(x, w32), conv1x1.conv1x1_plain(x, w32.bfloat16()))
    assert not any(launch_counts().values())


@pytest.mark.parametrize("args,error", [
    (lambda x, w, b: (x.float(), w, b), TypeError),               # float32 map
    (lambda x, w, b: (x[0], w, b), ValueError),                   # not 4-D
    (lambda x, w, b: (x.transpose(1, 2), w, b), ValueError),      # not contiguous
    (lambda x, w, b: (x, w[..., :4], b[:4]), ValueError),         # N off the 8-grid
    (lambda x, w, b: (x[..., :12].contiguous(), w[:, :, :12], b), ValueError),  # K
    (lambda x, w, b: (x, w.expand(3, 3, 16, 8), b), ValueError),  # not 1x1
    (lambda x, w, b: (x, w, b[:4]), ValueError),                  # bias shape
    (lambda x, w, b: (x, w, b.half()), TypeError),                # bias dtype
    (lambda x, w, b: ([x], w, b), TypeError),
])
def test_wrapper_rejects_bad_arguments(args, error):
    x, w, b = _operands(1, 4, 5, 16, 8, True, False, seed=6)
    with pytest.raises(error):
        conv1x1.conv1x1_gemm(*args(x, w, b))


def test_wrapper_refuses_autograd():
    x, w, b = _operands(1, 4, 5, 16, 8, True, False, seed=7)
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="forward-only"):
            conv1x1.conv1x1_gemm(x, w.requires_grad_(True), b)
    with torch.no_grad():
        conv1x1.conv1x1_gemm(x, w, b)  # under no_grad the weights may require grad


def test_launch_counter_and_kernel_set():
    assert "conv1x1" in build.KERNELS
    build.LAUNCHES["conv1x1_gemm"] = 4
    assert launch_counts()["conv1x1_gemm"] == 4
    reset_launch_counts()
    assert not any(launch_counts().values())


def test_kernel_symbol_is_outside_the_bf16_roofline():
    """``unet_kernels_bf16_roofline`` sums the kernels whose device names
    contain a name listed under ``port_bench/roofline/names/``; K9's must
    contain none of them, so the share keeps measuring K1, K2 and K5."""
    src = (ROOT / "egm_unet_torch/csrc/conv1x1.cu").read_text()
    assert "__global__ void __launch_bounds__(NT) conv1x1_gemm_kernel(" in src
    assert src.count("__global__") == 1
    names = [p.name for p in (ROOT / "port_bench/roofline/names").glob("*/*")]
    assert "conv3x3_mma_kernel" in names and "upconv_mma_kernel" in names
    assert not [name for name in names if name in "conv1x1_gemm_kernel"]


# ------------------------------------------------------------------ dispatch

# SegFormer-B5's head fuse at batch 32 of the 576x768 bucket: a folded 1x1
# conv 3072 -> 768 with bias and ReLU on the 144x192 grid
FUSE = (32, 144, 192, 3072, 768)


def _meta_call(b, h, w, k, n):
    return (torch.empty(b, h, w, k, dtype=torch.bfloat16, device="meta"),
            torch.empty(1, 1, k, n, dtype=torch.bfloat16, device="meta"),
            torch.empty(n, device="meta"))


def test_dispatch_declines_the_segformer_fuse_and_takes_every_egm_site():
    """K9 keeps its weights' slice resident: the fuse's K halves it to 16
    columns, 48 slices each streaming the 5.4 GB map, where cuDNN wins
    (``conv1x1_suits``); every EGM-UNet site keeps the slice its N asks
    for, at batch 1 and 32."""
    b, h, w, k, n = FUSE
    assert conv1x1.conv1x1_tile(k, n, b * h * w) == (128, 16, 64)
    with torch.no_grad():
        assert not takes_conv1x1(*_meta_call(*FUSE))
        for batch in (1, 32):
            for h, w, k, n, _, _ in PATH:
                assert takes_conv1x1(*_meta_call(batch, h, w, k, n)), (batch, h, w, k, n)
    assert len(PATH) == 36


@pytest.mark.parametrize("k,n,suits", [
    (448, 384, True),    # the widest EGM-UNet site: 128-column slices
    (448, 64, True),     # one 64-column slice covers N
    (256, 768, True),    # 128-column slices: 0.41x cuDNN's time on the card
    (512, 768, False),   # halved to 64: 1.06x
    (1024, 768, False),  # halved to 32: 2.9x
    (3072, 768, False),  # the fuse, halved to 16: 2.8x
    (3072, 16, True),    # one 16-column slice covers N: the map streams once
    (8192, 16, False),   # no slice fits shared memory
])
def test_conv1x1_suits_where_the_slice_is_not_halved(k, n, suits):
    assert conv1x1.conv1x1_suits(k, n, 32 * 144 * 192) is suits


def test_segformer_head_fuse_keeps_conv2d(monkeypatch):
    from egm_unet_torch.models.segformer import SegFormerHead

    calls = _spy(monkeypatch)
    head = SegFormerHead((8, 16, 40, 64), 768, 2, fold_bn=True)
    for p in head.parameters():
        torch.nn.init.normal_(p, std=0.05, generator=torch.Generator().manual_seed(5))
    head = head.bfloat16()
    feats = [torch.randn(1, 8 >> i, 8 >> i, c).bfloat16() for i, c in enumerate((8, 16, 40, 64))]
    with torch.no_grad():
        assert head(feats).shape == (1, 8, 8, 2)
    assert not calls
    small = SegFormerHead((8, 16, 40, 64), 32, 2, fold_bn=True).bfloat16()
    with torch.no_grad():
        small(feats)
    assert calls == Counter({(128, 32, True, True): 1})  # a 128 -> 32 fuse fits K9

def _spy(monkeypatch):
    """Count the folded graph's calls of the K9 wrapper by (K, N, bias, relu)."""
    calls = Counter()
    wrapped = conv1x1.conv1x1_gemm

    def spy(x, w, b=None, *, relu=False):
        calls[(w.shape[2], w.shape[3], b is not None, relu)] += 1
        return wrapped(x, w, b, relu=relu)
    monkeypatch.setattr(layers, "conv1x1_gemm", spy)
    monkeypatch.setattr(grfb, "conv1x1_gemm", spy)
    return calls


def _egm(fold_bn=True, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(0)
    return create_model("egm_unet", base_c=32, num_classes=2, fold_bn=fold_bn,
                        generator=gen).eval().to(dtype)


def _frame(dtype=torch.bfloat16):
    return torch.randn(1, 32, 48, 3, generator=torch.Generator().manual_seed(1)).to(dtype)


def test_folded_bf16_forward_takes_k9_at_every_path_site(monkeypatch):
    calls = _spy(monkeypatch)
    model = _egm()
    with torch.no_grad():
        got = model(_frame())["out"]
    want = Counter()
    for (_, _, k, n, bias, relu), count in PATH.items():
        want[(k, n, bias, relu)] += count
    assert sum(calls.values()) == sum(PATH.values()) == 57
    assert calls == want
    # the composite route on the same weights: the same logits to bf16's
    # rounding of a forward (K9 rounds once where the composite rounds thrice)
    monkeypatch.setattr(layers, "takes_conv1x1", lambda *a: False)
    monkeypatch.setattr(grfb, "takes_conv1x1", lambda *a: False)
    calls.clear()
    with torch.no_grad():
        old = model(_frame())["out"]
    assert not calls
    rel = ((got - old).norm() / old.norm()).item()
    assert 0 < rel < 0.05


@pytest.mark.parametrize("case", ["float32", "training_graph", "training_graph_grad"])
def test_float32_and_the_training_graph_keep_conv2d(case, monkeypatch):
    calls = _spy(monkeypatch)
    if case == "float32":
        model, x = _egm(dtype=torch.float32), _frame(torch.float32)
    else:
        model, x = _egm(fold_bn=False), _frame()
    if case == "training_graph_grad":
        with torch.enable_grad():
            model.train()(x)["out"].float().sum().backward()
        assert model.down1.egrfb.fusion.up.kernel.grad is not None
    else:
        with torch.no_grad():
            model(x)
    assert not calls


@pytest.mark.parametrize("mode,k9", [("calibrate", 0), ("int8", 0), ("int8full", 0),
                                     ("int8df", 57)])
def test_quant_modes(mode, k9, monkeypatch):
    """Calibration and the int8-conv modes run every conv as ``conv2d`` or
    ``int8_conv``; int8df stores 8-bit maps between full-precision convs and
    keeps the kernels (K2, K5 and K9)."""
    model, x = _egm(), _frame()
    with torch.no_grad():
        scales = tq.calibrate_quant_scales(model, [x])
    calls = _spy(monkeypatch)
    with torch.no_grad():
        if mode == "calibrate":
            tq.calibrate_quant_scales(model, [x])
        else:
            with tq.quantized(mode, model, scales, "all"):
                model(x)
    assert sum(calls.values()) == k9


def test_spatial_group_and_autograd_keep_conv2d(monkeypatch):
    calls = _spy(monkeypatch)
    conv = Conv(32, 16, 1, fold_bn=True)
    basic = BasicConv(32, 16, 1)
    for p in list(conv.parameters()) + list(basic.parameters()):
        torch.nn.init.normal_(p, std=0.1, generator=torch.Generator().manual_seed(2))
    conv, basic = conv.bfloat16(), basic.bfloat16()
    x = _frame()[..., :1].expand(1, 32, 48, 32).contiguous() * 0.5
    with torch.no_grad():
        ref_conv, ref_basic = conv(x), basic(x)
    assert sum(calls.values()) == 2
    with torch.no_grad():
        assert takes_conv1x1(x, conv.kernel, conv.bias)
        monkeypatch.setattr(layers, "spatial", lambda: object())
        assert not takes_conv1x1(x, conv.kernel, conv.bias)
    monkeypatch.undo()
    calls = _spy(monkeypatch)
    with torch.enable_grad():  # the parameters require grad: autograd needs conv2d
        y = conv(x) + basic(x)
        y.float().sum().backward()
        step = 2.0 ** -7 * ref_conv.float().abs().amax()
        assert (conv(x).detach().float() - ref_conv.float()).abs().amax() <= 4 * step
    assert not calls and conv.kernel.grad is not None and basic.Conv_0.kernel.grad is not None
    # a bare conv (the training graph's, the CLIP towers') keeps conv2d
    bare = Conv(32, 16, 1).bfloat16()
    with torch.no_grad():
        bare(x)
    assert not calls


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K9 has no CPU kernel, only its plain version")
    return torch.device("cuda")


@pytest.mark.card
def test_card_launches_of_the_bf16_forwards(card):
    """57 K9 launches a bf16 EGM-UNet forward; none a SegFormer-B5 one,
    whose fuse keeps cuDNN."""
    x = torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(3)).to(card)
    for name, want in (("egm_unet", 57), ("segformer_b5", 0)):
        model = create_model(name, num_classes=2,
                             generator=torch.Generator().manual_seed(0)).eval().to(card)
        model = cast_weights(model, torch.bfloat16) if name == "segformer_b5" \
            else model.to(torch.bfloat16)
        reset_launch_counts()
        with torch.inference_mode():
            model(x.to(torch.bfloat16))
        torch.cuda.synchronize()
        assert launch_counts()["conv1x1_gemm"] == want, name


@pytest.mark.card
@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("site", sorted(PATH))
def test_card_kernel_against_plain(site, batch, card):
    h, w, k, n, bias, relu = site
    seed = hash(site) % 10_000 + batch
    x, wt, b = (t if t is None else t.to(card)
                for t in _operands(batch, h, w, k, n, bias, True, seed))
    reset_launch_counts()
    with torch.no_grad():
        got = conv1x1.conv1x1_gemm(x, wt, b, relu=relu)
        again = conv1x1.conv1x1_gemm(x, wt, b, relu=relu)
    torch.cuda.synchronize()
    assert launch_counts()["conv1x1_gemm"] == 2
    assert torch.equal(_bits(got), _bits(conv1x1.conv1x1_plain(x, wt, b, relu=relu)))
    assert torch.equal(_bits(got), _bits(again))
    # seeded ReLU'd maps: the two float32 sums differ in order only
    x, wt, b = (t if t is None else t.to(card)
                for t in _operands(batch, h, w, k, n, bias, False, seed + 1))
    with torch.no_grad():
        got = conv1x1.conv1x1_gemm(x, wt, b, relu=relu).float()
    ref = conv1x1.conv1x1_plain(x, wt, b, relu=relu).float()
    assert (got - ref).abs().amax().item() <= 2.0 ** -7 * max(ref.abs().amax().item(), 1e-3)
