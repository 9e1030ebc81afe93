"""The plain PyTorch versions of the port's CUDA kernels K1, K2 and K5 against
the JAX package's Pallas kernels, run in interpret mode on the CPU as the JAX
tests run them, and the wrappers' CPU routing and argument checks.

Tolerances: float32 agrees to 1e-5 (the same float32 products summed in
another order); bfloat16 to one bfloat16 rounding step (2**-7 relative) of
the output's magnitude, since the two round the same float32 values.  K3's
and K4's plain versions are held against their Pallas kernels in
test_torch_routes.py; their wrappers' CPU routing, argument checks, tile
choice, shared-memory reckoning, FLOP count and kernel variant are here."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egm_unet_tpu.ops.pallas.conv3x3 import conv3x3_gemm as jconv3x3
from egm_unet_tpu.ops.pallas.mca import mca_fused as jmca
from egm_unet_tpu.ops.pallas.upconv import up_concat_conv as jupconv

from egm_unet_torch.ops.cuda import (build, conv3x3, launch_counts, mca,
                                     reset_launch_counts, resize2x, upconv)

from tests.torch_port_util import assert_close, to_torch


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _gates(rng, b, h, w, c):
    return [rng.uniform(0.0, 1.0, (b, n)).astype(np.float32) for n in (h, w, c)]


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 9, 13, 16), (1, 6, 10, 8)])
def test_mca_plain_matches_pallas(shape):
    rng = np.random.default_rng(0)
    x = _rand(rng, shape)
    gates = _gates(rng, *shape)
    ref = jmca(jnp.asarray(x), *map(jnp.asarray, gates), groups=4, interpret=True)
    out = mca.mca_plain(to_torch(x), *map(to_torch, gates), groups=4)
    assert_close(out, ref, 1e-5, 1e-5)


def test_mca_plain_matches_pallas_bf16():
    rng = np.random.default_rng(1)
    x = _rand(rng, (1, 8, 12, 16))
    gates = _gates(rng, 1, 8, 12, 16)
    ref = np.asarray(jmca(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, gates),
                          interpret=True), np.float32)
    out = mca.mca_plain(to_torch(x).bfloat16(), *map(to_torch, gates))
    assert out.dtype == torch.bfloat16
    assert_close(out, ref, 0, 2.0 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("c,co,bias,relu", [(8, 16, True, True), (16, 8, False, False),
                                            (3, 8, True, True), (12, 20, True, False)])
def test_conv3x3_plain_matches_pallas(c, co, bias, relu):
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 8, 12, c))
    w = _rand(rng, (3, 3, c, co), 0.2)
    b = _rand(rng, (co,), 0.1) if bias else None
    ref = jconv3x3(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                   relu=relu, interpret=True)
    out = conv3x3.conv3x3_plain(to_torch(x), to_torch(w),
                                None if b is None else to_torch(b), relu=relu)
    assert_close(out, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("dims", [(2, 4, 6, 8, 8, 12), (1, 8, 5, 16, 8, 8)])
def test_up_concat_conv_plain_matches_pallas(dims):
    b, h, w, c1, c2, co = dims
    rng = np.random.default_rng(3)
    x1 = _rand(rng, (b, h, w, c1))
    x2 = _rand(rng, (b, 2 * h, 2 * w, c2))
    k = _rand(rng, (3, 3, c1 + c2, co), 0.1)
    bias = _rand(rng, (co,), 0.1)
    ref = jupconv(jnp.asarray(x2), jnp.asarray(x1), jnp.asarray(k), jnp.asarray(bias),
                  interpret=True)
    out = upconv.up_concat_conv_plain(to_torch(x2), to_torch(x1), to_torch(k),
                                      to_torch(bias))
    assert_close(out, ref, 1e-5, 1e-5)


def test_wrappers_take_the_plain_path_on_cpu():
    rng = np.random.default_rng(4)
    before = launch_counts()
    x = to_torch(_rand(rng, (1, 6, 8, 8)))
    w, b = to_torch(_rand(rng, (3, 3, 8, 4))), to_torch(_rand(rng, (4,)))
    torch.testing.assert_close(conv3x3.conv3x3_gemm(x, w, b, relu=True),
                               conv3x3.conv3x3_plain(x, w, b, relu=True), rtol=0, atol=0)
    gates = [to_torch(g) for g in _gates(rng, 1, 6, 8, 8)]
    torch.testing.assert_close(mca.mca_fused(x, *gates), mca.mca_plain(x, *gates),
                               rtol=0, atol=0)
    x2 = to_torch(_rand(rng, (1, 12, 16, 4)))
    k = to_torch(_rand(rng, (3, 3, 12, 4)))
    torch.testing.assert_close(upconv.up_concat_conv(x2, x, k, b),
                               upconv.up_concat_conv_plain(x2, x, k, b), rtol=0, atol=0)
    assert launch_counts() == before  # no kernel ran


def test_wrappers_reject_bad_arguments():
    x = torch.zeros(1, 6, 8, 8)
    w, b = torch.zeros(3, 3, 8, 4), torch.zeros(4)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_gemm(x, torch.zeros(3, 3, 5, 4), b)  # C mismatch
    with pytest.raises(ValueError):
        conv3x3.conv3x3_gemm(x, w, torch.zeros(5))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_gemm(x[0], w, b)  # not 4-D
    with pytest.raises(TypeError):
        conv3x3.conv3x3_gemm(x.double(), w, b)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_gemm(x.permute(0, 2, 1, 3), torch.zeros(3, 3, 8, 4), b)  # strided
    g = [torch.zeros(1, n) for n in (6, 8, 8)]
    with pytest.raises(ValueError):
        mca.mca_fused(x, g[0], g[1], torch.zeros(1, 7))
    with pytest.raises(TypeError):
        mca.mca_fused(x, g[0].double(), g[1], g[2])
    with pytest.raises(ValueError):
        mca.mca_fused(x[..., :6], g[0], g[1], torch.zeros(1, 6))  # 6 % 4
    with pytest.raises(ValueError):
        upconv.up_concat_conv(torch.zeros(1, 12, 15, 4), x, torch.zeros(3, 3, 12, 4), b)
    with pytest.raises(TypeError):
        upconv.up_concat_conv(torch.zeros(1, 12, 16, 4).bfloat16(), x,
                              torch.zeros(3, 3, 12, 4), b)


def test_pair_and_upsample_wrappers_take_the_plain_path_on_cpu():
    rng = np.random.default_rng(5)
    before = launch_counts()
    assert set(before) == {"conv3x3_gemm", "conv3x3_pair_gemm", "mca_fused", "mca_gates",
                           "eafe_edge", "up_concat_conv", "upsample2x_fused",
                           "csa_attention"}
    for dtype in (torch.float32, torch.bfloat16):
        x = to_torch(_rand(rng, (1, 6, 8, 8))).to(dtype)
        w1, b1 = to_torch(_rand(rng, (3, 3, 8, 5), 0.2)), to_torch(_rand(rng, (5,)))
        w2, b2 = to_torch(_rand(rng, (3, 3, 5, 4), 0.2)), to_torch(_rand(rng, (4,)))
        out = conv3x3.conv3x3_pair_gemm(x, w1, b1, w2, b2)
        assert out.dtype == dtype and out.shape == (1, 6, 8, 4)
        torch.testing.assert_close(out, conv3x3.conv3x3_pair_plain(x, w1, b1, w2, b2),
                                   rtol=0, atol=0)
        up = resize2x.upsample2x_fused(x)
        assert up.dtype == dtype and up.shape == (1, 12, 16, 8)
        torch.testing.assert_close(up, resize2x.upsample2x_plain(x), rtol=0, atol=0)
    assert launch_counts() == before  # no kernel ran


def test_launch_counters_reset_by_name():
    build.LAUNCHES.update(conv3x3_pair_gemm=3, upsample2x_fused=2, conv3x3_gemm=1)
    counts = launch_counts()
    assert (counts["conv3x3_pair_gemm"], counts["upsample2x_fused"],
            counts["conv3x3_gemm"]) == (3, 2, 1)
    reset_launch_counts()
    assert not any(launch_counts().values())


def test_kernel_set_comes_from_csrc():
    assert build.KERNELS == ("conv3x3", "conv3x3_pair", "csa_attention", "eafe_edge",
                             "mca_fused", "mca_gates", "up_concat_conv", "upsample2x")
    assert set(launch_counts()) == {
        "conv3x3_gemm", "conv3x3_pair_gemm", "mca_fused", "up_concat_conv",
        "upsample2x_fused", "csa_attention", "mca_gates", "eafe_edge"}


def test_pair_and_upsample_wrappers_reject_bad_arguments():
    x = torch.zeros(1, 6, 8, 8)
    w1, b1, w2, b2 = (torch.zeros(3, 3, 8, 5), torch.zeros(5), torch.zeros(3, 3, 5, 4),
                      torch.zeros(4))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_pair_gemm(x, torch.zeros(3, 3, 7, 5), b1, w2, b2)  # C mismatch
    with pytest.raises(ValueError):
        conv3x3.conv3x3_pair_gemm(x, w1, b1, torch.zeros(3, 3, 6, 4), b2)  # Cm mismatch
    with pytest.raises(ValueError):
        conv3x3.conv3x3_pair_gemm(x, w1, torch.zeros(4), w2, b2)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_pair_gemm(x, w1, b1, w2, torch.zeros(5))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_pair_gemm(x[0], w1, b1, w2, b2)  # not 4-D
    with pytest.raises(TypeError):
        conv3x3.conv3x3_pair_gemm(x.double(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_pair_gemm(x.permute(0, 2, 1, 3), w1, b1, w2, b2)  # strided
    with pytest.raises(ValueError):
        resize2x.upsample2x_fused(x[0])
    with pytest.raises(TypeError):
        resize2x.upsample2x_fused(x.half())
    with pytest.raises(ValueError):
        resize2x.upsample2x_fused(x.permute(0, 2, 1, 3))


@pytest.mark.parametrize("c,cm,co,itemsize,tile", [
    # the five sites of the pair / fused-upsample route, bfloat16 (tensor cores)
    (3, 32, 32, 2, (8, 16, 32, 32, True)),        # the stem: weights resident, 70 KB
    (64, 32, 32, 2, (8, 16, 32, 32, True)),       # up4: weights resident, 104 KB
    (128, 64, 32, 2, (16, 16, 64, 32, False)),    # up3
    (256, 128, 64, 2, (16, 16, 64, 64, False)),   # up2: 203 KB
    (512, 256, 128, 2, (8, 16, 128, 128, False)),  # up1: 16x16 would need 292 KB
    # ... and in float32 (CUDA cores)
    (3, 32, 32, 4, (8, 16, 32, 32, False)),       # narrow sub-tiles
    (128, 64, 32, 4, (8, 16, 64, 64, False)),
    (512, 256, 128, 4, (8, 16, 64, 64, False)),   # 184 KB
    # vanilla unet, base_c 64
    (1024, 512, 256, 2, (8, 8, 64, 64, False)),
    (1024, 512, 256, 4, (8, 8, 64, 64, False)),   # 360 KB at 8x16, 200 KB at 8x8
    # the odd widths of the GPU smoke run: every tile and chunk pair
    (16, 200, 24, 2, (8, 16, 128, 64, False)),
    (16, 200, 20, 2, (8, 8, 64, 64, False)),      # Co % 8 != 0: no tile of the TMA unit
    (16, 208, 136, 2, (8, 16, 128, 128, False)),
    (5, 20, 33, 2, (8, 16, 64, 64, True)),
    (8, 40, 24, 2, (8, 16, 64, 32, True)),
    (32, 72, 40, 2, (16, 16, 64, 64, False)),
    (33, 70, 40, 2, (8, 8, 64, 64, False)),       # C, Cm % 8 != 0 likewise
    (512, 32, 32, 2, (16, 16, 64, 32, False)),    # narrow, but 32 chunks of w1 do not fit
    (8, 400, 16, 2, (8, 8, 64, 64, False)),
    (8, 800, 16, 2, (4, 4, 64, 64, False)),
    (8, 1300, 8, 2, (4, 4, 64, 64, False)),
    (8, 1300, 8, 4, (4, 4, 64, 64, False)),
    (4, 3000, 4, 2, (2, 2, 64, 64, False)),
    (4, 3000, 4, 4, (2, 2, 64, 64, False)),
])
def test_pair_tile_fits_shared_memory(c, cm, co, itemsize, tile):
    assert conv3x3.pair_tile(c, cm, co, itemsize) == tile
    th, tw, bn1, bn2, resident = tile
    need = conv3x3.pair_smem_bytes(tile, c, cm, co, itemsize)
    assert need <= (conv3x3.PAIR_RESIDENT_LIMIT if resident else conv3x3.SMEM_LIMIT)
    halo = (th + 2) * (tw + 2)
    if itemsize == 4:  # float32 staging of a K chunk of 16 + the intermediate
        assert need == 4 * 16 * (68 + bn1) + halo * cm * 4
    else:
        up16 = lambda n: -(-n // 16) * 16
        mid = halo * (up16(cm) + 8) * 2  # the padded pitch is never a multiple of 128 bytes
        assert (up16(cm) + 8) * 2 % 128 != 0
        xbuf = (th + 4) * (tw + 4) * 24 * 2
        wtile = lambda bn: 9 * 16 * (bn + 8) * 2
        if resident:
            want = mid + 2 * xbuf + -(-cm // bn1) * -(-c // 16) * wtile(bn1) \
                + -(-co // bn2) * -(-cm // 16) * wtile(bn2)
        elif (th, tw) in ((16, 16), (8, 16)):  # TMA: dense slots on 1 KB boundaries
            ring = {64: 3, 128: 2}[max(bn1, bn2)]
            xdense = -(-(th + 4) * (tw + 4) * 32 // 1024) * 1024
            want = mid + ring * (xdense + max(bn1, bn2) // 64 * 9 * 16 * 128) + 1024
        else:
            ring = {32: 4, 64: 3, 128: 2}[max(bn1, bn2)]
            want = mid + ring * (xbuf + wtile(max(bn1, bn2)))
        assert need == want


def test_pair_tile_leaves_the_tma_tiles_to_aligned_tensors():
    """The 16x16 tile and the 8x16 tile with 128-column chunks are filled by
    16-byte copies of the TMA unit: off the 16-byte grid the next tile down
    serves; the resident-weight tile (cp.async or scalar loaders) and float32
    do not care."""
    assert conv3x3.pair_tile(128, 64, 32, 2, aligned=False) == (8, 8, 64, 64, False)
    assert conv3x3.pair_tile(512, 256, 128, 2, aligned=False) == (8, 8, 64, 64, False)
    assert conv3x3.pair_tile(64, 32, 32, 2, aligned=False) == (8, 16, 32, 32, True)
    assert conv3x3.pair_tile(512, 256, 128, 4, aligned=False) == (8, 16, 64, 64, False)


def test_pair_tile_refuses_what_cannot_fit():
    for itemsize, cm in ((4, 4000), (2, 8000)):
        with pytest.raises(ValueError, match="shared memory"):
            conv3x3.pair_tile(8, cm, 8, itemsize)
    needed, executed = conv3x3.pair_flops((8, 72, 96, 512), 256, 128, 2)
    assert needed == 2.0 * 8 * 72 * 96 * 9 * (512 * 256 + 256 * 128)
    # 8x16 tiles: conv1 on 192 padded halo rows per 128 pixels
    assert executed == 2.0 * 8 * 9 * 6 * (192 * 256 * 4608 + 128 * 128 * 2304)


@pytest.mark.parametrize("shape,cm,co,itemsize,hand", [
    # up3, bfloat16: 16x16 tiles, 324 halo rows padded to 336, Co = 32 in one chunk of 32
    ((8, 288, 384, 128), 64, 32, 2, 2.0 * 8 * 18 * 24 * (336 * 64 * 9 * 128 + 256 * 32 * 9 * 64)),
    # the stem, bfloat16: C = 3 padded to 16 per tap
    ((8, 576, 768, 3), 32, 32, 2, 2.0 * 8 * 72 * 48 * (192 * 32 * 9 * 16 + 128 * 32 * 9 * 32)),
    # the stem, float32: 180 halo rows padded to 192, K = 27 to 32
    ((8, 576, 768, 3), 32, 32, 4, 2.0 * 8 * 72 * 48 * (192 * 32 * 32 + 128 * 32 * 288)),
    # ragged map: tiles are counted whole
    ((1, 9, 20, 16), 200, 24, 2, 2.0 * 2 * 2 * (192 * 256 * 9 * 16 + 128 * 64 * 9 * 208)),
])
def test_pair_flops_counts_padded_tiles(shape, cm, co, itemsize, hand):
    needed, executed = conv3x3.pair_flops(shape, cm, co, itemsize)
    b, h, w, c = shape
    assert needed == 2.0 * b * h * w * 9 * (c * cm + cm * co)
    assert executed == hand and executed >= needed


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "mma_bf16"),
                                           (torch.float32, "cuda_cores_f32")])
def test_pair_variant_is_a_function_of_dtype(dtype, variant):
    assert conv3x3.pair_variant(dtype) == variant
    with pytest.raises(TypeError):
        conv3x3.pair_variant(torch.float16)
