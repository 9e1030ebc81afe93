"""egm_unet_torch primitive ops against their egm_unet_tpu counterparts, on
the CPU in float32.  Inputs come from a seeded numpy generator.

Tolerances: pooling, shuffle and the interpolation matrices are exact (the
same float32 operations or pure data movement); resizes and the FFT audit
path sum in a different order than XLA, so they agree to 1e-5; nearest
resizes are gathers and exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egm_unet_tpu.ops import conv as jconv
from egm_unet_tpu.ops import fft as jfft
from egm_unet_tpu.ops import pooling as jpool
from egm_unet_tpu.ops import resize as jresize
from egm_unet_tpu.ops.shuffle import channel_shuffle as jshuffle

from egm_unet_torch.ops import conv, fft, pooling, resize
from egm_unet_torch.ops.shuffle import channel_shuffle

from tests.torch_port_util import assert_close, to_torch


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("args", [(2, None, 0), (3, 1, 1), (3, 2, 1)])
def test_max_pool2d(args):
    x = _x((2, 11, 14, 5))
    out = pooling.max_pool2d(to_torch(x), *args)
    assert_close(out, jpool.max_pool2d(jnp.asarray(x), *args), 0, 0)


def test_min_and_avg_pool2d():
    x = _x((2, 9, 12, 6), seed=1)
    assert_close(pooling.min_pool2d(to_torch(x), 3, 1, 1),
                 jpool.min_pool2d(jnp.asarray(x), 3, 1, 1), 0, 0)
    # count_include_pad: the border means divide by 9
    assert_close(pooling.avg_pool2d(to_torch(x), 3, 1, 1),
                 jpool.avg_pool2d(jnp.asarray(x), 3, 1, 1), 1e-5, 1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("n_in,n_out", [(1, 5), (5, 1), (7, 14), (36, 72), (576, 565)])
def test_linear_matrix(n_in, n_out, align_corners):
    ours = resize._linear_matrix(n_in, n_out, align_corners)
    np.testing.assert_array_equal(ours, jresize._linear_matrix(n_in, n_out, align_corners))
    lo, hi, w_lo, w_hi = resize.linear_taps(n_in, n_out, align_corners)
    rebuilt = np.zeros_like(ours)
    rows = np.arange(n_out)
    rebuilt[rows, lo] += w_lo
    rebuilt[rows, hi] += w_hi
    np.testing.assert_array_equal(rebuilt, ours)


@pytest.mark.parametrize("shape,out_hw,align", [
    ((2, 8, 12, 3), (13, 7), False),
    ((1, 9, 5, 4), (18, 10), True),
    ((16, 20, 1), (15, 33), False),  # HWC, the serving back-resize
    ((2, 22, 22, 2), (35, 47), False),  # CLIPSeg logits to the UNet grid
])
def test_resize_bilinear(shape, out_hw, align):
    x = _x(shape, seed=2)
    out = resize.resize_bilinear(to_torch(x), out_hw, align_corners=align)
    ref = jresize.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align)
    assert_close(out, ref, 1e-5, 1e-5)


def test_upsample2x():
    x = _x((2, 5, 7, 4), seed=3)
    assert_close(resize.upsample2x_bilinear_align_corners(to_torch(x)),
                 jresize.upsample2x_bilinear_align_corners(jnp.asarray(x),
                                                           impl="matmul"),
                 1e-5, 1e-5)


def test_channel_shuffle():
    x = _x((2, 3, 4, 16), seed=4)
    assert_close(channel_shuffle(to_torch(x), 4), jshuffle(jnp.asarray(x), 4), 0, 0)
    with pytest.raises(ValueError):
        channel_shuffle(to_torch(x[..., :6]), 4)


def test_fft_magnitude_enhance():
    x = _x((2, 8, 6, 3), seed=5)
    fast = fft.fft_magnitude_enhance(to_torch(x), 1.1)
    exact = fft.fft_magnitude_enhance(to_torch(x), 1.1, exact=True)
    assert_close(fast, jfft.fft_magnitude_enhance(jnp.asarray(x), 1.1), 0, 0)
    assert_close(exact, jfft.fft_magnitude_enhance(jnp.asarray(x), 1.1, exact=True),
                 1e-5, 1e-5)
    # the audit path: the spectrum scaling is 1.1 * x up to float32 roundoff
    torch.testing.assert_close(exact, fast, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("n_in,n_out", [(1, 4), (6, 1), (14, 22), (22, 14), (7, 7)])
def test_cubic_matrix(n_in, n_out, align_corners):
    np.testing.assert_array_equal(resize._cubic_matrix(n_in, n_out, align_corners),
                                  jresize._cubic_matrix(n_in, n_out, align_corners))


@pytest.mark.parametrize("shape,out_hw,align", [
    ((14, 14, 8), (22, 22), False),  # the ViT positional grid, 224 -> 352 px
    ((2, 6, 9, 3), (4, 13), True),
])
def test_resize_bicubic(shape, out_hw, align):
    x = _x(shape, seed=6)
    out = resize.resize_bicubic(to_torch(x), out_hw, align_corners=align)
    ref = jresize.resize_bicubic(jnp.asarray(x), out_hw, align_corners=align)
    assert_close(out, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("mode", ["torch", "pil"])
@pytest.mark.parametrize("shape,out_hw", [((2, 9, 7, 3), (4, 15)), ((11, 6, 1), (23, 5)),
                                          ((8, 8), (3, 20))])
def test_resize_nearest(shape, out_hw, mode):
    x = _x(shape, seed=7)
    assert_close(resize.resize_nearest(to_torch(x), out_hw, mode=mode),
                 jresize.resize_nearest(jnp.asarray(x), out_hw, mode=mode), 0, 0)
    ints = torch.arange(int(np.prod(shape))).reshape(shape)
    out = resize.resize_nearest(ints, out_hw, mode=mode)
    assert out.dtype == torch.int64  # any dtype: a gather
    with pytest.raises(ValueError):
        resize.resize_nearest(to_torch(x), out_hw, mode="cv2")


@pytest.mark.parametrize("shape,k,cout", [((2, 3, 4, 6), 2, 3), ((1, 2, 2, 16), 16, 1)])
def test_conv_transpose2d_nonoverlap(shape, k, cout):
    x = _x(shape, seed=8)
    w = _x((shape[-1], k, k, cout), seed=9)
    out = conv.conv_transpose2d_nonoverlap(to_torch(x), to_torch(w))
    assert out.shape == (shape[0], shape[1] * k, shape[2] * k, cout)
    assert_close(out, jconv.conv_transpose2d_nonoverlap(jnp.asarray(x), jnp.asarray(w)),
                 1e-5, 1e-5)
    # against torch's own transposed conv (OIHW-style (in, out, kh, kw) weights)
    ref = torch.nn.functional.conv_transpose2d(
        to_torch(x).permute(0, 3, 1, 2), to_torch(w).permute(0, 3, 1, 2), stride=k)
    torch.testing.assert_close(out, ref.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        conv.conv_transpose2d_nonoverlap(to_torch(x), to_torch(w[:-1]))
