"""egm_unet_torch primitive ops against their egm_unet_tpu counterparts, on
the CPU in float32.  Inputs come from a seeded numpy generator.

Tolerances: pooling, shuffle and the interpolation matrices are exact (the
same float32 operations or pure data movement); resizes and the FFT audit
path sum in a different order than XLA, so they agree to 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egm_unet_tpu.ops import fft as jfft
from egm_unet_tpu.ops import pooling as jpool
from egm_unet_tpu.ops import resize as jresize
from egm_unet_tpu.ops.shuffle import channel_shuffle as jshuffle

from egm_unet_torch.ops import fft, pooling, resize
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
