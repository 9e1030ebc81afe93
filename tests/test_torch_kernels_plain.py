"""The plain PyTorch versions of the port's three CUDA kernels against the
JAX package's Pallas kernels, run in interpret mode on the CPU as the JAX
tests run them, and the wrappers' CPU routing and argument checks.

Tolerances: float32 agrees to 1e-5 (the same float32 products summed in
another order); bfloat16 to one bfloat16 rounding step (2**-7 relative) of
the output's magnitude, since the two round the same float32 values."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egm_unet_tpu.ops.pallas.conv3x3 import conv3x3_gemm as jconv3x3
from egm_unet_tpu.ops.pallas.mca import mca_fused as jmca
from egm_unet_tpu.ops.pallas.upconv import up_concat_conv as jupconv

from egm_unet_torch.ops.cuda import conv3x3, launch_counts, mca, upconv

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
