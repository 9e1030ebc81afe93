"""The pair / fused-upsample routes of egm_unet_torch against the JAX package,
on the CPU.

- ``conv3x3_pair_plain`` and ``upsample2x_plain`` against the Pallas kernels
  ``conv3x3_pair_gemm`` and ``upsample2x_fused`` in interpret mode, as the JAX
  package's own tests run them off the TPU.
- ``DoubleConv``, ``Up`` and the whole models on each route against the flax
  modules with ``EGM_CONV_IMPL=pallas-pair`` / ``EGM_UPSAMPLE_IMPL=pallas-all``
  set.  The JAX switches are read at trace time, so every reference runs under
  a fresh ``jax.jit``; a counting wrapper shows that the JAX side really
  reached its kernels.

Tolerances: float32 kernels rtol 1e-5 / atol 1e-4 (the bar of
tests/test_conv3x3.py for the pair kernel: the same float32 products summed in
another order through two convs) and atol 1e-5 for the upsample; bfloat16 one
rounding step (2**-7 relative) of the output's magnitude; modules 1e-4 and
whole models 1e-3 as tests/test_torch_modules.py and test_torch_model.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egm_unet_tpu.ops.pallas.conv3x3 as jconv_mod
import egm_unet_tpu.ops.pallas.resize2x as jresize_mod
from egm_unet_tpu.models import create_model as jcreate
from egm_unet_tpu.models.fold_bn import fold_bn_variables as jfold
from egm_unet_tpu.models.unet import Up as JUp
from egm_unet_tpu.nn.layers import DoubleConv as JDoubleConv

from egm_unet_torch.models import create_model
from egm_unet_torch.models.unet import Up
from egm_unet_torch.nn.layers import DoubleConv
from egm_unet_torch.ops.cuda import conv3x3, launch_counts, resize2x
from egm_unet_torch.ops.resize import upsample2x_bilinear_align_corners
from egm_unet_torch.utils import load_flax_variables

from tests.torch_port_util import assert_close, random_variables, to_torch

torch.set_grad_enabled(False)

# route -> (conv_impl, upsample_impl) of the port, and the JAX switches
ROUTES = {
    "pair": (("pair", "matmul"), {"EGM_CONV_IMPL": "pallas-pair"}),
    "fused": (("gemm", "fused"), {"EGM_UPSAMPLE_IMPL": "pallas-all"}),
    "pair+fused": (("pair", "fused"), {"EGM_CONV_IMPL": "pallas-pair",
                                       "EGM_UPSAMPLE_IMPL": "pallas-all"}),
}


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _frame(a):
    """The one-pixel border of an NHWC array, flattened."""
    mask = np.ones(a.shape[1:3], bool)
    mask[1:-1, 1:-1] = False
    return np.asarray(a)[:, mask]


def _pair_inputs(shape, cm, co, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (_rand(rng, shape), _rand(rng, (3, 3, c, cm), (2 / (9 * c)) ** 0.5),
            _rand(rng, (cm,), 0.1), _rand(rng, (3, 3, cm, co), (2 / (9 * cm)) ** 0.5),
            _rand(rng, (co,), 0.1))


@pytest.mark.parametrize("shape,cm,co", [((1, 8, 8, 32), 64, 64),
                                         ((1, 8, 10, 64), 32, 32),
                                         ((1, 12, 16, 128), 64, 96)])
def test_conv3x3_pair_plain_matches_pallas(shape, cm, co):
    args = _pair_inputs(shape, cm, co, seed=0)
    ref = np.asarray(jconv_mod.conv3x3_pair_gemm(*map(jnp.asarray, args), interpret=True))
    out = conv3x3.conv3x3_pair_plain(*map(to_torch, args))
    assert out.shape == shape[:3] + (co,)
    assert_close(out, ref, 1e-5, 1e-4)
    # the border is where the halo mask acts: conv1 outside the image is not
    # zero, conv2 must see zero there
    np.testing.assert_allclose(_frame(out.numpy()), _frame(ref), rtol=1e-5, atol=1e-4)
    assert np.abs(_frame(ref)).max() > 0.1


def test_conv3x3_pair_plain_matches_pallas_bf16():
    x, w1, b1, w2, b2 = _pair_inputs((1, 8, 8, 32), 64, 32, seed=1)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = np.asarray(jconv_mod.conv3x3_pair_gemm(
        bf(x), bf(w1), jnp.asarray(b1), bf(w2), jnp.asarray(b2), interpret=True),
        np.float32)
    out = conv3x3.conv3x3_pair_plain(to_torch(x).bfloat16(), to_torch(w1), to_torch(b1),
                                     to_torch(w2), to_torch(b2))
    assert out.dtype == torch.bfloat16
    step = 2.0 ** -7 * np.abs(ref).max()
    assert_close(out, ref, 0, step)
    np.testing.assert_allclose(_frame(out.float().numpy()), _frame(ref), rtol=0, atol=step)


def test_pair_halo_mask_matters():
    """A pair that let conv1's out-of-image values through would differ from
    the plain version on the border only; this shows the test inputs can tell
    the two apart."""
    x, w1, b1, w2, b2 = map(to_torch, _pair_inputs((1, 6, 7, 8), 8, 8, seed=2))
    good = conv3x3.conv3x3_pair_plain(x, w1, b1, w2, b2)
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    mid = conv3x3.conv3x3_plain(padded, w1, b1, relu=True)  # conv1 on the halo too
    bad = conv3x3.conv3x3_plain(mid, w2, b2, relu=True)[:, 1:-1, 1:-1]
    diff = (good - bad).abs().numpy()
    assert diff[:, 1:-1, 1:-1].max() == 0.0
    assert _frame(diff).max() > 1e-2


@pytest.mark.parametrize("shape", [(1, 8, 8, 128), (2, 8, 16, 32), (1, 40, 56, 8)])
def test_upsample2x_plain_matches_pallas(shape):
    x = _rand(np.random.default_rng(3), shape)
    ref = np.asarray(jresize_mod.upsample2x_fused(jnp.asarray(x)))
    out = resize2x.upsample2x_plain(to_torch(x))
    assert out.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    assert_close(out, ref, 0, 1e-5)
    # float32: the matmul form differs by summation order only
    assert_close(upsample2x_bilinear_align_corners(to_torch(x)), ref, 0, 1e-5)


@pytest.mark.parametrize("shape", [(1, 8, 8, 128), (1, 16, 8, 64)])
def test_upsample2x_plain_matches_pallas_bf16(shape):
    x = _rand(np.random.default_rng(4), shape)
    ref = np.asarray(jresize_mod.upsample2x_fused(jnp.asarray(x, jnp.bfloat16)),
                     np.float32)
    out = resize2x.upsample2x_plain(to_torch(x).bfloat16())
    assert out.dtype == torch.bfloat16
    assert_close(out, ref, 0, 2.0 ** -7 * np.abs(ref).max())


def test_upsample2x_zero_tap_skips_non_finite_neighbour():
    """Output row 0 and column 0 have one tap of weight 1; an infinite value
    elsewhere must reach only the outputs that blend it with a non-zero
    weight."""
    x = torch.zeros(1, 4, 4, 2)
    x[0, 1, 1, 0] = float("inf")
    out = resize2x.upsample2x_plain(x)
    assert torch.isfinite(out[0, 0]).all() and torch.isfinite(out[0, :, 0]).all()
    assert torch.isfinite(out[..., 1]).all()
    assert not torch.isfinite(out[0, 2, 2, 0])


def test_upsample_impl_argument():
    x = to_torch(_rand(np.random.default_rng(5), (1, 5, 7, 3)))
    torch.testing.assert_close(upsample2x_bilinear_align_corners(x, "fused"),
                               resize2x.upsample2x_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(upsample2x_bilinear_align_corners(x, "matmul"),
                               upsample2x_bilinear_align_corners(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="upsample impl"):
        upsample2x_bilinear_align_corners(x, "gather")
    with pytest.raises(ValueError, match="conv impl"):
        DoubleConv(4, 4, conv_impl="pallas")
    with pytest.raises(ValueError, match="upsample impl"):
        create_model("egm_unet", base_c=8, upsample_impl="pallas")


def _count_calls(monkeypatch, module, name):
    calls = []
    inner = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


def _jax_on_route(monkeypatch, env, fn, *args):
    """``fn(*args)`` traced anew with the JAX switches of ``env`` set;
    returns (numpy result, number of pair-kernel calls, of upsample-kernel
    calls) made while tracing."""
    for k in ("EGM_CONV_IMPL", "EGM_UPSAMPLE_IMPL", "EGM_UP_IMPL", "EGM_CONV_SITES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pair = _count_calls(monkeypatch, jconv_mod, "conv3x3_pair_gemm")
    ups = _count_calls(monkeypatch, jresize_mod, "upsample2x_fused")
    out = np.asarray(jax.jit(lambda *a: fn(*a))(*args))
    return out, len(pair), len(ups)


@pytest.mark.parametrize("route", ["pair", "pair+fused"])
def test_double_conv_on_route(route, monkeypatch):
    (conv_impl, up_impl), env = ROUTES[route]
    x = _rand(np.random.default_rng(6), (2, 8, 8, 32))
    v = random_variables(JDoubleConv(32), jnp.asarray(x), train=True, seed=1)
    folded = JDoubleConv(32, fold_bn=True)
    ref, n_pair, _ = _jax_on_route(monkeypatch, env, folded.apply, jfold(v),
                                   jnp.asarray(x))
    assert n_pair == 1
    port = load_flax_variables(
        DoubleConv(32, 32, conv_impl=conv_impl, upsample_impl=up_impl), v)
    assert_close(port(to_torch(x)), ref, 1e-4, 1e-4)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_up_on_route(route, monkeypatch):
    (conv_impl, up_impl), env = ROUTES[route]
    rng = np.random.default_rng(7)
    x1, x2 = _rand(rng, (2, 8, 8, 32)), _rand(rng, (2, 16, 16, 32))
    v = random_variables(JUp(32), jnp.asarray(x1), jnp.asarray(x2), train=True, seed=2)
    folded = JUp(32, fold_bn=True)
    ref, n_pair, n_ups = _jax_on_route(monkeypatch, env, folded.apply, jfold(v),
                                       jnp.asarray(x1), jnp.asarray(x2))
    assert n_pair == ("pair" in route) and n_ups == ("fused" in route)
    port = load_flax_variables(
        Up(32, 32, 32, conv_impl=conv_impl, upsample_impl=up_impl), v)
    assert_close(port(to_torch(x1), to_torch(x2)), ref, 1e-4, 1e-4)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_up_on_route_odd_size(route, monkeypatch):
    """x2 is not twice x1: the upsample (by ``upsample_impl``), the pad and
    the concat come first on every route; the JAX default route is the
    reference (its kernels' guards refuse these shapes)."""
    conv_impl, up_impl = ROUTES[route][0]
    rng = np.random.default_rng(8)
    x1, x2 = _rand(rng, (1, 4, 5, 16)), _rand(rng, (1, 9, 11, 16))
    v = random_variables(JUp(8), jnp.asarray(x1), jnp.asarray(x2), train=True, seed=3)
    ref, n_pair, n_ups = _jax_on_route(monkeypatch, {}, JUp(8, fold_bn=True).apply,
                                       jfold(v), jnp.asarray(x1), jnp.asarray(x2))
    assert n_pair == 0 and n_ups == 0
    port = load_flax_variables(
        Up(16, 16, 8, conv_impl=conv_impl, upsample_impl=up_impl), v)
    assert_close(port(to_torch(x1), to_torch(x2)), ref, 1e-4, 1e-4)


@pytest.fixture(scope="module")
def model_weights():
    x = np.random.default_rng(9).standard_normal((1, 64, 64, 3)).astype(np.float32)
    return x, {name: random_variables(jcreate(name, base_c=8), jnp.asarray(x),
                                      train=True, seed=5)
               for name in ("egm_unet", "unet")}


@pytest.mark.parametrize("name,route", [("egm_unet", "pair"), ("egm_unet", "fused"),
                                        ("egm_unet", "pair+fused"),
                                        ("unet", "pair"), ("unet", "fused"),
                                        ("unet", "pair+fused")])
def test_full_model_on_route(name, route, model_weights, monkeypatch):
    """Whole-model logits against the JAX folded forward with the matching
    switches set.  At base_c 8 the JAX guards accept the pair kernel at up1
    (and at unet's down2..down4) and the upsample kernel where H and W are
    multiples of 8; the other sites fall back to XLA there, which computes the
    same function."""
    (conv_impl, up_impl), env = ROUTES[route]
    x, weights = model_weights
    v = weights[name]
    folded = jcreate(name, base_c=8, fold_bn=True)
    ref, n_pair, n_ups = _jax_on_route(
        monkeypatch, env, lambda fv, a: folded.apply(fv, a)["out"], jfold(v),
        jnp.asarray(x))
    assert (n_pair > 0) == ("pair" in route) and (n_ups > 0) == ("fused" in route)
    port = load_flax_variables(
        create_model(name, base_c=8, conv_impl=conv_impl, upsample_impl=up_impl), v)
    out = port(to_torch(x))["out"]
    assert out.dtype == torch.float32 and out.shape == (1, 64, 64, 2)
    assert_close(out, ref, 1e-3, 1e-3)


@pytest.mark.parametrize("name", ["egm_unet", "unet"])
@pytest.mark.parametrize("hw", [(64, 48), (52, 36)])  # exact 2x stages, padded ones
def test_routes_agree_within_the_port(name, hw):
    """One state dict on every route: equal names, and logits that differ by
    summation order only (the pair route runs the same two convs; the fused
    upsample rounds columns first)."""
    x = to_torch(_rand(np.random.default_rng(10), (1, *hw, 3)))
    gen = lambda: torch.Generator().manual_seed(11)
    base = create_model(name, base_c=8, generator=gen())
    ref = base(x)["out"]
    before = launch_counts()
    for conv_impl, up_impl in (r[0] for r in ROUTES.values()):
        model = create_model(name, base_c=8, conv_impl=conv_impl, upsample_impl=up_impl)
        model.load_state_dict(base.state_dict())  # route-agnostic names
        torch.testing.assert_close(model(x)["out"], ref, rtol=1e-4, atol=1e-4)
    assert launch_counts() == before  # CPU tensors: no kernel ran
