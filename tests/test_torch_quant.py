"""egm_unet_torch's int8 serving quantization (``ops/quant.py`` and its
sites in ``nn/`` and ``models/``) against the JAX package's
``egm_unet_tpu/ops/quant.py``, on the CPU in float32, with JAX's
calibrated scales bridged by ``utils/from_flax.py``.  The JAX side runs
under ``jax.jit`` with the quantization context held around the call (its
``$EGM_QSTORE_SITES`` set to the same sites), its calibration through a
jitted ``apply``.

Tolerances:
- ``requant_store``, the int8 weights of ``quantize_weight_per_channel``
  and the int32 sums of ``int8_conv`` (3x3, 1x1, stride 2, dilated,
  grouped, depthwise; both the CPU's float64 convolution and the card's
  im2col GEMM layout) are exact; the weight scales within one float32 ulp
  (XLA multiplies by the reciprocal of 127); ``int8_conv``'s dequantized
  output within 1e-6 relative;
- calibrated scales: the same path set, values within rtol 1e-5;
- module outputs under int8df / int8 / int8full: within one quantization
  step of the output (its storage scale, or its range / 127 where it is not
  stored) plus 1e-5 of the range on >= 99.9% of elements.  The two
  libraries' float32 convolutions sum in other orders, so a value that lies
  within an ulp of a rounding boundary can land one step apart; that is the
  step the bar allows;
- whole-model and ``Predictor`` masks: >= 99%.  At base_c 8 one such step
  inside the encoder moves the argmax of up to about 0.6% of a 64x64
  image's pixels (measured: 99.4% to 100% over seeds), so the 99.9% bar of
  the float path cannot hold here; the element check above and the exact
  checks are where parity is pinned.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from egm_unet_tpu.models import create_model as jcreate
from egm_unet_tpu.models.fold_bn import fold_bn_variables as jfold
from egm_unet_tpu.nn import attention as jatt
from egm_unet_tpu.nn import grfb as jgrfb
from egm_unet_tpu.nn.layers import DoubleConv as JDoubleConv
from egm_unet_tpu.ops import quant as jq
from egm_unet_tpu.serving import Predictor as JPredictor
from egm_unet_tpu.serving import PredictorConfig as JConfig

from egm_unet_torch.data.synthetic import synthetic_tp_sample
from egm_unet_torch.models import create_model
from egm_unet_torch.nn.attention import MCALayer
from egm_unet_torch.nn.grfb import EdgeEnhancedGRFB
from egm_unet_torch.nn.layers import DoubleConv
from egm_unet_torch.ops import quant as tq
from egm_unet_torch.serving import Predictor, PredictorConfig
from egm_unet_torch.utils import load_flax_variables
from egm_unet_torch.utils.from_flax import flax_quant_scales, quant_scales_from_flax

from tests.torch_port_util import random_variables

MODES = ("int8df", "int8", "int8full")
_CALIB = {}  # (flax module, kwargs) -> jitted apply that sows quant_stats


class JitCalibration:
    """What ``egm_unet_tpu.ops.quant.calibrate_quant_scales`` needs of a
    model (``apply(variables, x, train=..., mutable=...)``), jitted: eager
    flax takes about 40 s for a base_c-8 EGM-UNet on this CPU.  One jitted
    function per module, traced only under the calibrate context."""

    def __init__(self, module, **kw):
        key = (module, tuple(sorted(kw.items())))
        if key not in _CALIB:
            _CALIB[key] = jax.jit(lambda v, x: module.apply(
                v, x, mutable=["quant_stats"], **kw))
        self.fn = _CALIB[key]

    def apply(self, variables, x, train=False, mutable=None):
        return self.fn(variables, x)


def jax_scales(module, v, x, **kw):
    return jq.calibrate_quant_scales(JitCalibration(module, **kw), v, [jnp.asarray(x)])


def jax_forward(module, v, scales, x, mode, **kw):
    def f(v, x):
        with jq.quantized(mode):
            return module.apply({**v, "quant_scales": scales}, x, **kw)
    return jax.jit(f)(v, jnp.asarray(x))


def _x(shape, seed, relu=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) if relu else x


# ------------------------------------------------------------- primitives

@pytest.mark.parametrize("signed", [False, True])
def test_requant_store_equals_jax(signed):
    rng = np.random.default_rng(0)
    s = np.float32(0.0173)
    x = rng.standard_normal((2, 6, 7, 5)).astype(np.float32) * 2
    if not signed:
        x = np.abs(x)
    # exact halves (round half to even), and values past the clip
    x[0, 0, 0, :4] = np.float32(s) * np.float32([0.5, 1.5, 2.5, 300.0])
    x[0, 0, 1, :2] = -np.float32(s) * np.float32([2.5, 300.0])
    ref = np.asarray(jax.jit(lambda a: jq.requant_store(a, jnp.float32(s), signed))(x))
    got = tq.requant_store(torch.from_numpy(x), float(s), signed).numpy()
    np.testing.assert_array_equal(got, ref)
    lo, hi = (-127, 127) if signed else (0, 255)
    inside = (x >= lo * s) & (x <= hi * s)
    assert np.abs(got - x)[inside].max() <= s / 2 + 1e-7


def test_quantize_weight_per_channel_equals_jax():
    w = np.random.default_rng(1).standard_normal((3, 3, 6, 10)).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    jwq, js = jax.jit(jq.quantize_weight_per_channel)(w)
    wq, s = tq.quantize_weight_per_channel(torch.from_numpy(w))
    assert wq.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    # XLA compiles the division by 127 as a product with the reciprocal,
    # PyTorch divides correctly rounded: the scales part by at most an ulp
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2.4e-7, atol=0)


# (kh, ci, co, stride, padding, dilation, groups): every conv of the model
CONVS = {
    "3x3": (3, 6, 10, 1, 1, 1, 1),
    "1x1": (1, 6, 10, 1, 0, 1, 1),
    "stride2": (3, 6, 8, 2, 1, 1, 1),
    "dilated3v": (3, 8, 8, 1, 9, 9, 1),
    "groups2": (3, 8, 8, 1, 1, 1, 2),
    "groups_inter": (3, 4, 8, 1, 1, 1, 4),
    "depthwise": (3, 12, 12, 1, 1, 1, 12),
    "7x7": (7, 2, 1, 1, 3, 1, 1),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_int8_conv_int32_sums_are_exact(name):
    k, ci, co, st, p, d, g = CONVS[name]
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (2, 13, 11, ci)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, k, ci // g, co)).astype(np.int8)
    ref = np.asarray(jax.jit(lambda a, b: lax.conv_general_dilated(
        a, b, (st, st), ((p, p), (p, p)), rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=g,
        preferred_element_type=jnp.int32))(xq, wq))
    args = ((st, st), (p, p), (d, d), g)
    got = tq.int8_conv_sums(torch.from_numpy(xq), torch.from_numpy(wq), *args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # the card's layout (im2col rows, block-diagonal groups, K and N padded
    # to 8, M to 32, images in chunks) with an exact integer matmul
    exact = lambda a, b: (a.long() @ b.long()).to(torch.int32)
    gemm = tq.int8_conv_gemm(torch.from_numpy(xq), torch.from_numpy(wq), *args,
                             matmul=exact, max_elems=2000)
    np.testing.assert_array_equal(gemm.numpy(), ref)


@pytest.mark.parametrize("static", [False, True])
def test_int8_conv_equals_jax(static):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 9, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 8)).astype(np.float32) * 0.2
    b = rng.standard_normal(8).astype(np.float32) * 0.1
    s = np.float32(0.021) if static else None
    ref = np.asarray(jax.jit(lambda x, w, b: jq.int8_conv(
        x, w, b, padding=((1, 1), (1, 1)),
        act_scale=None if s is None else jnp.float32(s)))(x, w, b))
    got = tq.int8_conv(*map(torch.from_numpy, (x, w, b)), padding=(1, 1),
                       act_scale=None if s is None else float(s))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_quant_context_scoping():
    m = DoubleConv(4, 8)
    assert tq.current_quant_mode() is None
    with tq.quantized("int8", m):
        assert tq.current_quant_mode() == "int8" and not tq.convs_on_kernels()
    assert tq.current_quant_mode() is None and tq.convs_on_kernels()
    with pytest.raises(ValueError):
        tq.Quantizer(m, "int4")


def test_site_spec_matching():
    assert tq.site_matches("down1/mca:xout", tq.SHIP_QSTORE_SITES)
    assert tq.site_matches(":pool3", tq.SHIP_QSTORE_SITES)
    assert tq.site_matches("down2/egrfb:res", tq.SHIP_QSTORE_SITES)
    assert not tq.site_matches("down2/egrfb/ctx0:out", tq.SHIP_QSTORE_SITES)
    assert not tq.site_matches("up1/DoubleConv_0/ConvBNReLU_0:out", tq.SHIP_QSTORE_SITES)
    assert tq.site_matches("anything:out", "all") and tq.site_matches("x:y", None)


def test_scale_bridge_round_trip():
    scales = {"down1/conv1/Conv_0/act_scale": 0.25, "pool1_scale": 0.5}
    tree = flax_quant_scales(scales)
    assert float(tree["down1"]["conv1"]["Conv_0"]["act_scale"]) == 0.25
    assert quant_scales_from_flax(tree) == scales


# ------------------------------------------------------------- modules

def _double_conv():
    x = _x((2, 16, 16, 4), 4)
    v = random_variables(JDoubleConv(8), jnp.asarray(x), False)
    return (JDoubleConv(8, fold_bn=True), dict(train=False), v, jfold(v),
            DoubleConv(4, 8), x, "ConvBNReLU_1/out_scale")


def _mca():
    x = _x((2, 12, 10, 32), 5, relu=True)
    v = random_variables(jatt.MCALayer(), jnp.asarray(x))
    return jatt.MCALayer(), {}, v, v, MCALayer(32), x, "out_scale"


def _egrfb():
    x = _x((2, 12, 12, 16), 6, relu=True)
    v = random_variables(jgrfb.EdgeEnhancedGRFB(16), jnp.asarray(x), False)
    return (jgrfb.EdgeEnhancedGRFB(16, fold_bn=True), dict(train=False), v, jfold(v),
            EdgeEnhancedGRFB(16, 16), x, "enh_scale")


MODULES = {"DoubleConv": _double_conv, "MCALayer": _mca, "EdgeEnhancedGRFB": _egrfb}


@functools.lru_cache(maxsize=None)
def module_case(name):
    jm, kw, v, fv, port, x, out_site = MODULES[name]()
    port = load_flax_variables(port, v).eval()
    return jm, kw, fv, port, x, out_site, jax_scales(jm, fv, x, **kw)


@pytest.mark.parametrize("name", list(MODULES))
def test_calibrated_scales_equal_jax(name):
    jm, kw, fv, port, x, _, jsc = module_case(name)
    keys = set(port.state_dict())
    got = tq.calibrate_quant_scales(port, [torch.from_numpy(x)])
    ref = quant_scales_from_flax(jsc)
    assert set(got) == set(ref) and len(got) >= 2
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert set(port.state_dict()) == keys  # scales live outside the state_dict


def assert_within_one_step(got, ref, step):
    d = np.abs(got - ref)
    rng_ = np.abs(ref).max()
    ok = d <= step + 1e-5 * rng_
    assert ok.mean() >= 0.999, (ok.mean(), d.max(), step)
    assert d.max() <= 0.1 * rng_, (d.max(), rng_)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MODULES))
def test_module_modes_match_jax(name, mode, monkeypatch):
    jm, kw, fv, port, x, out_site, jsc = module_case(name)
    scales = quant_scales_from_flax(jsc)
    monkeypatch.setenv("EGM_QSTORE_SITES", "all")
    ref = np.asarray(jax_forward(jm, fv, jsc, x, mode, **kw))
    with torch.no_grad(), tq.quantized(mode, port, scales, "all"):
        got = port(torch.from_numpy(x)).numpy()
    step = scales[out_site] if mode != "int8" else np.abs(ref).max() / 127
    assert_within_one_step(got, ref, step)
    with torch.no_grad():
        plain = port(torch.from_numpy(x)).numpy()
    # every mode changes the output, but int8 that of the MCALayer: it has
    # no Conv, and int8 quantizes convs only
    assert (np.abs(plain - got).max() > 0) == (name != "MCALayer" or mode != "int8")


# ------------------------------------------------------------- the model

SIZE = 64


@functools.lru_cache(maxsize=None)
def model_case():
    jv = random_variables(jcreate("egm_unet", base_c=8), jnp.zeros((1, SIZE, SIZE, 3)),
                          train=True, seed=3)
    jm = jcreate("egm_unet", base_c=8, fold_bn=True)
    fv = jfold(jv)
    x = _x((2, SIZE, SIZE, 3), 7)
    port = load_flax_variables(create_model("egm_unet", base_c=8), jv).eval()
    return jm, fv, port, x, jax_scales(jm, fv, x, train=False)


def test_model_calibrated_scales_equal_jax():
    _, _, port, x, jsc = model_case()
    got = tq.calibrate_quant_scales(port, [torch.from_numpy(x)])
    ref = quant_scales_from_flax(jsc)
    assert set(got) == set(ref) and len(got) == 197
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert "down1/mca/xout_scale" in got and "pool4_scale" in got


@pytest.mark.parametrize("mode", MODES)
def test_model_modes_match_jax(mode, monkeypatch):
    jm, fv, port, x, jsc = model_case()
    scales = quant_scales_from_flax(jsc)
    monkeypatch.setenv("EGM_QSTORE_SITES", "all")
    ref = np.asarray(jax_forward(jm, fv, jsc, x, mode, train=False)["out"])
    keys = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad(), tq.quantized(mode, port, scales, "all"):
        got = port(torch.from_numpy(x))["out"].numpy()
    assert np.isfinite(got).all() and got.shape == ref.shape
    agree = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.99, agree
    assert np.abs(got - ref).max() <= 0.1 * np.abs(ref).max()
    after = port.state_dict()
    assert list(after) == list(keys) and all(torch.equal(after[k], v) for k, v in keys.items())


def test_non_matching_sites_are_bit_identical():
    _, _, port, x, jsc = model_case()
    with torch.no_grad():
        ref = port(torch.from_numpy(x))["out"]
        with tq.quantized("int8df", port, quant_scales_from_flax(jsc), "no-such-site"):
            got = port(torch.from_numpy(x))["out"]
    assert torch.equal(got, ref)


def test_predictor_int8df_matches_jax_predictor(monkeypatch):
    images = [synthetic_tp_sample(i, h, w)[0]
              for i, (h, w) in enumerate([(40, 52), (48, 48), (30, 90)])]
    v = random_variables(jcreate("egm_unet", base_c=8), jnp.zeros((1, 64, 64, 3)),
                         train=True, seed=3)
    kw = dict(base_c=8, batch_size=2, base_size=32, dtype="float32", quant="int8df")
    # the JAX Predictor calibrates eagerly; the same function, jitted
    calibrate = jq.calibrate_quant_scales
    monkeypatch.setattr(jq, "calibrate_quant_scales",
                        lambda model, variables, batches, train=False: calibrate(
                            JitCalibration(model, train=False), variables, batches))
    monkeypatch.setenv("EGM_QSTORE_SITES", jq.SHIP_QSTORE_SITES)
    ref = JPredictor(v, JConfig(**kw)).predict(images)
    pred = Predictor(v, PredictorConfig(**kw), device="cpu")
    out = pred.predict(images)
    assert pred.quantizer.mode == "int8df" and pred.quantizer.sites == tq.SHIP_QSTORE_SITES
    assert pred.calibration_s is not None
    agree = total = 0
    for img, m, r in zip(images, out, ref):
        assert m.shape == img.shape[:2] and m.dtype == np.uint8
        agree += int((m == r).sum())
        total += m.size
    assert agree / total >= 0.99, agree / total
