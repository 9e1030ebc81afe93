"""egm_unet_torch's reference-checkpoint conversion against egm_unet_tpu's:
the reference's EGM-UNet key layout (``tests/test_convert_unet.py``'s
synthetic state dict, base_c 8) through JAX's ``egm_unet_from_torch`` into
the flax model and through the port's converter into ``create_model``
(strict load), eval logits in float32; ``cli/convert.py --kind egm`` served
by ``Predictor.from_checkpoint`` against the JAX Predictor and resumed by
``cli/train.py``; ``--kind clip`` read back by ``load_converted_clip``."""

import contextlib
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.models import MODEL_CONFIGS as J_CONFIGS
from egm_unet_tpu.models import create_model as j_create_model
from egm_unet_tpu.serving import Predictor as JPredictor
from egm_unet_tpu.serving import PredictorConfig as JConfig
from egm_unet_tpu.utils.convert_unet import egm_unet_from_torch as j_egm_unet_from_torch

from egm_unet_torch.cli import convert as convert_cli
from egm_unet_torch.cli import train as train_cli
from egm_unet_torch.data.synthetic import synthetic_tp_sample
from egm_unet_torch.data.transforms import normalize, resize_short_side
from egm_unet_torch.models import create_model
from egm_unet_torch.models.clip.model import CLIP
from egm_unet_torch.serving import Predictor, PredictorConfig
from egm_unet_torch.utils.checkpoint import load_payload, saved_epochs
from egm_unet_torch.utils.convert import load_clip_checkpoint, load_converted_clip
from egm_unet_torch.utils.convert_unet import egm_state_dict, egm_unet_from_torch

from tests.test_convert_unet import fake_reference_state_dict
from tests.test_torch_convert import _clip_sd

BASE_C = 8
VARIANTS = ("egm_unet", "egm_unet_ab", "egm_unet_b", "egm_unet_c")


def reference_layout(name):
    """The reference state dict of ``name``: without the MCALayer the
    encoder Sequential is conv, bn, relu, conv, bn, relu, block (indices 3,
    4, 6 for the second conv, its bn and the block)."""
    sd = fake_reference_state_dict(base_c=BASE_C)
    if J_CONFIGS[name]["use_mca"]:
        return sd
    out = {}
    for k, v in sd.items():
        m = re.match(r"(down\d\.1)\.(\d+)\.(.*)", k)
        if m:
            idx = int(m[2])
            if idx == 3:  # the MCALayer's gates
                continue
            k = f"{m[1]}.{ {4: 3, 5: 4, 7: 6}.get(idx, idx)}.{m[3]}"
        out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def served_reference(name="egm_unet"):
    """``reference_layout(name)`` with every conv kernel wider than 1x1 at
    He scale (the synthetic dict's 0.05 leaves the logits nearly constant
    over the image) and the out conv's class-1 bias moved so that about half
    of a synthetic image's pixels are foreground: masks that depend on the
    image, for the serving comparison."""
    sd = {}
    for k, v in reference_layout(name).items():
        v = np.asarray(v, np.float32)
        if v.ndim == 4 and k.endswith(".weight") and v.shape[2] > 1:
            v = (v / 0.05 * np.sqrt(2.0 / np.prod(v.shape[1:]))).astype(np.float32)
        sd[k] = v
    params, stats = j_egm_unet_from_torch(sd, **J_CONFIGS[name])
    img = normalize(resize_short_side(synthetic_tp_sample(0, 48, 48)[0], None, 32)[0])
    jm = j_create_model(name, base_c=BASE_C)
    out = jax.jit(lambda v, x: jm.apply(v, x, train=False)["out"])(
        {"params": params, "batch_stats": stats}, jnp.asarray(img[None]))
    bias = sd["out_conv.0.bias"].copy()
    bias[1] -= float(np.median(np.asarray(out[..., 1] - out[..., 0])))
    sd["out_conv.0.bias"] = bias
    return sd


def _images(n=2, size=48, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name", VARIANTS)
def test_converted_variant_matches_jax(name):
    """Strict load into the training graph and the folded graph; eval logits
    of both against the JAX model on the JAX converter's tree."""
    sd = reference_layout(name)
    cfg = J_CONFIGS[name]
    params, stats = j_egm_unet_from_torch(sd, **cfg)
    x = _images()
    jm = j_create_model(name, base_c=BASE_C)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False)["out"])(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))

    # the port's flax-shaped tree is the JAX converter's, leaf for leaf
    p2, s2 = egm_unet_from_torch(sd, **cfg)
    flat = lambda t: {"/".join(str(k.key) for k in path): np.asarray(leaf)
                      for path, leaf in jax.tree_util.tree_leaves_with_path(t)}
    for mine, theirs in ((p2, params), (s2, stats)):
        a, b = flat(mine), flat(theirs)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    scale = float(np.abs(ref).max())
    with torch.no_grad():
        for fold_bn in (False, True):
            model = create_model(name, base_c=BASE_C, fold_bn=fold_bn)
            model.load_state_dict(egm_state_dict(sd, name, base_c=BASE_C,
                                                 fold_bn=fold_bn), strict=True)
            out = model.eval()(torch.from_numpy(x))["out"].numpy()
            assert np.abs(out - ref).max() <= 1e-5 * scale, (fold_bn, np.abs(out - ref).max())


@pytest.mark.parametrize("name", ["grfb_unet", "unet"])
def test_uncovered_variants_raise(name):
    with pytest.raises(ValueError, match="reference converter"):
        egm_state_dict(fake_reference_state_dict(base_c=BASE_C), name, base_c=BASE_C)


def _convert_egm(tmp_path, name="egm_unet"):
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
          served_reference(name).items()}
    sd["in_conv.1.num_batches_tracked"] = torch.tensor(7)  # ignored, as by JAX
    pth = tmp_path / "model_best.pth"
    torch.save({"model": sd, "optimizer": {}, "epoch": 1}, pth)
    out = tmp_path / "converted"
    with contextlib.redirect_stdout(io.StringIO()):
        convert_cli.main(["--kind", "egm", "--torch", str(pth), "--out", str(out),
                          "--model", name, "--base-c", str(BASE_C)])
    return sd, out


def test_cli_egm_serves_like_jax(tmp_path):
    """``--kind egm`` writes epoch 0 with the BatchNorm statistics;
    ``Predictor.from_checkpoint`` folds it and gives the JAX Predictor's
    masks on the same weights."""
    sd, out = _convert_egm(tmp_path)
    assert saved_epochs(str(out)) == [0]
    state = load_payload(str(out))["state"]["model"]
    assert "in_conv.ConvBNReLU_0.BatchNorm_0.mean" in state

    params, stats = j_egm_unet_from_torch({k: v.numpy() for k, v in sd.items()
                                           if v.is_floating_point()})
    # three sizes, one 64x64 bucket
    images = [synthetic_tp_sample(i, h, w)[0]
              for i, (h, w) in enumerate([(40, 52), (48, 48), (36, 60)])]
    kw = dict(base_c=BASE_C, batch_size=3, base_size=32, dtype="float32")
    ref = JPredictor({"params": params, "batch_stats": stats}, JConfig(**kw)).predict(images)
    pred = Predictor.from_checkpoint(str(out), PredictorConfig(**kw), device="cpu")
    masks = pred.predict(images)
    for img, m, r in zip(images, masks, ref):
        assert m.shape == img.shape[:2]
        np.testing.assert_array_equal(m, r)
    share = sum(int(m.sum()) for m in masks) / sum(m.size for m in masks)
    assert 0.1 < share < 0.9, share


def test_cli_egm_resumes_in_train_cli(tmp_path):
    """``cli/train.py --resume`` starts from the converted weights: at lr 0
    one more epoch leaves every parameter as converted."""
    sd, out = _convert_egm(tmp_path)
    converted = load_payload(str(out))["state"]["model"]
    save = tmp_path / "resumed"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        train_cli.main(["--device", "cpu", "--synthetic", "--base-c", str(BASE_C),
                        "--synthetic-size", "32", "--batch-size", "2",
                        "--synthetic-n", "2", "--synthetic-val-n", "1",
                        "--eval-size", "32", "--epochs", "2", "--lr", "0",
                        "--resume", str(out), "--save-dir", str(save),
                        "--results-file", str(tmp_path / "r.txt")])
    assert "resumed from epoch 0" in printed.getvalue()
    assert saved_epochs(str(save)) == [1]
    after = load_payload(str(save))["state"]["model"]
    params = {k for k, _ in create_model("egm_unet", base_c=BASE_C,
                                         fold_bn=False).named_parameters()}
    for k in params:
        torch.testing.assert_close(after[k], converted[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("stretch", [False, True])
def test_cli_clip_reads_back(tmp_path, stretch):
    """``--kind clip`` (with and without ``--stretch-long``) and the reader
    give ``load_clip_checkpoint``'s config and state, which load into the
    port's CLIP."""
    sd = {k: torch.from_numpy(v) for k, v in _clip_sd(long_clip=False).items()}
    pt = tmp_path / "clip.pt"
    torch.save(sd, pt)
    out = tmp_path / "out" / "clip_converted.pt"
    argv = ["--kind", "clip", "--torch", str(pt), "--out", str(out)]
    with contextlib.redirect_stdout(io.StringIO()):
        convert_cli.main(argv + (["--stretch-long"] if stretch else []))
    cfg, state = load_converted_clip(str(out))
    ref_cfg, ref_state = load_clip_checkpoint(str(pt), stretch_to_long=stretch)
    assert {f: getattr(cfg, f) for f in ref_cfg} == ref_cfg
    assert cfg.long_clip == stretch and cfg.context_length == (248 if stretch else 77)
    assert set(state) == set(ref_state)
    for k in state:
        torch.testing.assert_close(state[k], ref_state[k], rtol=0, atol=0, msg=k)
    CLIP(cfg).load_state_dict(state, strict=True)
