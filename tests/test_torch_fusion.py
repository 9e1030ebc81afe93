"""The fusion serving path of egm_unet_torch against egm_unet_tpu on the CPU:
confusion-matrix metrics, the alpha search, the host data pipeline, the slice
as a whole (tiny CLIPSeg + egm_unet through ``fused_masks``) and a smoke run
of both CLIs.

Tolerances: counts and host preprocessing are exact; mIoUs 1e-6 (float64
ratios of equal counts); fused masks agree on >= 99.9% of pixels (an argmax
may flip where two float32 logits tie within roundoff)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu import metrics as jmetrics
from egm_unet_tpu.cli.predict import bucket_pad as jbucket_pad
from egm_unet_tpu.data import SyntheticTPDataset as JSynth
from egm_unet_tpu.data import transforms as jtf
from egm_unet_tpu.engine import fusion as jfusion
from egm_unet_tpu.models import clipseg as jclipseg
from egm_unet_tpu.models import create_model as jcreate
from egm_unet_tpu.models.clip import model as jmodel
from egm_unet_tpu.models.fold_bn import fold_bn_variables as jfold
from egm_unet_tpu.ops import resize as jresize

from egm_unet_torch import metrics
from egm_unet_torch.cli import eval_clipseg, predict_clipseg
from egm_unet_torch.data import (IMAGENET_MEAN, IMAGENET_STD, DriveDataset,
                                 EvalTransform, SyntheticTPDataset)
from egm_unet_torch.data.transforms import TP_MEAN, TP_STD, device_normalize, normalize
from egm_unet_torch.engine import fusion
from egm_unet_torch.models import clipseg, create_model
from egm_unet_torch.models.clip.model import CLIPConfig
from egm_unet_torch.models.registry import init_weights
from egm_unet_torch.serving import bucket_batches, zero_padding
from egm_unet_torch.utils import load_flax_variables

from tests.torch_port_util import random_variables, to_torch


def _logit_batch(seed, b=2, h=12, w=10, c=2):
    rng = np.random.default_rng(seed)
    cl = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ul = rng.standard_normal((b, h, w, c)).astype(np.float32)
    labels = rng.integers(0, c, (b, h, w)).astype(np.int32)
    labels[:, :2, :3] = 255  # the ignore fill
    return cl, ul, labels


def test_confmat_matches_jax():
    rng = np.random.default_rng(0)
    target = rng.integers(0, 3, (4, 9, 7)).astype(np.int32)
    target[0, :2] = 255
    pred = rng.integers(0, 3, (4, 9, 7)).astype(np.int32)
    ref = jmetrics.confmat_update(jmetrics.confmat_init(3), jnp.asarray(target),
                                  jnp.asarray(pred))
    mat = metrics.confmat_update(metrics.confmat_init(3), torch.from_numpy(target),
                                 torch.from_numpy(pred))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(ref))
    assert int(mat.sum()) == int((target != 255).sum())
    for got, want in zip(metrics.confmat_compute(mat), jmetrics.confmat_compute(ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert metrics.confmat_str(mat) == jmetrics.confmat_str(ref)


def test_fused_confmats_and_alpha_search_match_jax():
    batches = [_logit_batch(s) for s in (1, 2, 3)]
    alphas = np.linspace(0.1, 10.0, 7).astype(np.float32)
    cl, ul, labels = batches[0]
    ref = jfusion.fused_confmats(jnp.asarray(cl), jnp.asarray(ul), jnp.asarray(labels),
                                 jnp.asarray(alphas))
    got = fusion.fused_confmats(to_torch(cl), to_torch(ul), torch.from_numpy(labels),
                                torch.from_numpy(alphas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(
        fusion.fuse_logits(to_torch(cl), to_torch(ul), 2.5).numpy(),
        np.asarray(jfusion.fuse_logits(jnp.asarray(cl), jnp.asarray(ul), 2.5)), rtol=1e-6)

    ref_a, ref_m, ref_all = jfusion.search_best_alpha(
        [tuple(map(jnp.asarray, b)) for b in batches])
    a, m, all_m = fusion.search_best_alpha(
        [(to_torch(c), to_torch(u), torch.from_numpy(l)) for c, u, l in batches])
    assert a == pytest.approx(ref_a, rel=1e-6)
    assert m == pytest.approx(ref_m, rel=1e-6)
    np.testing.assert_allclose(all_m.numpy(), np.asarray(ref_all), rtol=1e-6)
    with pytest.raises(ValueError):
        fusion.search_best_alpha([])


def test_alpha_search_recovers_the_optimal_window():
    """Fully correct only for alpha in (3.33, 4.17): the label-1 half needs
    0.3 * alpha > 1, the label-0 half 0.12 * alpha < 0.5."""
    h = 8
    labels = np.zeros((1, h, h), np.int64)
    labels[:, : h // 2] = 1
    cl = np.zeros((1, h, h, 2), np.float32)
    ul = np.zeros((1, h, h, 2), np.float32)
    cl[:, : h // 2, :, 0], ul[:, : h // 2, :, 1] = 1.0, 0.3
    cl[:, h // 2:, :, 0], ul[:, h // 2:, :, 1] = 0.5, 0.12
    a, m, _ = fusion.search_best_alpha([(to_torch(cl), to_torch(ul),
                                         torch.from_numpy(labels))])
    assert 3.33 < a < 4.17 and m == pytest.approx(1.0)


def test_alpha_file_roundtrip(tmp_path):
    path = str(tmp_path / "best_alpha.txt")
    assert fusion.load_alpha(path) == 0.5
    assert fusion.load_alpha(path, default=2.0) == 2.0
    fusion.save_alpha(1.7, path)
    assert fusion.load_alpha(path) == 1.7
    assert jfusion.load_alpha(path) == 1.7  # one file format


def test_host_data_pipeline_matches_jax(tmp_path):
    ds, jds = SyntheticTPDataset(3, h=70, w=90), JSynth(3, h=70, w=90)
    assert len(ds) == 3 and ds.names == jds.names
    for i in range(3):
        np.testing.assert_array_equal(ds[i][0], jds[i][0])
        np.testing.assert_array_equal(ds[i][1], jds[i][1])
    img, mask = ds[1]
    got_i, got_t = EvalTransform(48)(img, mask)
    ref_i, ref_t = jtf.EvalTransform(48)(img, mask)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_t, ref_t)
    assert EvalTransform(48)(img, None)[1] is None
    np.testing.assert_array_equal(IMAGENET_MEAN, jtf.IMAGENET_MEAN)
    np.testing.assert_array_equal(IMAGENET_STD, jtf.IMAGENET_STD)
    [(idxs, packed)] = bucket_batches([got_i], 1)
    assert idxs == [0] and packed.shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(packed[0], jbucket_pad(got_i))

    from PIL import Image
    root = tmp_path / "TP-Dataset"
    for sub in ("Index", "JPEGImages", "GroundTruth"):
        (root / sub).mkdir(parents=True)
    (root / "Index" / "val.txt").write_text("a01\n\na02\n")
    for name in ("a01", "a02"):
        Image.fromarray(img).save(root / "JPEGImages" / f"{name}.jpg")
        Image.fromarray(mask * 255).save(root / "GroundTruth" / f"{name}.png")
    dd = DriveDataset(str(tmp_path), None, "val.txt")
    assert dd.names == ["a01", "a02"] and len(dd) == 2
    image, target = dd[0]
    assert image.shape == img.shape and image.dtype == np.uint8
    np.testing.assert_array_equal(target, mask)
    with pytest.raises(FileNotFoundError):
        DriveDataset(str(tmp_path), None, "train.txt")


def test_run_in_chunks_pads_and_drops():
    calls = []

    def forward(x, c):
        calls.append((x.clone(), c.clone()))
        return x.sum(dim=(1, 2, 3)) + c.sum(dim=1)

    n = 13
    xs = torch.arange(n * 2 * 2 * 3, dtype=torch.float32).reshape(n, 2, 2, 3)
    cs = torch.ones((n, 4))
    out = eval_clipseg.run_in_chunks(forward, (xs, cs), 4)
    # ceil(13 / 4) fixed-size chunks, the last one's three padding rows zero
    assert [tuple(x.shape) for x, _ in calls] == [(4, 2, 2, 3)] * 4
    last_x, last_c = calls[-1]
    assert torch.equal(last_x[:1], xs[12:]) and not last_x[1:].any() and not last_c[1:].any()
    np.testing.assert_allclose(out.numpy(), xs.sum(dim=(1, 2, 3)).numpy() + 4.0)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)).numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("stats", ["tp", "imagenet"])
def test_device_normalize_matches_host_bit_for_bit(stats, dtype):
    """All 256 byte values in every channel, through ``bucket_batches`` on
    uint8 frames, ``device_normalize`` and ``zero_padding``, against the
    host's ``normalize`` and the float32 ``bucket_batches``: the same bits,
    the padding and the free slot +0.0, in float32 and after the cast to
    bfloat16.  (<1 s)"""
    mean, std = {"tp": (TP_MEAN, TP_STD), "imagenet": (IMAGENET_MEAN, IMAGENET_STD)}[stats]
    v = np.arange(256, dtype=np.uint8)
    frames = [np.stack([v, v[::-1], np.roll(v, 85)], -1).reshape(16, 16, 3),
              np.stack([np.resize(np.roll(v, 3), 640)] * 3, -1).reshape(8, 80, 3)]
    got = list(bucket_batches(frames, 3))
    want = list(bucket_batches([normalize(f, mean, std) for f in frames], 3))
    assert [i for i, _ in got] == [i for i, _ in want] == [[0], [1]]
    for (idxs, u8), (_, f32) in zip(got, want):
        assert u8.dtype == np.uint8 and f32.dtype == np.float32
        x = device_normalize(torch.from_numpy(u8), mean, std, dtype)
        x = zero_padding(x, [frames[i].shape[:2] for i in idxs])
        assert x.dtype == dtype and x.shape == f32.shape
        np.testing.assert_array_equal(_bits(x), _bits(torch.from_numpy(f32).to(dtype)))
        assert not _bits(x)[1:].any()  # free slots hold +0.0
    full = device_normalize(torch.from_numpy(frames[0]), mean, std)
    np.testing.assert_array_equal(_bits(full), normalize(frames[0], mean, std).view(np.int32))


def test_run_branches_uint8_wire_matches_float_wire():
    """``run_branches`` on ``resize_frames``'s uint8 frames against the
    float32 wire (host ``preprocess``, ``np.repeat`` of the CLIP inputs,
    tiled prompt rows, float32 ``bucket_batches``) on the same models: the
    same logits, bit for bit.  Three frames of two shapes at base size 48
    (buckets 64x128 and 128x64, the second part-filled at UNet batch 2),
    clip size 64, 6 CLIPSeg rows in chunks of 4 (a short last chunk).
    (~2 s)"""
    unet = create_model("egm_unet", num_classes=2, base_c=8,
                        generator=torch.Generator().manual_seed(0)).eval()
    seg = clipseg.CLIPDensePredT(clip_cfg=CLIPConfig(**KW), reduce_dim=16,
                                 extract_layers=(1,))
    init_weights(seg, torch.Generator().manual_seed(1))
    seg.eval()
    cond = torch.randn(2, 32, generator=torch.Generator().manual_seed(2))
    raws = [SyntheticTPDataset(3, h=60, w=90)[i][0] for i in range(2)]
    raws.append(SyntheticTPDataset(3, h=90, w=60)[2][0])
    base_size, clip_size, clip_batch, unet_batch = 48, 64, 4, 2

    u565s, u352s = eval_clipseg.resize_frames(raws, base_size, clip_size)
    assert all(im.dtype == np.uint8 for im in u565s + u352s)
    info = {}
    cl, ul = eval_clipseg.run_branches(seg, unet, cond, u565s, u352s, clip_batch=clip_batch,
                                       unet_batch=unet_batch, device="cpu", info=info)
    assert info == {"clipseg_forwards": 2, "unet_forwards": 2, "logits_finite": True}

    f565s, f352s = eval_clipseg.preprocess(raws, base_size, clip_size)
    rep = np.repeat(np.stack(f352s), 2, axis=0)
    conds = np.tile(cond.numpy(), (3, 1))
    pad = lambda a: np.concatenate([a, np.zeros((clip_batch - len(a),) + a.shape[1:],  # noqa: E731
                                                a.dtype)])
    with torch.no_grad():
        ref_cl = torch.cat([seg(torch.from_numpy(pad(rep[s:s + clip_batch])),
                                torch.from_numpy(pad(conds[s:s + clip_batch])))[0]
                            for s in range(0, 6, clip_batch)])[:6]
        ref_ul = [None] * 3
        batches = list(bucket_batches(f565s, unet_batch))
        assert [idxs for idxs, _ in batches] == [[0, 1], [2]]
        for idxs, batch in batches:
            out = unet(torch.from_numpy(batch))["out"]
            for row, i in enumerate(idxs):
                h, w = f565s[i].shape[:2]
                ref_ul[i] = out[row, :h, :w]
    ref_cl = ref_cl[..., 0].reshape(3, 2, clip_size, clip_size).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(_bits(cl.contiguous()), _bits(ref_cl.contiguous()))
    for got, want in zip(ul, ref_ul):
        np.testing.assert_array_equal(_bits(got.contiguous()), _bits(want.contiguous()))


KW = dict(embed_dim=32, image_resolution=64, vision_layers=2, vision_width=64,
          vision_patch_size=16, context_length=32, vocab_size=512,
          transformer_width=64, transformer_heads=2, transformer_layers=2,
          long_clip=True)


def test_slice_as_a_whole_matches_jax():
    """Tiny CLIPSeg + egm_unet base_c 8 on 4 synthetic images, clip size 64,
    base size 96: the port's ``fused_masks`` against the same pipeline
    written with the JAX package's functions."""
    clip_size, base_size, alpha = 64, 96, 0.5
    ds = SyntheticTPDataset(4, h=120, w=150)
    raws = [ds[i][0] for i in range(4)]
    cond = np.random.default_rng(1).standard_normal((2, 32)).astype(np.float32)

    junet = jcreate("egm_unet", base_c=8)
    uv = random_variables(junet, jnp.zeros((1, 64, 64, 3)), train=True, seed=2)
    jfolded = jcreate("egm_unet", base_c=8, fold_bn=True)
    jseg = jclipseg.CLIPDensePredT(clip_cfg=jmodel.CLIPConfig(**KW), reduce_dim=16,
                                   extract_layers=(1,), attn_impl="xla")
    sv = random_variables(jseg, jnp.zeros((1, clip_size, clip_size, 3)),
                          jnp.zeros((1, 32), jnp.int32), seed=3)

    # --- the JAX package's pipeline (cli/predict_clipseg.py)
    from PIL import Image
    tf = jtf.EvalTransform(base_size)
    img565s = [tf(r, None)[0] for r in raws]
    img352s = [jtf.normalize(np.asarray(Image.fromarray(r).resize(
        (clip_size, clip_size), Image.BILINEAR)), jtf.IMAGENET_MEAN, jtf.IMAGENET_STD)
        for r in raws]
    rep = np.repeat(np.stack(img352s), 2, axis=0)
    (cl_flat,) = jax.jit(jseg.apply)(sv, jnp.asarray(rep), jnp.asarray(np.tile(cond, (4, 1))))
    cl_all = np.asarray(cl_flat)[..., 0].reshape(4, 2, clip_size, clip_size).transpose(
        0, 2, 3, 1)
    batch = np.stack([jbucket_pad(im) for im in img565s])
    [(idxs, packed)] = bucket_batches(img565s, 4)  # what fused_masks uploads
    assert idxs == [0, 1, 2, 3]
    np.testing.assert_array_equal(packed, batch)
    ul_all = np.asarray(jax.jit(jfolded.apply)(jfold(uv), jnp.asarray(batch))["out"])
    ref = []
    for i, raw in enumerate(raws):
        rh, rw = img565s[i].shape[:2]
        cl = jresize.resize_bilinear(jnp.asarray(cl_all[i])[None], (rh, rw))
        pred = jnp.argmax(jfusion.fuse_logits(cl, jnp.asarray(ul_all[i, :rh, :rw])[None],
                                              alpha), axis=-1).astype(jnp.float32)
        pred = jresize.resize_nearest(pred[..., None], raw.shape[:2], mode="pil")[0, ..., 0]
        ref.append((np.asarray(pred) * 255).astype(np.uint8))

    # --- the port
    unet = load_flax_variables(create_model("egm_unet", base_c=8), uv).eval()
    seg = load_flax_variables(clipseg.CLIPDensePredT(
        clip_cfg=CLIPConfig(**KW), reduce_dim=16, extract_layers=(1,)), sv).eval()
    info = {}
    masks = eval_clipseg.fused_masks(seg, unet, to_torch(cond), raws, alpha,
                                     base_size=base_size, clip_size=clip_size,
                                     clip_batch=8, unet_batch=4, device="cpu", info=info)
    assert info == {"clipseg_forwards": 1, "unet_forwards": 1, "logits_finite": True}
    agree = []
    for got, want, raw in zip(masks, ref, raws):
        assert got.shape == raw.shape[:2] and got.dtype == np.uint8
        assert set(np.unique(got)) <= {0, 255}
        agree.append((got == want).mean())
    assert min(agree) >= 0.999, agree
    assert 0 < np.mean([m.mean() for m in masks]) < 255  # both classes occur


def test_cli_smoke_eval_then_predict(tmp_path):
    from PIL import Image

    alpha_file = str(tmp_path / "best_alpha.txt")
    common = ["--synthetic", "--tiny-clip", "--device", "cpu", "--base-c", "8",
              "--clip-size", "64", "--base-size", "96", "--clip-batch", "8",
              "--unet-batch", "4", "--alpha-file", alpha_file]
    eval_clipseg.main(common + ["--save-result", str(tmp_path / "eval")])
    alpha = float(open(alpha_file).read())
    assert 0.1 <= alpha <= 10.0  # the reference's grid
    assert len(os.listdir(tmp_path / "eval")) == 8
    predict_clipseg.main(common + ["--model", "unet", "--save-result",
                                   str(tmp_path / "fusion")])
    names = sorted(os.listdir(tmp_path / "fusion"))
    assert names == [f"synth{i:04d}.png" for i in range(4)]
    for name in names:
        arr = np.asarray(Image.open(tmp_path / "fusion" / name))
        assert arr.shape == (565, 752) and set(np.unique(arr)) <= {0, 255}


def test_cli_defaults_and_device():
    e, p = eval_clipseg.parse_args([]), predict_clipseg.parse_args([])
    for args in (e, p):
        assert (args.model, args.base_c, args.clip_size, args.base_size,
                args.clip_batch, args.unet_batch, args.device) == (
            "grfb_unet", 32, 352, 565, 32, 16, "cuda")
    assert e.prompts == ["background", "Tactile paving"] and e.txt_name == "val.txt"
    assert p.prompts == predict_clipseg.DEFAULT_PROMPTS and p.txt_name == "predict.txt"
    from egm_unet_tpu.cli import predict_clipseg as jpredict
    assert predict_clipseg.DEFAULT_PROMPTS == jpredict.DEFAULT_PROMPTS
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            predict_clipseg.main(["--synthetic", "--tiny-clip"])
