"""egm_unet_torch's text-branch data and configs (``data/phrasecut.py``,
``data/blend.py``, ``data/fewshot_splits.py``, ``data/fewshot.py``,
``config.py``) against egm_unet_tpu on the CPU.

Tolerances: PhraseCut samples from one seed, masks and phrases equal and
images within 1e-5 (the port's resize against the JAX resize, both float32
matrix products); polygons, crops, folds, phrase filters, few-shot episodes
and the YAML loader exact; the blend modes equal, and within 1e-5 where
they resize."""

import textwrap

import jax
import numpy as np
import pytest
import torch

from egm_unet_tpu import config as jconfig
from egm_unet_tpu.data import blend as jblend
from egm_unet_tpu.data import fewshot as jfewshot
from egm_unet_tpu.data import fewshot_splits as jsplits
from egm_unet_tpu.data import phrasecut as jphrasecut

from egm_unet_torch import config
from egm_unet_torch.data import blend, fewshot, fewshot_splits, phrasecut

IMG_TOL = dict(rtol=1e-5, atol=1e-5)


def test_polygon2mask_and_find_crop_match_jax():
    polys = [[(2.5, 3.0), (10.2, 4.1), (12.0, 15.5), (3.3, 11.0)],
             [(0, 0), (19, 0), (19, 19)], [(5, 5), (6, 6)]]
    for poly in polys:
        np.testing.assert_array_equal(phrasecut.polygon2mask((20, 22), poly),
                                      jphrasecut.polygon2mask((20, 22), poly))
    seg = np.zeros((40, 50), bool)
    seg[10:20, 30:45] = True
    for kw in (dict(min_frac=0.05), dict(min_frac=0.05, best_of=3), dict(min_frac=0.9)):
        a = phrasecut.find_crop(seg, (16, 16), np.random.default_rng(4), iterations=30, **kw)
        b = jphrasecut.find_crop(seg, (16, 16), np.random.default_rng(4), iterations=30, **kw)
        assert a == b
    a = phrasecut.random_crop_slices((30, 40), (10, 12), np.random.default_rng(1))
    assert a == jphrasecut.random_crop_slices((30, 40), (10, 12), np.random.default_rng(1))


@pytest.mark.parametrize("negative_prob,aug_crop", [(0.0, True), (0.5, True), (0.0, False)])
def test_phrasecut_samples_match_jax(tmp_path, negative_prob, aug_crop):
    root = jphrasecut.make_synthetic_phrasecut(str(tmp_path / "jax"), n=6, hw=(48, 64), seed=3)
    mine = phrasecut.make_synthetic_phrasecut(str(tmp_path / "port"), n=6, hw=(48, 64), seed=3)
    for name in ("refer_train.json", "refer_val.json", "images/0.jpg", "images/5.jpg"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    kw = dict(image_size=40, negative_prob=negative_prob, aug_crop=aug_crop, seed=7)
    jds = jphrasecut.PhraseCutDataset(root, "train", **kw)
    ds = phrasecut.PhraseCutDataset(mine, "train", **kw)
    assert len(ds) == len(jds) == 6 and ds.all_phrases == jds.all_phrases
    for i in (0, 3, 1, 5, 0):  # one rng stream: the order of draws matters
        (ri, rs, rp), (pi, ps, pp) = jds[i], ds[i]
        assert pp == rp and pi.dtype == np.float32 and pi.shape == (40, 40, 3)
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_allclose(pi, ri, **IMG_TOL)
    assert len(phrasecut.PhraseCutDataset(mine, "val", image_size=40)) == 3


BLEND_MODES = ["overlay", "highlight", "highlight2", "blur_highlight", "blur3_highlight",
               "blur3_highlight01", "blur_highlight_random", "crop", "crop_blur_highlight",
               "crop_blur_highlight352", "shape", "concat", "image_only", "image_black",
               "separate", "separate_img_black", "separate_seg_ones",
               "separate_both_black"]


@pytest.mark.parametrize("mode", BLEND_MODES)
def test_blend_modes_match_jax(mode):
    rng = np.random.default_rng(5)
    img = rng.random((24, 28, 3)).astype(np.float32)
    seg = np.zeros((24, 28), np.float32)
    seg[6:15, 9:20] = 1
    got = blend.blend_image_segmentation(img, seg, mode, image_size=16,
                                         rng=np.random.default_rng(9))
    ref = jblend.blend_image_segmentation(img, seg, mode, image_size=16,
                                          rng=np.random.default_rng(9))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == np.shape(r) and g.dtype == np.asarray(r).dtype
        np.testing.assert_allclose(g, r, **IMG_TOL)
    with pytest.raises(ValueError):
        blend.blend_image_segmentation(img, seg, "nope")


def test_fewshot_splits_match_jax():
    for fold in range(4):
        assert fewshot_splits.pascal_5i_fold(fold) == jsplits.pascal_5i_fold(fold)
        assert fewshot_splits.coco_20i_fold(fold) == jsplits.coco_20i_fold(fold)
    for n in (2, 4, 6, 8, 10):
        assert fewshot_splits.pascal_zeroshot_unseen(n) == jsplits.pascal_zeroshot_unseen(n)
    phrases = ["a red car", "the big dog", "green plant on table", "empty street",
               "a TV monitor", "man riding a bike"]
    held = ["car", "dog", "tvmonitor"]
    for remove in (True, False):
        assert (fewshot_splits.filter_phrases_for_split(phrases, held, remove)
                == jsplits.filter_phrases_for_split(phrases, held, remove))
    assert fewshot_splits.CLASS_SYNONYMS == jsplits.CLASS_SYNONYMS


@pytest.mark.parametrize("mask,class_ids,negative_prob",
                         [("separate", None, 0.0), ("text_label", None, 0.0),
                          ("text_and_separate", [0, 2], 0.5), ("highlight", None, 1.0)])
def test_fewshot_episodes_match_jax(tmp_path, mask, class_ids, negative_prob):
    ann = jfewshot.make_synthetic_coco(str(tmp_path / "jax"), n_images=9, n_classes=3, seed=2)
    mine = fewshot.make_synthetic_coco(str(tmp_path / "port"), n_images=9, n_classes=3, seed=2)
    assert open(ann).read() == open(mine).read()
    kw = dict(image_size=32, mask=mask, class_ids=class_ids, negative_prob=negative_prob,
              seed=4)
    jds = jfewshot.FewShotSegDataset(ann, str(tmp_path / "jax" / "images"), **kw)
    ds = fewshot.FewShotSegDataset(mine, str(tmp_path / "port" / "images"), **kw)
    assert ds.samples == jds.samples and len(ds) == (9 if class_ids is None else 6)
    for i in range(len(ds)):
        (got, (gq, gc)), (ref, (rq, rc)) = ds[i], jds[i]
        assert gc == rc and len(got) == len(ref)
        np.testing.assert_array_equal(gq, rq)
        for g, r in zip(got, ref):
            if isinstance(r, str):
                assert g == r
            else:
                np.testing.assert_allclose(g, r, **IMG_TOL)


YAML = textwrap.dedent("""
configuration:
  batch_size: 64
  lr: 0.001
  T_max: 20000
  eta_min: 0.0001
  image_size: 352
  reduce_dim: 64
  extract_layers: [3, 7, 9]
  prompt: shuffle+
  mask: text_and_crop_blur_highlight352
  amp: True

individual_configurations:
- {name: rd64-uni, version: 'ViT-B/16', reduce_dim: 64, with_visual: True,
   negative_prob: 0.2, mix: True, mix_text_max: 0.5}
- {name: rd64-uni-refined, version: 'ViT-B/32', reduce_dim: 16,
   negative_prob: 0.2, complex_trans_conv: True, T_max: 50000, amp: False}
""")


def test_load_experiments_matches_jax(tmp_path):
    p = tmp_path / "phrasecut.yaml"
    p.write_text(YAML)
    runs, jruns = config.load_experiments(str(p)), jconfig.load_experiments(str(p))
    assert set(runs) == set(jruns) == {"rd64-uni", "rd64-uni-refined"}
    for name in runs:
        assert (jconfig.dataclasses.asdict(jruns[name])
                == config.dataclasses.asdict(runs[name])), name
    (tmp_path / "base.yaml").write_text("configuration: {name: solo, lr: 0.5}\n")
    solo = config.load_experiments(str(tmp_path / "base.yaml"))
    assert list(solo) == ["solo"] and solo["solo"].lr == 0.5


def test_build_from_experiment(tmp_path):
    p = tmp_path / "phrasecut.yaml"
    p.write_text(YAML)
    cfg = config.load_experiments(str(p))["rd64-uni-refined"]
    model, create_state = config.build_from_experiment(cfg)
    jmodel, _ = jconfig.build_from_experiment(jconfig.load_experiments(str(p))["rd64-uni-refined"])
    assert model.reduce_dim == jmodel.reduce_dim == 16
    assert model.extract_layers == jmodel.extract_layers == (3, 7, 9)
    assert model.complex_trans_conv and model.clip_cfg.vision_patch_size == 32
    state = create_state(torch.Generator().manual_seed(0))
    assert state.lr_fn(0) == pytest.approx(1e-3) and state.lr_fn(50000) == pytest.approx(1e-4)
    assert all(not p.requires_grad for p in model.clip.parameters())
    assert model.film_mul.kernel.dtype == torch.float32  # amp: False
    assert jax.numpy.dtype(jmodel.dtype) == jax.numpy.float32
