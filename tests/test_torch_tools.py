"""egm_unet_torch's offline tools against egm_unet_tpu's on the same inputs:
the evaluator's confusion counts and formulas, its PNG round trip and CLI,
the dataset audit, the VOC palette, mask PNGs, the mean/std tool; the tools' refusal of a missing GPU (the profiling helpers are
``test_torch_tracing.py``'s)."""

import csv
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from egm_unet_tpu.cli import compute_mean_std as j_mean_std
from egm_unet_tpu.cli import dataset_audit as j_audit
from egm_unet_tpu.cli import evaluating_indicator as j_eval
from egm_unet_tpu.utils import colormap as j_colormap

from egm_unet_torch.cli import compute_mean_std, dataset_audit, evaluating_indicator
from egm_unet_torch.utils import colormap


def write_png(path, arr):
    Image.fromarray(arr.astype(np.uint8)).save(path)


def test_fast_hist_counts_equal():
    rng = np.random.default_rng(0)
    a = rng.integers(-1, 4, 5000)  # -1 and 3 fall outside [0, 3)
    b = rng.integers(0, 3, 5000)
    ref = j_eval.fast_hist(a, b, 3)
    got = evaluating_indicator.fast_hist(torch.from_numpy(a), torch.from_numpy(b), 3)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        evaluating_indicator.fast_hist(torch.tensor([0, 0, 1, 1, 255]),
                                       torch.tensor([0, 1, 1, 1, 0]), 2).numpy(),
        [[1, 1], [0, 2]])


@pytest.mark.parametrize("fn", ["per_class_iu", "per_class_pa_recall",
                                "per_class_precision", "per_accuracy"])
def test_metric_formulas_equal(fn):
    rng = np.random.default_rng(1)
    for hist in (rng.integers(0, 1000, (2, 2)), np.array([[90, 10], [5, 95]]),
                 np.array([[0, 0], [0, 7]])):
        np.testing.assert_array_equal(getattr(evaluating_indicator, fn)(hist),
                                      getattr(j_eval, fn)(hist))
    p, r = rng.random(4), rng.random(4)
    np.testing.assert_array_equal(evaluating_indicator.f_score(p, r, 0.5),
                                  j_eval.f_score(p, r, 0.5))
    assert evaluating_indicator.dice_equation(3.0, 4.0, 5.0) == j_eval.dice_equation(3.0, 4.0, 5.0)


def _mask_dirs(tmp_path):
    """Ground truth and predictions: a perfect pair, an inverted pair, a
    shape mismatch, a missing prediction and seeded 0..255 masks (the /255
    binarisation rounds them)."""
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    gt_dir.mkdir()
    pred_dir.mkdir()
    m = np.zeros((20, 20), np.uint8)
    m[5:15, 5:15] = 255
    write_png(gt_dir / "a.png", m)
    write_png(pred_dir / "a.png", m)
    write_png(gt_dir / "b.png", m)
    write_png(pred_dir / "b.png", 255 - m)
    write_png(gt_dir / "c.png", m)
    write_png(pred_dir / "c.png", np.zeros((10, 10), np.uint8))
    write_png(gt_dir / "d.png", m)
    rng = np.random.default_rng(2)
    names = ["a", "b", "c", "d"]
    for i in range(12):
        write_png(gt_dir / f"r{i}.png", rng.integers(0, 256, (17, 23)))
        write_png(pred_dir / f"r{i}.png", rng.integers(0, 256, (17, 23)))
        names.append(f"r{i}")
    return gt_dir, pred_dir, names


def test_compute_miou_png_roundtrip_equal(tmp_path, capsys):
    gt_dir, pred_dir, names = _mask_dirs(tmp_path)
    ref, ref_skipped = j_eval.compute_miou(str(gt_dir), str(pred_dir), names, 2)
    ref_out = capsys.readouterr().out
    hist, skipped = evaluating_indicator.compute_miou(str(gt_dir), str(pred_dir), names, 2,
                                                     device="cpu")
    assert hist.dtype == np.int64 and skipped == ref_skipped == 2
    np.testing.assert_array_equal(hist, ref)
    assert capsys.readouterr().out == ref_out  # the skip line and progress prints


def test_evaluating_indicator_cli(tmp_path):
    """The CLI on the CPU: the confusion CSV holds JAX's counts, the log
    tees stdout, and stdout is restored."""
    gt_dir, pred_dir, names = _mask_dirs(tmp_path)
    (tmp_path / "val.txt").write_text("\n".join(names) + "\n")
    out_dir, log = tmp_path / "logs", tmp_path / "logs" / "eval.log"
    stdout = sys.stdout
    hist = evaluating_indicator.main([
        "--gt-dir", str(gt_dir), "--pred-dir", str(pred_dir),
        "--txt-dir", str(tmp_path / "val.txt"), "--log-path", str(log),
        "--out-dir", str(out_dir), "--device", "cpu"])
    assert sys.stdout is stdout
    ref, _ = j_eval.compute_miou(str(gt_dir), str(pred_dir), names, 2)
    np.testing.assert_array_equal(hist, ref)
    with open(out_dir / "confusion_matrix.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["", "_background_", "Tactile_paving"]
    np.testing.assert_array_equal([[int(v) for v in r[1:]] for r in rows[1:]], ref)
    text = log.read_text()
    assert "mIoU:" in text and "skipped: 2" in text


@pytest.mark.parametrize("tool, argv", [
    (evaluating_indicator, ["--device", "cuda"]),
    (dataset_audit, ["somewhere", "--device", "cuda"]),
    (compute_mean_std, ["--device", "cuda"]),
])
def test_tools_refuse_a_missing_gpu(tool, argv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "dataset/TP-Dataset/Index").mkdir(parents=True)
    (tmp_path / "dataset/TP-Dataset/Index/val.txt").write_text("a\n")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main(argv)


def test_dataset_audit_equal(tmp_path):
    m = np.zeros((8, 8), np.uint8)
    m[0, 0] = 255
    write_png(tmp_path / "x.png", m)
    write_png(tmp_path / "y.png", np.full((4, 4), 7, np.uint8))
    sub = tmp_path / "sub"
    sub.mkdir()
    write_png(sub / "z.png", np.random.default_rng(3).integers(0, 256, (9, 11)))
    (sub / "broken.png").write_bytes(b"not a png")
    (sub / "notes.txt").write_text("skipped")
    ref = j_audit.analyze_pixel_values(str(tmp_path))
    got = dataset_audit.analyze_pixel_values(str(tmp_path), device="cpu")
    assert got == ref
    assert got["n_files"] == 3 and len(got["unreadable"]) == 1


def test_pascal_voc_palette_equal():
    np.testing.assert_array_equal(colormap.pascal_voc_palette(),
                                  j_colormap.pascal_voc_palette())
    np.testing.assert_array_equal(colormap.pascal_voc_palette(21),
                                  j_colormap.pascal_voc_palette(21))
    assert colormap.BINARY_COLOR_MAP == j_colormap.BINARY_COLOR_MAP


@pytest.mark.parametrize("binary", [True, False])
def test_save_mask_png_equal(tmp_path, binary):
    mask = np.random.default_rng(4).integers(0, 21 if not binary else 2, (13, 17))
    ref, mine, from_tensor = (str(tmp_path / f"{n}.png") for n in ("ref", "mine", "t"))
    j_colormap.save_mask_png(mask, ref, binary=binary)
    colormap.save_mask_png(mask, mine, binary=binary)
    colormap.save_mask_png(torch.from_numpy(mask), from_tensor, binary=binary)
    a = Image.open(ref)
    for path in (mine, from_tensor):
        b = Image.open(path)
        assert a.mode == b.mode
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert b.getpalette() == a.getpalette()


@pytest.mark.parametrize("with_masks", [False, True])
def test_compute_mean_std_close(tmp_path, with_masks):
    rng = np.random.default_rng(5)
    img_dir, mask_dir = tmp_path / "img", tmp_path / "mask"
    img_dir.mkdir()
    mask_dir.mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)).save(
            img_dir / f"i{i}.png")
        if i != 1:  # no mask for i1: the whole image counts
            write_png(mask_dir / f"i{i}.png", (rng.random((12, 16)) < 0.4) * 255)
    md = str(mask_dir) if with_masks else None
    ref = j_mean_std.compute_mean_std(str(img_dir), md)
    got = compute_mean_std.compute_mean_std(str(img_dir), md, device="cpu")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
