"""egm_unet_torch's device-resident training set (``data/device_cache.py``)
against the JAX package's, and ``cli/train.py --device-cache`` end to end on
the CPU at a tiny size.

- ``build_cache_arrays`` equals JAX's canvases byte for byte, and reads the
  raw samples without touching the dataset's ``transforms``;
- ``epoch_iter`` yields floor(n / batch) batches, each equal (exactly: the
  same function on the same tensors) to ``augment_with_params`` on the
  gathered sources with the same draws, and no sentinel rows: this is where
  the port departs from JAX's ceil(n / batch) batches padded with image-0,
  mask-255 rows;
- the draws and the order are a pure function of (seed, epoch);
- ``--steps-per-dispatch 2`` with either device flag exits non-zero."""

import contextlib
import io

import numpy as np
import pytest
import torch

from egm_unet_tpu.data.device_cache import build_cache_arrays as jbuild_cache_arrays
from egm_unet_tpu.data.synthetic import SyntheticTPDataset as JSyntheticTPDataset
from egm_unet_torch.cli import train as train_cli
from egm_unet_torch.data.device_aug import augment_with_params, draw_params, to_unit
from egm_unet_torch.data.device_cache import (DeviceDatasetCache, RawSource,
                                              build_cache_arrays, epoch_generator,
                                              scale_range, source_size)
from egm_unet_torch.data.synthetic import SyntheticTPDataset
from egm_unet_torch.data.transforms import TP_MEAN, TP_STD
from egm_unet_torch.utils.checkpoint import load_payload
from torch_train_util import one_thread, train_test_env  # noqa: F401 (autouse fixture)

SRC, CROP = 64, 32


class Untouchable:
    """A ``transforms`` that fails if called."""

    def __call__(self, image, target):
        raise AssertionError("the build applied the dataset's transforms")


class WatchedDataset(SyntheticTPDataset):
    """Records every assignment to ``transforms`` after construction."""

    def __setattr__(self, name, value):
        if name == "transforms" and hasattr(self, "transforms"):
            self.__dict__.setdefault("assigned", []).append(value)
        super().__setattr__(name, value)


def make_cache(n=5, out_dtype=torch.float32):
    ds = SyntheticTPDataset(n=n, h=50, w=70)
    lo, hi = scale_range(SRC)
    return DeviceDatasetCache(ds, SRC, TP_MEAN, TP_STD, CROP, lo, hi,
                              out_dtype=out_dtype, device="cpu"), ds


def test_build_cache_arrays_equals_jax_and_leaves_transforms_alone():
    marker = Untouchable()
    ds = WatchedDataset(n=3, h=50, w=70, transforms=marker)
    imgs, masks = build_cache_arrays(ds, SRC)
    assert ds.transforms is marker and not ds.__dict__.get("assigned")
    jimgs, jmasks = jbuild_cache_arrays(JSyntheticTPDataset(n=3, h=50, w=70), SRC)
    assert imgs.dtype == np.uint8 and masks.dtype == np.uint8
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(masks, jmasks)
    # the canvas of the --device-aug host path is the same
    img, tgt = RawSource(SRC)(*ds.raw(1))
    np.testing.assert_array_equal(img, imgs[1])
    np.testing.assert_array_equal(tgt, masks[1])


def test_epoch_iter_drops_the_partial_batch_and_has_no_sentinel_rows():
    cache, ds = make_cache(n=5)
    assert cache.hbm_bytes == 5 * SRC * SRC * 4
    order = np.random.default_rng(3).permutation(5)
    batches = list(cache.epoch_iter(torch.Generator().manual_seed(9), 2,
                                    np.random.default_rng(3)))
    assert len(batches) == 5 // 2  # the loader's drop_last count, not ceil
    assert cache.h2d_bytes == 2 * 2 * 8  # one int64 index vector per batch
    gen = torch.Generator().manual_seed(9)
    lo, hi = scale_range(SRC)
    for b, (im, tg) in enumerate(batches):
        idx = torch.from_numpy(order[2 * b:2 * b + 2])
        params = draw_params(gen, 2, SRC, CROP, lo, hi)
        ref_i, ref_m = augment_with_params(to_unit(cache.imgs[idx]),
                                           cache.masks[idx], params, TP_MEAN,
                                           TP_STD, CROP)
        assert im.shape == (2, CROP, CROP, 3) and im.dtype == torch.float32
        assert torch.equal(im, ref_i) and torch.equal(tg, ref_m)
        assert set(tg.unique().tolist()) <= {0, 1}  # no 255 sentinel rows
        assert (im.flatten(1).abs().amax(1) > 0).all()


def test_out_dtype_and_replay_by_seed_and_epoch():
    cache, _ = make_cache(n=4, out_dtype=torch.bfloat16)
    run = lambda seed, epoch: list(cache.epoch_iter(
        epoch_generator(seed, epoch, "cpu"), 2, np.random.default_rng(seed + epoch)))
    a, b, c = run(0, 3), run(0, 3), run(0, 4)
    assert a[0][0].dtype == torch.bfloat16
    for (ia, ta), (ib, tb) in zip(a, b):
        assert torch.equal(ia, ib) and torch.equal(ta, tb)
    assert not torch.equal(a[0][0], c[0][0])


def _train(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(argv)
    return out.getvalue()


@pytest.mark.parametrize("flag", ["--device-cache", "--device-aug"])
def test_train_cli_device_flags_one_epoch(flag, tmp_path):
    """One tiny epoch (5 synthetic images, batch 2): floor(5 / 2) = 2 steps,
    the checkpoint's step count and the printed epoch as the host loader's."""
    printed = _train(["--device", "cpu", "--synthetic", "--base-c", "8",
                      "--synthetic-size", "32", "--synthetic-n", "5",
                      "--synthetic-val-n", "2", "--batch-size", "2",
                      "--eval-size", "48", "--epochs", "1", "--print-freq", "1",
                      "--save-dir", str(tmp_path / "save"), flag])
    assert ("device cache: 5 samples" in printed) == (flag == "--device-cache")
    assert printed.count("Epoch: [0] [") == 2 and "dice coefficient: " in printed
    assert load_payload(str(tmp_path / "save"))["state"]["step"] == 2
    assert source_size(32) == 64


@pytest.mark.parametrize("flag", ["--device-cache", "--device-aug"])
def test_steps_per_dispatch_refused_with_device_flags(flag):
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--device", "cpu", "--synthetic", "--steps-per-dispatch", "2",
                        flag])
    assert exc.value.code != 0 and "--steps-per-dispatch" in str(exc.value.code)
