"""The training data pipeline, seeds, logging and checkpoints of the port
against the JAX package's on the CPU: the same seed gives the same arrays
(exact equality) for the train transforms, the synthetic generators,
``collate_pad``, ``BatchLoader``'s order and ``SuperBatcher``; the
results-txt block is byte for byte the JAX writer's; and the CUDA kernel
wrappers refuse to run inside an autograd graph, which the training graph
never asks of them."""

import io
import json
import os
import re
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egm_unet_tpu.data import dataset as jds
from egm_unet_tpu.data import loader as jloader
from egm_unet_tpu.data import synthetic as jsyn
from egm_unet_tpu.data import transforms as jtf
from egm_unet_tpu.utils import logging as jlog
from egm_unet_tpu.utils import seeding as jseed
from egm_unet_torch.data import dataset as pds
from egm_unet_torch.data import loader as ploader
from egm_unet_torch.data import synthetic as psyn
from egm_unet_torch.data import transforms as ptf
from egm_unet_torch.engine import create_train_state, make_train_step, warmup_poly_schedule
from egm_unet_torch.models import create_model
from egm_unet_torch.ops.cuda import conv3x3, mca, resize2x, upconv
from egm_unet_torch.utils import logging as plog
from egm_unet_torch.utils import seeding as pseed
from egm_unet_torch.utils.checkpoint import CheckpointManager, best_epoch, saved_epochs
from torch_train_util import train_test_env  # noqa: F401 (autouse fixture)


def _pairs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("wire_uint8", [False, True], ids=["normalized", "uint8"])
def test_train_transform_same_crops_from_the_same_seed(wire_uint8):
    jt = jtf.TrainTransform(crop_size=48, seed=3, wire_uint8=wire_uint8)
    pt = ptf.TrainTransform(crop_size=48, seed=3, wire_uint8=wire_uint8)
    for i in range(6):
        img, mask = jsyn.synthetic_tp_sample(i, 70, 90)
        _pairs_equal(pt(img, mask), jt(img, mask))


def test_paired_helpers():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (5, 7, 3), dtype=np.uint8)
    mask = rng.integers(0, 2, (5, 7), dtype=np.uint8)
    for name in ("hflip", "vflip"):
        _pairs_equal(getattr(ptf, name)(img, mask), getattr(jtf, name)(img, mask))
    for size in (4, 9):
        np.testing.assert_array_equal(ptf.pad_if_smaller(img, size, 7),
                                      jtf.pad_if_smaller(img, size, 7))
        _pairs_equal(ptf.center_crop(img, mask, size), jtf.center_crop(img, mask, size))
        _pairs_equal(ptf.random_crop(img, mask, size, np.random.default_rng(4)),
                     jtf.random_crop(img, mask, size, np.random.default_rng(4)))
    img2, _ = jsyn.synthetic_tp_sample(2, 40, 50)
    _pairs_equal(ptf.EvalTransform(32, wire_uint8=True)(img2, mask[:1]),
                 jtf.EvalTransform(32, wire_uint8=True)(img2, mask[:1]))


def test_hard_synthetic_sample_and_datasets():
    for i in range(3):
        _pairs_equal(psyn.synthetic_tp_sample_hard(i, 60, 80, seed0=7),
                     jsyn.synthetic_tp_sample_hard(i, 60, 80, seed0=7))
    img = np.random.default_rng(1).random((6, 5, 3))
    np.testing.assert_array_equal(psyn._box_blur3(img), jsyn._box_blur3(img))
    for hard in (False, True):
        p = psyn.SyntheticTPDataset(3, h=50, w=60, cache=True, hard=hard, seed0=500_000)
        j = jsyn.SyntheticTPDataset(3, h=50, w=60, cache=True, hard=hard, seed0=500_000)
        for i in range(3):
            _pairs_equal(p[i], j[i])
            _pairs_equal(p[i], j[i])  # the cached copy
    _pairs_equal(psyn.synthetic_tp_batch(2, size=32, seed=1),
                 jsyn.synthetic_tp_batch(2, size=32, seed=1))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_collate_pad(dtype):
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 255, (h, w, 3)).astype(dtype) for h, w in ((30, 41), (33, 20))]
    targets = [rng.integers(0, 2, im.shape[:2]).astype(np.int32) for im in images]
    targets[1] = None
    _pairs_equal(pds.collate_pad(images, targets), jds.collate_pad(images, targets))


class _Indexed:
    """A dataset whose sample i is filled with i."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return np.full((2, 2, 3), i, np.float32), np.full((2, 2), i % 2, np.int32)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batch_loader_order_and_superbatcher(shuffle, drop_last):
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=5, num_workers=2)
    p, j = ploader.BatchLoader(_Indexed(), **kw), jloader.BatchLoader(_Indexed(), **kw)
    assert len(p) == len(j) == (3 if drop_last else 4)
    for _ in range(2):  # two epochs: the generator advances alike
        for a, b in zip(p, j, strict=True):
            _pairs_equal(a, b)
    if drop_last:  # equal batch shapes stack; K=2 over 3 batches leaves a group of 1
        for a, b in zip(ploader.SuperBatcher(p, 2), jloader.SuperBatcher(j, 2), strict=True):
            _pairs_equal(a, b)
        assert len(ploader.SuperBatcher(p, 2)) == 2
    p.close()


def test_loader_surfaces_a_dataset_error():
    class Broken(_Indexed):
        def __getitem__(self, i):
            raise OSError(f"sample {i} unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(ploader.BatchLoader(Broken(), 2, num_workers=1))


def test_narrow_for_transfer_and_prefetch():
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    targets = rng.integers(0, 2, (2, 4, 4)).astype(np.int32)
    targets[0, 0, 0] = 255
    ji, jt = jloader.narrow_for_transfer(images, targets, jnp.bfloat16)
    pi, pt = ploader.narrow_for_transfer(images, targets, torch.bfloat16)
    assert pi.dtype == torch.bfloat16 and pt.dtype == torch.uint8
    np.testing.assert_array_equal(pi.float().numpy(), np.asarray(ji, np.float32))
    np.testing.assert_array_equal(pt.numpy(), jt)
    pi, _ = ploader.narrow_for_transfer(images, targets, torch.float32)
    np.testing.assert_array_equal(pi.numpy(), images)
    raw = images.astype(np.uint8)
    assert ploader.narrow_for_transfer(raw, targets, torch.bfloat16)[0].dtype == torch.uint8
    batches = [(images, targets), (images + 1, targets)]
    out = list(ploader.DevicePrefetcher(
        batches, lambda b: ploader.to_device(ploader.narrow_for_transfer(*b, torch.float32),
                                             "cpu")))
    assert len(out) == 2 and torch.equal(out[1][0], torch.from_numpy(images + 1))

    def boom(batch):
        raise ValueError("prepare failed")

    with pytest.raises(ValueError, match="prepare failed"):
        list(ploader.DevicePrefetcher(batches, boom))


def test_seeds_match_in_process():
    for root, name in ((0, "loader"), (7, "augment")):
        a = pseed.Seeds(root).numpy(name).integers(0, 1 << 30, 4)
        b = jseed.Seeds(root).numpy(name).integers(0, 1 << 30, 4)
        np.testing.assert_array_equal(a, b)
    g1, g2 = pseed.Seeds(3).generator("init"), pseed.Seeds(3).generator("init")
    assert torch.equal(torch.rand(3, generator=g1), torch.rand(3, generator=g2))


def test_results_block_is_byte_identical(tmp_path):
    from egm_unet_tpu.metrics import confmat_str as j_confmat_str
    from egm_unet_torch.metrics import confmat_str as p_confmat_str

    mat = np.array([[50, 3], [4, 12]], np.int64)
    block = p_confmat_str(torch.from_numpy(mat))
    assert block == j_confmat_str(mat)
    for writer, name in ((plog.ResultsWriter, "p.txt"), (jlog.ResultsWriter, "j.txt")):
        w = writer(str(tmp_path / name))
        w.write_epoch(0, 1.23456, 0.0199999, block, 0.87654)
        w.write_epoch(1, 0.5, 0.0, block, 0.9)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_metric_logger_meters_and_printout():
    pm, jm = plog.MetricLogger(), jlog.MetricLogger()
    outs = []
    for m in (pm, jm):
        buf = io.StringIO()
        with redirect_stdout(buf):
            for i in m.log_every(range(5), 2, "Epoch: [0]"):
                m.update(loss=1.0 / (i + 1), lr=0.01 * i)
        outs.append(buf.getvalue())
    for k in ("loss", "lr"):
        for attr in ("value", "avg", "global_avg"):
            assert getattr(pm.meters[k], attr) == getattr(jm.meters[k], attr)
    strip = lambda s: re.sub(r"time: [0-9.]+s|eta: [0-9:]+", "", s)
    assert strip(outs[0]) == strip(outs[1])
    assert outs[0].count("Epoch: [0] [") == 3


def _tiny_state():
    model = create_model("unet", base_c=4, fold_bn=False,
                         generator=torch.Generator().manual_seed(0))
    return create_train_state(model, warmup_poly_schedule(0.02, 2, 5))


def test_checkpoint_cadence_and_resume(tmp_path):
    state = _tiny_state()
    step = make_train_step()
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    t = (x[..., 0] > 0).long()
    ckpt = CheckpointManager(str(tmp_path / "ck"), period=2)
    tags = {}
    for epoch, dice in enumerate([0.5, 0.4, 0.6, 0.6, 0.1]):
        state, _ = step(state, x, t)
        tags[epoch] = ckpt.maybe_save(epoch, 5, state, dice=dice, extra={"args": {"e": 5}})
    # best at 0 and 2; periodic at 1 and 3; the last epoch at 4
    assert tags == {0: ["best"], 1: ["periodic"], 2: ["best"], 3: ["periodic"],
                    4: ["periodic"]}
    assert saved_epochs(ckpt.directory) == [0, 1, 2, 3, 4] and ckpt.latest_epoch() == 4
    assert best_epoch(ckpt.directory) == 2
    assert (tmp_path / "ck" / "best_epoch.txt").read_text() == "2 0.6\n"
    assert json.loads((tmp_path / "ck" / "meta.json").read_text()) == {"args": {"e": 5}}

    fresh = _tiny_state()
    restored = CheckpointManager(str(tmp_path / "ck")).restore(fresh, epoch=2)
    assert restored["epoch"] == 2 and restored["best_dice"] == 0.6
    assert fresh.step == 3
    assert fresh.optimizer.param_groups[0]["lr"] == pytest.approx(fresh.lr_fn(3))
    latest = CheckpointManager(str(tmp_path / "ck")).restore(_tiny_state())
    assert latest["epoch"] == 4 and latest["state"].step == 5
    for a, b in zip(state.model.state_dict().values(),
                    latest["state"].model.state_dict().values()):
        assert torch.equal(a, b)
    for p_a, p_b in zip(state.model.parameters(), latest["state"].model.parameters()):
        assert torch.equal(state.optimizer.state[p_a]["momentum_buffer"],
                           latest["state"].optimizer.state[p_b]["momentum_buffer"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_tiny_state())
    assert not os.path.exists(tmp_path / "ck" / "4" / "checkpoint.pt.tmp")


def _kernel_calls():
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, x1 = t(1, 4, 4, 8), t(1, 2, 2, 8)
    return {
        "mca_fused": lambda g: mca.mca_fused(x.requires_grad_(g), t(1, 4).sigmoid(),
                                             t(1, 4).sigmoid(), t(1, 8).sigmoid()),
        "conv3x3_gemm": lambda g: conv3x3.conv3x3_gemm(x, t(3, 3, 8, 4).requires_grad_(g),
                                                       t(4)),
        "conv3x3_pair_gemm": lambda g: conv3x3.conv3x3_pair_gemm(
            x, t(3, 3, 8, 4), t(4).requires_grad_(g), t(3, 3, 4, 4), t(4)),
        "upsample2x_fused": lambda g: resize2x.upsample2x_fused(x1.requires_grad_(g)),
        "up_concat_conv": lambda g: upconv.up_concat_conv(x, x1, t(3, 3, 16, 4),
                                                          t(4).requires_grad_(g)),
    }


@pytest.mark.parametrize("kernel", sorted(_kernel_calls()))
def test_kernel_wrappers_refuse_autograd(kernel):
    """A hand-written kernel has no backward: with autograd on and an input
    that requires grad its wrapper raises (on every device, so that the CPU
    fails where the card would silently drop the gradient); without, or
    under no_grad, it runs."""
    call = _kernel_calls()[kernel]
    with pytest.raises(RuntimeError, match="forward-only kernel"):
        call(True)
    assert call(False).grad_fn is None
    with torch.no_grad():
        call(True)


def test_training_graph_calls_no_kernel_wrapper(monkeypatch):
    """Forward and backward of egm_unet's training graph, with every kernel
    wrapper (and the folded graph's call sites of them) replaced by one that
    fails."""
    from egm_unet_torch.nn import attention, layers

    def refuse(*args, **kwargs):
        raise AssertionError("the training graph called a hand-written kernel")

    for mod, names in ((layers, ("conv3x3_gemm", "conv3x3_pair_gemm", "up_concat_conv")),
                       (attention, ("mca_fused",)), (resize2x, ("upsample2x_fused",)),
                       (conv3x3, ("conv3x3_gemm", "conv3x3_pair_gemm")),
                       (upconv, ("up_concat_conv",)), (mca, ("mca_fused",))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    model = create_model("egm_unet", base_c=8, fold_bn=False, remat="fine",
                         generator=torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    model(x)["out"].square().mean().backward()
    assert all(p.grad is not None for p in model.parameters())
    with torch.no_grad():
        model.eval()(x)
    folded = create_model("egm_unet", base_c=8).eval()
    with torch.no_grad(), pytest.raises(AssertionError, match="hand-written kernel"):
        folded(x)
