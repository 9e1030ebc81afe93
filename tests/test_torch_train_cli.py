"""``cli/train.py`` end to end on the CPU at a tiny size (``--device cpu
--synthetic --base-c 8 --synthetic-size 64 --epochs 2``, batch 2, eval at
96 px): the per-epoch printout and results-txt blocks in the JAX package's
format, checkpoints at the reference's cadence, ``--resume`` continuing the
step count and the learning rate, and the checkpoint served folded by
``cli/predict.py --weights``, ``serving.Predictor.from_checkpoint`` and the
fusion CLIs' ``--unet-weights``; the
JAX CLI's flags whose modules are not ported exit non-zero (the device
dataset's flags only beside --steps-per-dispatch > 1), and without
``--device`` the CLI refuses a machine with no GPU."""

import argparse
import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from egm_unet_tpu.utils.logging import ResultsWriter as JResultsWriter
from egm_unet_torch.cli import eval_clipseg
from egm_unet_torch.cli import predict as predict_cli
from egm_unet_torch.cli import train as train_cli
from egm_unet_torch.engine import warmup_poly_schedule
from egm_unet_torch.models import create_model
from egm_unet_torch.models.fold_bn import fold_bn_variables
from egm_unet_torch.serving import Predictor, PredictorConfig
from egm_unet_torch.utils import flax_from_state_dict, load_flax_variables
from egm_unet_torch.utils.checkpoint import best_epoch, load_payload, saved_epochs
from torch_train_util import one_thread, train_test_env  # noqa: F401 (autouse fixture)

ARGS = ["--device", "cpu", "--synthetic", "--base-c", "8", "--synthetic-size", "64",
        "--batch-size", "2", "--eval-size", "96", "--synthetic-val-n", "2",
        "--print-freq", "2"]
STEPS_PER_EPOCH = 4  # 4 * batch synthetic images, drop_last


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    save, results = root / "save", root / "results.txt"
    with one_thread():
        printed = _run(train_cli.main, ARGS + ["--epochs", "2", "--save-dir", str(save),
                                               "--results-file", str(results)])
        resumed = _run(train_cli.main, ARGS + [
            "--epochs", "3", "--resume", str(save), "--save-dir", str(root / "save2"),
            "--results-file", str(root / "results2.txt")])
    return root, printed, resumed


BLOCK = re.compile(
    r"\[epoch: (\d+)\]\ntrain_loss: (\d+\.\d{4})\nlr: (\d+\.\d{6})\n"
    r"dice coefficient: (\d\.\d{3})\n(global correct: [\s\S]*?mean IoU: \d+\.\d)\n\n")


def test_printout_and_results_blocks_in_the_jax_format(trained, tmp_path):
    root, printed, _ = trained
    text = (root / "results.txt").read_text()
    blocks = BLOCK.findall(text)
    assert [b[0] for b in blocks] == ["0", "1"] and "".join(
        m.group(0) for m in BLOCK.finditer(text)) == text
    # the same numbers through the JAX package's writer give the same bytes
    ref = JResultsWriter(str(tmp_path / "jax.txt"))
    for epoch, loss, lr, dice, block in blocks:
        ref.write_epoch(int(epoch), float(loss), float(lr), block, float(dice))
    assert (tmp_path / "jax.txt").read_text() == text
    assert printed.count("dice coefficient: ") == 2
    assert printed.count("global correct: ") == 2
    assert "Epoch: [1] Total time:" in printed and "training time " in printed


def test_checkpoints_at_the_cadence(trained):
    root, _, _ = trained
    save = str(root / "save")
    # epoch 0 is the first best dice; epoch 1 is the last epoch
    assert saved_epochs(save) == [0, 1]
    assert best_epoch(save) in (0, 1)
    payload = load_payload(save)
    assert payload["epoch"] == 1
    assert payload["state"]["step"] == 2 * STEPS_PER_EPOCH
    assert (root / "save" / "meta.json").exists()


def test_resume_continues_the_step_count_and_lr(trained):
    root, _, resumed = trained
    assert "resumed from epoch 1" in resumed
    assert saved_epochs(str(root / "save2")) == [2]
    payload = load_payload(str(root / "save2"))
    assert payload["state"]["step"] == 3 * STEPS_PER_EPOCH
    # the first print of epoch 2 shows schedule(9) of the 3-epoch run: the
    # count went on from 8 (a restart at 0 would show the warm-up's rate)
    sched = warmup_poly_schedule(0.02, STEPS_PER_EPOCH, 3)
    first = re.search(r"Epoch: \[2\] \[0\].*?lr: (\d+\.\d{4})", resumed).group(1)
    assert first == f"{sched(2 * STEPS_PER_EPOCH + 1):.4f}"
    assert [b[0] for b in BLOCK.findall((root / "results2.txt").read_text())] == ["2"]


def test_predict_cli_serves_the_folded_checkpoint(trained, tmp_path):
    root, _, _ = trained
    save = str(root / "save")
    printed = _run(predict_cli.main, [
        "--synthetic", "--device", "cpu", "--base-c", "8", "--base-size", "64",
        "--weights", save, "--save-result", str(tmp_path / "pred")])
    assert f"loaded weights from {save}" in printed and "FPS: " in printed
    assert sorted(os.listdir(tmp_path / "pred")) == [f"{i:04d}.png" for i in range(4)]

    # the folded graph of the best epoch equals the training graph in eval mode
    epoch = best_epoch(save)
    train_graph = create_model("egm_unet", base_c=8, fold_bn=False)
    train_graph.load_state_dict(load_payload(save, epoch)["state"]["model"])
    folded = load_flax_variables(create_model("egm_unet", base_c=8),
                                 fold_bn_variables(flax_from_state_dict(train_graph)))
    pred = Predictor.from_checkpoint(save, PredictorConfig(base_c=8, batch_size=2,
                                                           base_size=64, dtype="float32"),
                                     device="cpu")
    for a, b in zip(pred.model.state_dict().values(), folded.state_dict().values()):
        assert torch.equal(a, b)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64, 64, 3))
                         .astype(np.float32))
    with torch.no_grad():
        ref = train_graph.eval()(x)["out"]
        got = pred.model(x)["out"]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_fusion_unet_reads_the_trainer_directory(trained):
    """``--unet-weights`` of the fusion CLIs on a trainer directory loads
    the state that ``Predictor.from_checkpoint`` folds from it."""
    root, _, _ = trained
    save = str(root / "save")
    args = argparse.Namespace(model="egm_unet", base_c=8, unet_weights=save)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        unet = eval_clipseg.build_unet(args, torch.device("cpu"))
    assert f"loaded UNet weights from {save}" in out.getvalue()
    pred = Predictor.from_checkpoint(save, PredictorConfig(base_c=8, dtype="float32"),
                                     device="cpu")
    want = pred.model.state_dict()
    got = unet.state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("flag,item", [(["--device-aug"], "item 6"),
                                       (["--device-cache"], "item 6"),
                                       (["--mesh-data", "2", "--device-cache"],
                                        "single-device"),
                                       (["--mesh-spatial", "2", "--device-cache"],
                                        "single-device")])
def test_unported_flags_exit_non_zero(flag, item):
    """--mesh-data (item 9, ported: tests/test_torch_dp_cli.py) and
    --mesh-spatial (item 11, ported: tests/test_torch_sp_cli.py) exit beside
    --device-cache, which is single-device.  The GPU-resident dataset's
    flags (item 6) are ported: accepted, and refused only beside
    --steps-per-dispatch > 1."""
    if item == "item 6":
        train_cli.refuse_unported(train_cli.parse_args(ARGS + flag))
        with pytest.raises(SystemExit) as exc:
            train_cli.main(ARGS + flag + ["--steps-per-dispatch", "2"])
        assert exc.value.code != 0 and "--steps-per-dispatch" in str(exc.value.code)
        return
    with pytest.raises(SystemExit) as exc:
        train_cli.main(ARGS + flag)
    assert exc.value.code != 0 and item in str(exc.value.code)


def test_default_device_is_cuda_and_never_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--synthetic", "--epochs", "1"])
