"""The training CLIs with ``--mesh-data 2 --device cpu``: two gloo ranks
spawned by ``parallel.launch`` on the CPU.

``cli/train.py`` for one tiny epoch with ``--device-aug`` (draws from the
seed, so that the one-process run takes the same crops): one results file
and one checkpoint, written by rank 0, and the epoch loss of ``--mesh-data
1`` within 1e-5 relative.  ``cli/train_longclip.py`` for three steps: the
first step's loss within 1e-5 relative of one process's (with 4 rows a rank
the PCA-32 proxy keeps every direction, so the two agree), every loss
finite, one checkpoint.  The refusals: ``--device-cache`` with a mesh, a
crop too small for ``--mesh-spatial``'s ranks (32 px leaves 2 rows at the
fifth stage, fewer than 4 ranks), more ranks than GPUs, a batch the ranks
cannot split.
Two spawns of 2 ranks (about 20 s)."""

import os

import numpy as np
import pytest
import torch

from egm_unet_torch.cli import train as train_cli
from egm_unet_torch.cli import train_longclip
from egm_unet_torch.utils.checkpoint import load_payload, saved_epochs

ARGS = ["--device", "cpu", "--synthetic", "--device-aug", "--base-c", "8",
        "--synthetic-size", "32", "--batch-size", "4", "--synthetic-n", "8",
        "--synthetic-val-n", "2", "--eval-size", "48", "--epochs", "1",
        "--print-freq", "1"]


def _train(tmp_path, mesh: str):
    out = tmp_path / f"mesh{mesh}"
    run = train_cli.main(ARGS + ["--mesh-data", mesh, "--save-dir", str(out / "save"),
                                 "--results-file", str(out / "results.txt")])
    return run, out


def test_train_cli_two_ranks_match_one(tmp_path, capsys):
    one, _ = _train(tmp_path, "1")
    two, out = _train(tmp_path, "2")
    assert two["epoch_losses"][0] == pytest.approx(one["epoch_losses"][0], rel=1e-5)
    assert np.isfinite(two["best_dice"])
    # rank 0 alone writes the results block and the checkpoint
    text = (out / "results.txt").read_text()
    assert text.count("[epoch: 0]") == 1
    assert saved_epochs(str(out / "save")) == [0]
    assert load_payload(str(out / "save"))["state"]["step"] == 2  # 8 images / 4


@pytest.mark.parametrize("flags,message", [
    (["--mesh-data", "2", "--device-cache"], "single-device"),
    (["--mesh-spatial", "4"], "stage 4"),
    (["--mesh-data", "3"], "divisible"),
    (["--mesh-data", "2", "--grad-accum", "4"], "divisible"),
])
def test_train_cli_refusals(flags, message):
    with pytest.raises(SystemExit) as exc:
        train_cli.main(ARGS + flags)
    assert exc.value.code != 0 and message in str(exc.value.code)


def test_train_cli_needs_the_gpus_it_names():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are present; the refusal needs a machine with fewer")
    args = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="GPU"):
        train_cli.main(args + ["--mesh-data", "2"])


def test_train_longclip_cli_two_ranks(tmp_path):
    base = ["--synthetic", "--tiny-clip", "--batch-size", "8", "--steps", "3",
            "--warmup-steps", "1", "--lr", "1e-4", "--print-freq", "1",
            "--save-every", "3", "--device", "cpu"]
    one = train_longclip.main(base + ["--save-dir", str(tmp_path / "one")])
    two = train_longclip.main(base + ["--mesh-data", "2", "--save-dir",
                                      str(tmp_path / "two")])
    assert len(two["losses"]) == 3 and all(np.isfinite(two["losses"]))
    assert two["losses"][0] == pytest.approx(one["losses"][0], rel=1e-5)
    assert saved_epochs(str(tmp_path / "two")) == [2]
    assert float(two["state"]["logit_scale"]) <= np.log(100.0)
    assert os.path.isdir(two["save_dir"])
