"""``cli/train.py --device cpu --mesh-data 1 --mesh-spatial 2``: one
synthetic epoch on a 1 x 2 grid of gloo ranks spawned by
``parallel.launch``, each rank training on its rows of every image, against
``--mesh-spatial 1`` on the same draws (``--device-aug``): the epoch loss
within 1e-5 relative, one results block and one checkpoint (rank 0's), the
eval on whole images.  One spawn of 2 ranks (about 10 s)."""

import numpy as np
import pytest

from egm_unet_torch.cli import train as train_cli
from egm_unet_torch.utils.checkpoint import load_payload, saved_epochs

ARGS = ["--device", "cpu", "--synthetic", "--device-aug", "--base-c", "8",
        "--synthetic-size", "64", "--batch-size", "2", "--synthetic-n", "4",
        "--synthetic-val-n", "2", "--eval-size", "64", "--epochs", "1",
        "--print-freq", "1", "--mesh-data", "1"]


def _train(tmp_path, spatial: str):
    out = tmp_path / f"sp{spatial}"
    run = train_cli.main(ARGS + ["--mesh-spatial", spatial, "--save-dir", str(out / "save"),
                                 "--results-file", str(out / "results.txt")])
    return run, out


def test_train_cli_mesh_spatial_matches_one_process(tmp_path, capsys):
    one, _ = _train(tmp_path, "1")
    two, out = _train(tmp_path, "2")
    assert two["epoch_losses"][0] == pytest.approx(one["epoch_losses"][0], rel=1e-5)
    assert np.isfinite(two["best_dice"])
    text = (out / "results.txt").read_text()
    assert text.count("[epoch: 0]") == 1
    assert saved_epochs(str(out / "save")) == [0]
    assert load_payload(str(out / "save"))["state"]["step"] == 2  # 4 images / 2
    assert "dice coefficient:" in capsys.readouterr().out
