"""egm_unet_torch's text-branch training CLIs (``cli/train_clipseg.py``,
``cli/train_longclip.py``) at ``--tiny-clip`` on the CPU, as
``tests/test_train_clis.py`` runs the JAX CLIs: the loss falls, checkpoints
are written, a GPU is required unless ``--device cpu`` is given, and
``--mesh-data 2`` is refused without two GPUs; the CLIPSeg CLI's prompts, tokens and data
order are the JAX CLI's on the same seed."""

import json
import os

import numpy as np
import pytest
import torch

from egm_unet_tpu.models.clipseg import get_prompt_list as jget_prompt_list
from egm_unet_tpu.models.clipseg import sample_prompts as jsample_prompts

from egm_unet_torch.cli import train_clipseg, train_longclip
from egm_unet_torch.models.clipseg import get_prompt_list, sample_prompts
from egm_unet_torch.utils.checkpoint import load_payload, saved_epochs

from tests.torch_train_util import one_thread


@pytest.fixture(autouse=True)
def _grad_on():
    with one_thread():
        yield


def _losses(out: str):
    return [float(ln.split("loss ")[1].split()[0]) for ln in out.splitlines() if "loss " in ln]


def test_train_clipseg_cli(tmp_path, capsys):
    save = str(tmp_path / "ckpt")
    run = train_clipseg.main(["--synthetic", "--tiny-clip", "--image-size", "64",
                              "--batch-size", "4", "--epochs", "2", "--steps", "20",
                              "--save-dir", save, "--device", "cpu", "--print-freq", "1"])
    out = capsys.readouterr().out
    losses = _losses(out)
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert np.allclose(run["losses"], losses, atol=5e-5)
    assert out.count("fgIoU") == 2 and len(run["fgiou"]) == 2
    assert "meta.json" in os.listdir(save) and saved_epochs(save) == [0, 1]
    meta = json.load(open(os.path.join(save, "meta.json")))
    assert meta["args"]["tiny_clip"] and meta["args"]["batch_size"] == 4
    payload = load_payload(save)
    assert payload["epoch"] == 1 and payload["state"]["step"] == 4


def test_train_longclip_cli(tmp_path, capsys):
    save = str(tmp_path / "ckpt")
    run = train_longclip.main(["--synthetic", "--tiny-clip", "--batch-size", "16",
                               "--steps", "12", "--warmup-steps", "2", "--lr", "1e-3",
                               "--print-freq", "4", "--save-every", "12",
                               "--save-dir", save, "--device", "cpu"])
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert len(run["losses"]) == 12 and saved_epochs(save) == [11]
    model = run["state"].model
    assert float(model.logit_scale) <= np.log(100.0)
    assert not model.positional_embedding.requires_grad


def test_train_longclip_fixed_pool_learns(tmp_path):
    run = train_longclip.main(["--synthetic", "--synthetic-fixed", "16", "--tiny-clip",
                               "--batch-size", "8", "--steps", "8", "--warmup-steps", "1",
                               "--lr", "1e-3", "--print-freq", "100",
                               "--save-dir", str(tmp_path / "s"), "--device", "cpu"])
    first, last = np.mean(run["losses"][:2]), np.mean(run["losses"][-2:])
    assert last < first


def test_mesh_data_refused():
    """Two ranks on GPUs need two GPUs (``--device cpu --mesh-data 2`` runs
    gloo ranks: tests/test_torch_dp_cli.py)."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two GPUs are present; the refusal needs a machine with fewer")
    with pytest.raises(SystemExit, match="GPU"):
        train_longclip.main(["--synthetic", "--tiny-clip", "--mesh-data", "2"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
@pytest.mark.parametrize("cli", [train_clipseg, train_longclip])
def test_cli_needs_a_gpu_unless_told_cpu(cli, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--synthetic", "--tiny-clip", "--save-dir", str(tmp_path)])


def test_prompts_and_fallback_tokens_are_the_jax_clis():
    """The data order, the prompt draws and the hashed-word tokens (no BPE
    merges here) of one seed, as the JAX CLI draws them."""
    words = ["red square", "blue triangle", "green stripe", "yellow box"] * 3
    for mode in ("plain", "fixed", "shuffle", "shuffle+"):
        assert get_prompt_list(mode) == jget_prompt_list(mode)
        a, b = np.random.default_rng(0), np.random.default_rng(0)
        assert list(a.permutation(12)) == list(b.permutation(12))
        got = sample_prompts(words, get_prompt_list(mode), a)
        assert got == jsample_prompts(words, jget_prompt_list(mode), b)
    toks = train_clipseg.hashed_tokens(["a photo of a red square.", "box"], 8, 512)
    assert toks.dtype == np.int32 and toks.shape == (2, 8)
    assert toks[0, 6] == 511 and toks[1, 1] == 511 and toks[1, 0] == hash("box") % 510 + 1
