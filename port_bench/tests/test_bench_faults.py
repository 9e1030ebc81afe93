"""A run whose timed path is broken underneath must come out not correct:
the harness runs on the CPU at a tiny size (the look for a chip skipped)
with the program's entry patched to alter an answer where it is produced,
or to leave half of the batch out; and the float8 control."""

import time

import numpy as np
import pytest
import torch

from port_bench import core
from port_bench.tests.test_bench_rehearsal import TINY


def run(name):
    r = core.run_cell(core.load_cell(name, TINY[name]), 123, 1.0, False, "cpu",
                      time.perf_counter(), log=lambda *a: None)
    return r


def test_a_sound_run_is_correct():
    assert run("egm_unet.bucket_b32")["correct"] is True


def test_the_float8_stand_in_is_not_correct():
    """The bfloat16 cell's control: the reference in the program's place,
    its convolutions in float8."""
    over = core._merge(TINY["egm_unet.bucket_b32"], {"workload": {"stand_in": "float8_e4m3fn"}})
    r = core.run_cell(core.load_cell("egm_unet.bucket_b32", over), 123, 1.0, False, "cpu",
                      time.perf_counter(), log=lambda *a: None)
    assert r["correct"] is False
    assert r["checks"]["logit_err_ratio"]["value"] > r["checks"]["logit_err_ratio"]["limit"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out"])
def test_bucket_forward_faults(monkeypatch, fault):
    from egm_unet_torch.serving import Predictor

    forward = Predictor.forward

    def broken(self, batch):
        if fault == "answer_altered":
            out = forward(self, batch).clone()
            out[0] = 1 - out[0]
            return out
        half = batch.shape[0] // 2
        out = forward(self, batch[:half])
        return torch.cat([out, torch.zeros_like(out)])

    monkeypatch.setattr(Predictor, "forward", broken)
    assert run("egm_unet.bucket_b32")["correct"] is False


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out"])
def test_fused_folder_faults(monkeypatch, fault):
    from egm_unet_torch.cli import eval_clipseg

    fused = eval_clipseg.fused_masks

    def broken(clipseg, unet, cond, raws, alpha, **kw):
        if fault == "answer_altered":
            masks = fused(clipseg, unet, cond, raws, alpha, **kw)
            masks[0] = 255 - masks[0]
            return masks
        half = len(raws) // 2 or 1
        masks = fused(clipseg, unet, cond, raws[:half], alpha, **kw)
        return masks + [np.zeros(r.shape[:2], np.uint8) for r in raws[half:]]

    monkeypatch.setattr(eval_clipseg, "fused_masks", broken)
    assert run("clipseg_fusion.folder_f32")["correct"] is False
