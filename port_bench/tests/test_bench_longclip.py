"""The Long-CLIP fine-tune cell, ``longclip_l14.finetune_f32_b48``, on the
CPU: a rehearsal at a tiny size with the kernels' plain versions (the
result line, no device number filled from a CPU run), runs whose step is
broken underneath (not correct), its readers (None where the program has
nothing for them), the yardstick's FLOPs by hand, and the cell's
declaration in ``BENCHMARK.json``.  On the card (``-m card``): its control,
TF32, not correct where the sound program is.

The harness's rehearsal file keeps a table of every cell's tiny sizes
(``test_bench_rehearsal.TINY``, checked against ``BENCHMARK.json``); this
file enters the cell's there, and runs the cell's rehearsal itself."""

import json
import time

import pytest
import test_bench_rehearsal
import torch

from port_bench import core
from port_bench.control import readings

CELL = "longclip_l14.finetune_f32_b48"
TINY_CLIP = {"embed_dim": 64, "resolution": 42, "vision_layers": 2, "vision_width": 64,
             "patch": 14, "context": 24, "vocab": 512, "text_width": 64, "text_heads": 1,
             "text_layers": 2}
TINY = {"config": {"clip": TINY_CLIP},
        "traffic": {"batch": 36, "pool_batches": 2, "long_tokens": [12, 24],
                    "short_tokens": [3, 8]},
        "workload": {"check_block": 16}}
test_bench_rehearsal.TINY.setdefault(CELL, TINY)


def run(trace=False, seed=2 ** 31 + 17):
    cell = core.load_cell(CELL, TINY)
    return cell, core.run_cell(cell, seed, 1.0, trace, "cpu", time.perf_counter(),
                               log=lambda *a: None)


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_result_line(trace):
    cell, r = run(trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] % 36 == 0
    assert set(r["checks"]) == {"loss_err", "grad_err_vision", "grad_err_text", "update_err"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    dev = r["device"]
    assert dev["platform"] == "cpu" and dev["kind"] is None and dev["memory_peak_bytes"] is None
    assert all(m["value"] is None for m in r["metrics"].values())
    if trace:
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert dev["busy_s"] is None and "breakdown" not in r
    else:
        assert set(r["metrics"]) == {"batch_img_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["loss_scaled", "short_captions_detached",
                                   "one_vision_leaf_off", "optimizer_skipped"])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    from egm_unet_torch.engine import longclip_train
    from egm_unet_torch.models.clip.model import CLIP

    if fault == "loss_scaled":
        loss = longclip_train.longclip_contrastive_loss

        def broken(*a, **k):
            long, short = loss(*a, **k)
            return long * 1.001, short

        monkeypatch.setattr(longclip_train, "longclip_contrastive_loss", broken)
    elif fault == "short_captions_detached":  # their features leave the graph
        encode = CLIP.encode_text
        calls = []

        def broken(self, text, **k):
            calls.append(1)
            out = encode(self, text, **k)
            return out.detach() if len(calls) % 2 == 0 else out

        monkeypatch.setattr(CLIP, "encode_text", broken)
    elif fault == "one_vision_leaf_off":  # one leaf's gradient 1e-3 off, the rest sound
        from egm_unet_torch.engine.state import TrainState

        apply = TrainState.apply_gradients

        def broken(self):
            dict(self.model.named_parameters())["visual.resblock1.ln_1.bias"].grad.mul_(1.001)
            apply(self)

        monkeypatch.setattr(TrainState, "apply_gradients", broken)
    else:  # AdamW's update does nothing; its hooks still run, the state stays
        monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    _, r = run()
    assert r["correct"] is False
    failing = {k for k, c in r["checks"].items() if not c["value"] <= c["limit"]}
    if fault == "loss_scaled":
        assert "loss_err" in failing
    elif fault == "short_captions_detached":  # the update follows the gradients
        assert failing == {"grad_err_text", "update_err"}
    elif fault == "one_vision_leaf_off":
        assert failing == {"grad_err_vision"}
    else:
        assert failing == {"update_err"} and r["checks"]["update_err"]["value"] > 0.9


@pytest.mark.card
def test_control_fails_where_the_program_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    quiet = lambda *a: None  # noqa: E731
    smaller = {"traffic": {"pool_batches": 2}}
    sound = readings(CELL, [71, 72, 73], 2.0, None, overrides=smaller, log=quiet)
    low = readings(CELL, [71, 72, 73], 2.0, "tf32_program", overrides=smaller, log=quiet)
    assert all(r["correct"] for _, r in sound), [r["checks"] for _, r in sound]
    assert not any(r["correct"] for _, r in low), [r["checks"] for _, r in low]


TABLE = {"longclip.step": {"count": 4, "seconds": 5.0, "self_seconds": 0.01, "parent": None},
         "longclip.loss": {"count": 4, "seconds": 1.2, "self_seconds": 1.2,
                           "parent": "longclip.step"},
         "longclip.update": {"count": 4, "seconds": 0.02, "self_seconds": 0.02,
                             "parent": "longclip.step"},
         "longclip.steps": {"value": 4}, "longclip.images": {"value": 192}}


@pytest.mark.parametrize("metric,span,ms", [("longclip.loss_ms_per_step", "longclip.loss", 300.0),
                                            ("longclip.update_ms_per_step", "longclip.update",
                                             5.0)])
def test_span_readers(monkeypatch, metric, span, ms):
    from egm_unet_torch.utils import profiling

    read = core.reader(metric)
    for tab, want in ((TABLE, ms), ({}, None), ({k: v for k, v in TABLE.items() if k != span},
                                                None),
                      ({**TABLE, "longclip.steps": {"value": 0}}, None)):
        monkeypatch.setattr(profiling, "table", lambda t=tab: {k: dict(v) for k, v in t.items()})
        assert read(None) == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(profiling, "table")
    assert read(None) is None


def test_flops_of_a_triple_by_hand():
    from port_bench.roofline.longclip_flops import longclip_triple_flops

    c = TINY_CLIP
    w, s, t, tw, e = 64, 10, 24, 64, 64
    vision = (2 * (s - 1) * 14 * 14 * 3 * w + 2 * 2 * s * 12 * w * w  # patches, 2 blocks
              + 4 * s * s * w + 6 * s * s * w + 2 * w * e)  # a softmax, a CSA block
    text = 2 * (2 * t * 12 * tw * tw + 4 * t * t * tw) + 2 * tw * e
    assert longclip_triple_flops(**c) == 3 * (vision + 2 * text)
    full = json.loads((core.BENCH_DIR / "configs" / "longclip_l14.json").read_text())["clip"]
    assert longclip_triple_flops(**full) * 48 == pytest.approx(36.137e12, rel=1e-4)


def test_roofline_of_the_one_csa_call_a_step():
    from types import SimpleNamespace

    read = core.reader("csa_f32_longclip_roofline")
    cell = core.load_cell(CELL)
    trace = {"by_name": {"csa_ffma_kernel<64>": {"seconds": 1.0, "count": 10},
                         "sgemm": {"seconds": 9.0, "count": 10}}}
    got = read(SimpleNamespace(cell=cell, trace=trace, counts={"steps": 10, "batch": 48}))
    # 6 B H S^2 hd at 67 TFLOP/s: 0.291 ms a call at [48, 257, 1024], 16 heads
    assert got == pytest.approx(100 * 10 * 6 * 48 * 16 * 257 ** 2 * 64 / 67e12, rel=1e-9)
    assert read(SimpleNamespace(cell=cell, trace=None, counts={"steps": 10, "batch": 48})) is None


def test_the_cell_is_declared():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    cell = core.load_cell(CELL)
    assert cell.chips == 1 and cell.entry == "longclip_step"
    assert [m["name"] for m in cell.end_to_end] == ["batch_img_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "device.idle_share.longclip", "longclip_step.mfu", "longclip_step.launches_per_step",
        "csa_f32_longclip_roofline", "longclip.loss_ms_per_step", "longclip.update_ms_per_step"}
    assert all(m["moves"] == "batch_img_per_s" for m in cell.per_layer)
    cfg = [c for c in bench["configs"] if c["name"] == "longclip_l14"][0]
    assert cfg["reduced"] == cell.config["reduced"] == ["contrastive_batch"]
    assert set(cell.workload["reasons"]) == set(cell.workload["limits"]) | {"pca_gain"}
    assert set(cell.workload["controls"]) == {"tf32_program"}


def test_the_configuration_is_the_programs_preset():
    from egm_unet_torch.models.clip.model import LONGCLIP_L14
    from port_bench.drivers.longclip_step import clip_config

    assert clip_config(core.load_cell(CELL).config["clip"]) == LONGCLIP_L14


def test_captions_end_with_eot_at_their_lengths():
    import numpy as np

    from port_bench.drivers.longclip_step import captions
    from port_bench.traffic import generator

    ids = captions(generator.rng_for(2 ** 40 + 3, 6, 0), 2000, (96, 248), 0.2, 248, 49408)
    n = (ids > 0).sum(axis=1)
    assert ids.shape == (2000, 248) and n.min() >= 96 and n.max() == 248
    assert 0.17 < (n == 248).mean() < 0.28
    assert (ids[:, 0] == 49406).all() and (ids.argmax(axis=1) == n - 1).all()
    assert (ids[np.arange(2000), n - 1] == 49407).all()
    assert torch.from_numpy(ids).dtype == torch.int64
