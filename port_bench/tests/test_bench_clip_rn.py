"""The RN fine-tune cell, ``clip_rn50x64.finetune_f32_b48``, on the CPU: a
rehearsal at a tiny size (the result line, no device number filled from a
CPU run), runs whose step is broken underneath (each fails its own
number), the calibrated draw, its readers, the yardstick's FLOPs, and the
cell's declaration in ``BENCHMARK.json``.  On the card (``-m card``): its
control, TF32, not correct where the sound program is.

The cell's tiny sizes enter ``test_bench_rehearsal.TINY`` from here, as
``test_bench_longclip.py`` enters its own."""

import json
import time

import pytest
import test_bench_rehearsal
import torch

from port_bench import core
from port_bench.control import readings

CELL = "clip_rn50x64.finetune_f32_b48"
TINY_CLIP = {"embed_dim": 64, "resolution": 64, "vision_layers": [1, 2, 1, 1],
             "vision_width": 16, "context": 24, "vocab": 512, "text_width": 64,
             "text_heads": 1, "text_layers": 2}
TINY = {"config": {"clip": TINY_CLIP},
        "traffic": {"batch": 36, "pool_batches": 2, "long_tokens": [12, 24],
                    "short_tokens": [3, 8]},
        "workload": {"check_block": 16, "calibration_frames": 8}}
test_bench_rehearsal.TINY.setdefault(CELL, TINY)
NUMBERS = {"loss_err", "grad_err_vision", "grad_err_text", "update_err", "stats_moved"}


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
    assert set(r["checks"]) == NUMBERS
    assert r["checks"]["stats_moved"] == {"value": 0.0, "limit": 0.0}
    dev = r["device"]
    assert dev["platform"] == "cpu" and dev["kind"] is None and dev["memory_peak_bytes"] is None
    assert all(m["value"] is None for m in r["metrics"].values())
    if trace:
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "longclip.recomputed_blocks_per_step" in r["metrics"]
        assert dev["busy_s"] is None and "breakdown" not in r
    else:
        assert set(r["metrics"]) == {"batch_img_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["statistics_trained", "one_vision_leaf_off",
                                   "optimizer_skipped"])
def test_a_broken_step_fails_its_own_number(monkeypatch, fault):
    from egm_unet_torch.models.clip.resnet import InferenceBatchNorm

    if fault == "statistics_trained":  # AdamW takes the statistics, as before the fix
        monkeypatch.setattr(InferenceBatchNorm, "frozen_leaves", ())
    elif fault == "one_vision_leaf_off":  # one leaf's gradient 10% off, the rest sound
        from egm_unet_torch.engine.state import TrainState

        apply = TrainState.apply_gradients

        def broken(self):
            dict(self.model.named_parameters())["visual.layer2_1.conv2.kernel"].grad.mul_(1.1)
            apply(self)

        monkeypatch.setattr(TrainState, "apply_gradients", broken)
    else:  # AdamW's update does nothing; its hooks still run, the state stays
        monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    _, r = run()
    assert r["correct"] is False
    failing = {k for k, c in r["checks"].items() if not c["value"] <= c["limit"]}
    want = {"statistics_trained": "stats_moved", "one_vision_leaf_off": "grad_err_vision",
            "optimizer_skipped": "update_err"}[fault]
    assert failing == {want}
    if fault == "optimizer_skipped":
        assert r["checks"]["update_err"]["value"] > 0.9


def test_calibrated_statistics_standardise_each_input():
    from port_bench.drivers.clip_rn_step import calibrate
    from port_bench.reference import clip_resnet
    from port_bench.weights import make_weights, shapes_of

    meta = clip_resnet.build(device="meta", **TINY_CLIP)
    weights = make_weights(shapes_of(meta), 5, "cpu")
    drawn = {k: v.clone() for k, v in weights.items()}
    images = torch.randn(8, 64, 64, 3).numpy()
    calibrate(weights, images, TINY_CLIP, "cpu")
    ref = clip_resnet.build(weights, "cpu", **TINY_CLIP)
    seen = {}

    def keep(name):
        def hook(bn, args, out):
            x = (args[0] - bn.mean[None, :, None, None]) / (bn.var[None, :, None, None]
                                                            + 1e-5).sqrt()
            seen[name] = (float(x.mean(dim=(0, 2, 3)).abs().max()),
                          float((x.var(dim=(0, 2, 3), unbiased=False) - 1).abs().max()))
        return hook

    for n, m in ref.named_modules():
        if isinstance(m, clip_resnet.BN):
            m.register_forward_hook(keep(n))
    with torch.no_grad():
        ref.encode_image(torch.from_numpy(images))
    assert len(seen) == sum(1 for k in weights if k.endswith(".var"))
    assert max(m for m, _ in seen.values()) < 1e-4 and max(v for _, v in seen.values()) < 1e-3
    moved = {k for k in weights if not torch.equal(weights[k], drawn[k])}
    assert moved == {k for k in weights if k.endswith((".mean", ".var"))}


def test_recomputed_blocks_reader(monkeypatch):
    from egm_unet_torch.utils import profiling

    read = core.reader("longclip.recomputed_blocks_per_step")
    full = {"longclip.steps": {"value": 4}, "longclip.recomputed_blocks": {"value": 352}}
    for tab, want in ((full, 88.0), ({}, None), ({"longclip.steps": {"value": 4}}, None),
                      ({**full, "longclip.steps": {"value": 0}}, None)):
        monkeypatch.setattr(profiling, "table", lambda t=tab: {k: dict(v) for k, v in t.items()})
        assert read(None) == want
    monkeypatch.delattr(profiling, "table")
    assert read(None) is None


def test_flops_of_a_triple_by_hand():
    from port_bench.roofline.clip_rn_flops import clip_rn_triple_flops

    def conv(hw, k, cin, cout):
        return 2 * hw * hw * k * k * cin * cout

    stem = conv(32, 3, 3, 8) + conv(32, 3, 8, 8) + conv(32, 3, 8, 16)
    # per Bottleneck: conv1 and conv2 at the input's size, conv3 and the
    # shortcut's conv after the stride's pool
    blocks = [(16, 16, 16, 16, 1), (16, 64, 32, 8, 1), (8, 128, 32, 8, 0),
              (8, 128, 64, 4, 1), (4, 256, 128, 2, 1)]  # (hw in, in, planes, hw out, ds)
    res = sum(conv(h, 1, cin, p) + conv(h, 3, p, p) + conv(ho, 1, p, 4 * p)
              + ds * conv(ho, 1, cin, 4 * p) for h, cin, p, ho, ds in blocks)
    d, t = 512, 5  # the pool: one query over 2 x 2 + 1 tokens
    pool = 2 * d * d + 2 * 2 * t * d * d + 2 * 2 * t * d + 2 * d * 64
    tt, tw = 24, 64
    text = 2 * (2 * tt * 12 * tw * tw + 4 * tt * tt * tw) + 2 * tw * 64
    assert clip_rn_triple_flops(**TINY_CLIP) == 3 * (stem + res + pool + 2 * text)
    full = json.loads((core.BENCH_DIR / "configs" / "clip_rn50x64.json").read_text())["clip"]
    assert clip_rn_triple_flops(**full) * 48 == pytest.approx(97.357e12, rel=1e-4)


def test_the_cell_is_declared():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    cell = core.load_cell(CELL)
    assert cell.chips == 1 and cell.entry == "clip_rn_step"
    assert [m["name"] for m in cell.end_to_end] == ["batch_img_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "device.idle_share.longclip", "clip_rn_step.mfu", "clip_rn_step.launches_per_step",
        "longclip.recomputed_blocks_per_step", "longclip.loss_ms_per_step",
        "longclip.update_ms_per_step"}
    assert all(m["moves"] == "batch_img_per_s" for m in cell.per_layer)
    cfg = [c for c in bench["configs"] if c["name"] == "clip_rn50x64"][0]
    assert cfg["reduced"] == cell.config["reduced"] == ["contrastive_batch"]
    assert cfg["source"] == cell.config["source"]
    assert set(cell.workload["reasons"]) == set(cell.workload["limits"]) | {"pca_gain"}
    assert set(cell.workload["limits"]) == NUMBERS and cell.workload["limits"]["stats_moved"] == 0
    assert set(cell.workload["controls"]) == {"tf32_program"}


def test_the_configuration_is_the_programs_preset():
    from egm_unet_torch.models.clip.model import RN50X64
    from port_bench.drivers.clip_rn_step import clip_config

    assert clip_config(core.load_cell(CELL).config["clip"]) == RN50X64


@pytest.mark.card
def test_control_fails_where_the_program_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    quiet = lambda *a: None  # noqa: E731
    smaller = {"traffic": {"pool_batches": 2}}
    sound = readings(CELL, [81, 82], 2.0, None, overrides=smaller, log=quiet)
    low = readings(CELL, [81, 82], 2.0, "tf32_program", overrides=smaller, log=quiet)
    assert all(r["correct"] for _, r in sound), [r["checks"] for _, r in sound]
    assert not any(r["correct"] for _, r in low), [r["checks"] for _, r in low]
