"""The program's spans and counters (``utils/profiling.py``) on the CPU: off
they record nothing and enter no ``record_function``; under a profiler or
``recording()`` they fill the table (count, seconds, self seconds, parent)
and land in the profiler's events; ``trace`` writes ``trace.json`` and
``spans.json``; ``fused_masks`` records each stage and counts its images and
uploaded bytes."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from egm_unet_torch.cli import eval_clipseg, predict_clipseg
from egm_unet_torch.data import SyntheticTPDataset
from egm_unet_torch.models import create_model
from egm_unet_torch.models.clip.model import CLIPConfig
from egm_unet_torch.models.clipseg import CLIPDensePredT
from egm_unet_torch.models.registry import init_weights
from egm_unet_torch.utils import profiling

STAGES = ("fusion", "fusion.preprocess", "fusion.clip.pack", "fusion.clip.forward",
          "fusion.unet.pack", "fusion.unet.forward", "fusion.fuse", "fusion.readback")


@pytest.fixture(autouse=True)
def empty_table():
    profiling.reset_table()
    yield
    profiling.reset_table()


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with recording off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("a"):
        with profiling.span("b"):
            profiling.count("c", 3)
    assert profiling.span("a") is profiling.span("b")  # the shared null context
    assert profiling.table() == {}


def test_nested_spans_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    time.sleep(0.02)
                    torch.ones(4).add_(1)
        profiling.count("things", 5)
        profiling.count("things", 2)
    tab = profiling.table()
    assert set(tab) == {"outer", "inner", "things"}
    outer, inner = tab["outer"], tab["inner"]
    assert outer["count"] == inner["count"] == 2
    assert outer["parent"] is None and inner["parent"] == "outer"
    assert inner["seconds"] >= 0.04 and inner["self_seconds"] == pytest.approx(inner["seconds"])
    assert outer["seconds"] >= inner["seconds"]
    assert outer["self_seconds"] == pytest.approx(outer["seconds"] - inner["seconds"])
    assert outer["self_seconds"] < 0.02
    assert tab["things"] == {"value": 7}
    names = [e.name for e in prof.events()]
    assert names.count("outer") == 2 and names.count("inner") == 2
    with profiling.span("after"):  # the profiler has stopped
        pass
    assert "after" not in profiling.table()


def test_recording_block_fills_the_table_without_a_profiler():
    with profiling.recording():
        assert not torch.autograd._profiler_enabled()
        with profiling.span("s"):
            profiling.count("n", 1)
    with profiling.span("s"):
        profiling.count("n", 1)
    tab = profiling.table()
    assert tab["s"]["count"] == 1 and tab["s"]["parent"] is None
    assert tab["n"] == {"value": 1}
    profiling.reset_table()
    assert profiling.table() == {}


def test_threads_lose_no_update():
    """More threads than cores, a short switch interval: every span and
    counter update lands, each thread's spans nest on its own stack."""
    n_threads, reps = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(reps):
                with profiling.span("t.outer"):
                    with profiling.span("t.inner"):
                        profiling.count("t.n", 1)
        with profiling.recording():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    tab = profiling.table()
    assert tab["t.outer"]["count"] == tab["t.inner"]["count"] == n_threads * reps
    assert tab["t.n"]["value"] == n_threads * reps
    assert tab["t.inner"]["parent"] == "t.outer" and tab["t.outer"]["parent"] is None


def test_trace_writes_the_span_table_beside_the_trace(tmp_path):
    profiling.count("stale", 1)  # outside any recording: not counted
    with profiling.recording():
        profiling.count("before", 1)
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        for _ in range(2):
            with profiling.span("step"):
                torch.mm(x, x)
    assert prof is not None
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = [str(e.get("name")) for e in events]
    assert any("aten::mm" in n for n in names) and names.count("step") == 2
    spans = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert spans == profiling.table() and set(spans) == {"step"}
    assert spans["step"]["count"] == 2 and spans["step"]["parent"] is None
    a = profiling.device_synchronized("cpu")
    assert profiling.device_synchronized() >= a


KW = dict(embed_dim=32, image_resolution=64, vision_layers=2, vision_width=64,
          vision_patch_size=16, context_length=32, vocab_size=512,
          transformer_width=64, transformer_heads=2, transformer_layers=2,
          long_clip=True)


@pytest.fixture(scope="module")
def tiny_models():
    unet = create_model("egm_unet", num_classes=2, base_c=8,
                        generator=torch.Generator().manual_seed(0)).eval()
    seg = CLIPDensePredT(clip_cfg=CLIPConfig(**KW), reduce_dim=16, extract_layers=(1,))
    init_weights(seg, torch.Generator().manual_seed(1))
    cond = torch.randn(2, 32, generator=torch.Generator().manual_seed(2))
    return seg.eval(), unet, cond


def test_fused_masks_records_every_stage(tiny_models):
    """3 frames of 60x90 at base size 48 (one 64x128 bucket), clip size 64,
    clip batch 4, UNet batch 2: 6 CLIPSeg rows in 2 chunks, 2 UNet chunks."""
    seg, unet, cond = tiny_models
    ds = SyntheticTPDataset(3, h=60, w=90)
    raws = [ds[i][0] for i in range(3)]
    kw = dict(base_size=48, clip_size=64, clip_batch=4, unet_batch=2, device="cpu")
    plain = eval_clipseg.fused_masks(seg, unet, cond, raws, 0.5, **kw)
    assert profiling.table() == {}
    info = {}
    with profiling.recording():
        masks = eval_clipseg.fused_masks(seg, unet, cond, raws, 0.5, info=info, **kw)
    for a, b in zip(plain, masks):
        np.testing.assert_array_equal(a, b)
    tab = profiling.table()
    assert info["clipseg_forwards"] == 2 and info["unet_forwards"] == 2
    calls = {"fusion": 1, "fusion.preprocess": 1, "fusion.clip.pack": 1,
             "fusion.clip.forward": 1, "fusion.unet.pack": 1 + info["unet_forwards"],
             "fusion.unet.forward": info["unet_forwards"], "fusion.fuse": 1,
             "fusion.readback": len(raws)}
    assert {k: tab[k]["count"] for k in STAGES} == calls
    assert {k: tab[k]["parent"] for k in STAGES} == {
        "fusion": None, **{k: "fusion" for k in STAGES[1:-1]}, "fusion.readback": "fusion.fuse"}
    assert tab["fusion.images"]["value"] == len(raws)
    # as sent: each uint8 CLIP frame once, the uint8 UNet batches
    h2d = 3 * (64 * 64 * 3) + 2 * 2 * (64 * 128 * 3)
    assert tab["fusion.h2d_bytes"]["value"] == h2d
    children = sum(tab[k]["seconds"] for k in STAGES[1:-1])
    assert tab["fusion"]["self_seconds"] == pytest.approx(tab["fusion"]["seconds"] - children)
    assert all(0 <= tab[k]["self_seconds"] <= tab[k]["seconds"] for k in STAGES)


@pytest.mark.parametrize("cli", ["eval", "predict"])
def test_cli_trace_dir(tmp_path, capsys, cli):
    """``--trace-dir``: the fusion's trace and span table written, the stage
    table printed per image (eval: preprocessing and the branch pass, 8
    images; predict: ``fused_masks``, 4 images)."""
    main = {"eval": eval_clipseg.main, "predict": predict_clipseg.main}[cli]
    main(["--synthetic", "--tiny-clip", "--device", "cpu", "--base-c", "8",
          "--clip-size", "64", "--base-size", "48", "--clip-batch", "8", "--unet-batch", "4",
          "--alpha-file", str(tmp_path / "alpha.txt"), "--save-result", str(tmp_path / "out"),
          "--trace-dir", str(tmp_path / "tr")])
    out = capsys.readouterr().out
    spans = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert (tmp_path / "tr" / "trace.json").is_file()
    stages = STAGES if cli == "predict" else STAGES[1:6]
    n = 4 if cli == "predict" else 8
    assert set(spans) == set(stages) | {"fusion.h2d_bytes"} | (
        {"fusion.images"} if cli == "predict" else set())
    assert f"# stage table per image ({n} images)" in out
    assert all(f"\n{k} " in out for k in spans)
